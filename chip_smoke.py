#!/usr/bin/env python3
"""Smoke run of the PyTorch port (sparseeventid_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--parent DIR]

(``--dp-rank DIR`` is the entry of a rank of the dp_two_ranks phase.)

Phases, one JSON line each; any failure exits non-zero:

  1. device   the card's name, count, and nvidia-smi's name and power limit
  2. build    every CUDA kernel of csrc/ built with nvcc (sm_90a), in parallel
  3. kernel   each kernel, forward and backward, against its plain PyTorch
              version on the card, at the main path's shapes from one
              synthetic dune3d batch: bit-equal on integer-valued bf16 data
              (the sidecars, window_dw and the backward, both entries of
              each, on fp32 too; the sidecar at the initial conv and the
              series of levels 0, 2, 4 and 5, and the backward's dX apply
              (gy as the table, W transposed and mirrored) at levels 0 and
              4, and the dW sidecar at the initial conv and level 0, also
              on hand-made lists at the real list width: a row of K
              entries across a chunk edge, a row longer than a task loads
              at once, holes, an empty event, n_bound below the width),
              max abs error on real-valued data (the conv, the
              sidecar and the backward's dx within one bf16 ulp of the
              output scale, the backward's, window_dw's and the sidecar's
              dw within 1e-4 of theirs), the backward, the sidecar,
              window_dw and the dW sidecar the same bits on two runs of
              real-valued data, and times (kernel, plain version, a
              PyTorch yardstick) beside the card's least time;
              window_plan and window_conv_apply also at levels 2 and 4, the
              level-1 downsample (channel widths off the conv's 64-deep
              chunks) and a hand-made dense block where every query
              matches at every offset.  With --parent DIR (an earlier
              commit's sparseeventid_tpu_torch/csrc) all its kernels are
              built and timed on the same inputs (parent_ms); the plan,
              conv, backward, dW sidecar, window_gather and gather_conv
              must give the current kernels' bits, the sidecar and
              window_dw theirs on integer data and the real-valued limits
     norm_kernel  the masked batch norm's four wrappers (bn_stats,
              bn_apply, bn_backward_reduce, bn_backward_apply) against
              their plain versions on real-valued bf16 data at the inputs
              the recipes' norms get (dune3d levels 0 and 5, dune2d level
              0; B = 8 and B = 32): the output within one bf16 ulp of its
              scale, dx, dscale and doffset within 1e-3 of their norms,
              the same bits on two runs, times beside the bytes' bound, the
              plain versions and the library's batch norm over the packed
              live rows; every train phase requires each wrapper's launches
              a step (53 batch norms; 48 more bn_stats and bn_apply under
              remat) and no call of a plain version
  4. grad     conv-level gradients on integer-valued fp32 data: dX and dW
              of the window autograd Functions equal the plain rulebook
              backend's autograd exactly (level-0 series plan and level-0
              downsample plans, the latter also with a reverse window
              narrow enough to fill the reverse list), and two planted
              faults of the backward's overflow complement are caught
  5. host_plans  the host plan builder (csrc/hostio.cpp, g++) on batch 0
              at full width: build ms on 1 and 8 threads and the host's
              core count, the pool's peak concurrency, plan cache miss and
              hit ms, the dict's MB and its copy to the card, every plan's
              largest real-pair count an event against its list width (0
              dropped, every list dst-ordered), the (tile, offset) starts
              that differ from the window_plan kernel's on the same site
              set; every conv of the encoder (initial, series, strided with
              its reverse plan) on host plans against device plans: output,
              dX and dW exactly equal on integer-valued fp32 data
  6. main     full-width dune3d inference (B=8, 50k-voxel cap, depth 5,
              filters 32->192, bf16) through train.evaluate.validate on
              host-built plans: finite loss and softmax, no dropped pairs,
              the launch counts of one forward (no window_plan) and no plain
              version called; a profiled batch.  main_device: the same with
              SEID_HOST_PLANS=0 (plans built on the card, 17 window_plan
              launches a forward)
  7. train    the supervised train step at the same width through
              train.trainer.train on host plans built in the loader's
              thread (bf16, dropout on): one warm-up and three timed steps;
              finite loss, no dropped pairs, a finite gradient on every
              parameter and a non-zero one on every conv weight, running
              statistics moved, the launch counts of every kernel as
              expected; a profiled step; two backward passes of one batch
              from the same weights, whose conv weight gradients must be
              the same bits (train_repeat).  train_device: the steps and
              the profiled step with SEID_HOST_PLANS=0
  8. fp32     one batch at fp32, window kernels on host plans against the
              plain rulebook backend on the card: forward features and
              logits, then every parameter gradient of one train step; each
              check must also catch two planted faults of the overflow
              sidecars
  9. gather   window_gather (the deconv's shape and the level-0 series
              shape) bit-equal to its plain version on real-valued bf16
              and fp32 data (and at C = 12, its per-value route);
              gather_conv over the real rulebooks of levels 0, 2, 4 and 5
              bit-equal on integer-valued bf16 and fp32 data (its dX form,
              mirrored index columns and W transposed, too at level 0, and
              12 -> 20 channels, its element route, at level 5), within one
              bf16 ulp of the output scale on real-valued bf16 data and the
              same bits on two runs; the deconv's two-step dW timed beside
              window_dw at the same shape, and window_dw's own row there
              (bit-equal on integer bf16 and fp32 data)
  10. engine_ops  integer-valued fp32: the window deconv (forward, dX, dW)
              against the plain backend's autograd, PoolingDownsample's
              window branch against its plain branch, the gather conv
              against the plain conv's autograd, all exact, and two planted
              faults caught; then ConvolutionUpsample and the gather conv
              driven forward and backward at full width in bf16 (ops_path)
 11. campaign  the slice's path, a dune3d training campaign at full width
              (B=8, 50k-voxel cap, depth 5, filters 32->192, bf16, 24
              synthetic events from seed 0, prefetching loaders that build
              the host plans, no window_plan launch) through
              sparseeventid_tpu_torch.__main__.main in a temporary
              output_dir: (1) one dune3d batch's events through the native
              assembler (csrc/hostio.cpp, built with g++) and its numpy
              version: coordinates and padding equal, values within 1e-5,
              ms of each and the thread count; (2) mode=train, 4 steps, a
              checkpoint every 2: the index lists steps 2 and 4 (latest
              step_4.pt), a validation batch ran at step 0, finite loss, 0
              dropped, launches = 4 train steps + 1 forward, each step's io
              and step ms (StepTimer); (3) a fresh state restored from step
              4 is torch.equal to the trained one (parameters, statistics,
              AdamW moments, schedule, step), one more step from each on the
              same batch gives the same bits, save and restore ms; (4)
              mode=train to 6 resumes at 4, takes 2 steps, saves step 6; (5)
              mode=inference resumes step 6 and equals validate() given
              step 6's weights bit for bit; (6) an encoder-only transfer
              from step 4: the frozen encoder equals step 4's, every head
              parameter and every encoder running statistic moved, and no
              backward kernel launched; (7) only where the card's Python
              imports h5py: a 24-event dune3d larcv file written by the
              port equals the synthetic split it was written from, and
              mode=inference (.h5 output) and mode=iotest run on it; where
              `import h5py` raises ModuleNotFoundError it prints
              {"phase": "campaign_larcv", "h5py": false} and goes on (any
              other error fails the run)
 12. main2d / train2d  the dune2d multiplane model (3 planes of 1536 x 1024,
              B=8, bf16, depth 5) through the same validate and train entry
              points, with the same checks and launch counts, each also on
              device plans (main2d_device, train2d_device); the kernel and
              host_plans phases also run at the dune2d shapes (K = 25, 9, 4)
 13. the other tasks at full dune3d width (B=8, bf16, depth 5, filters
              32->192) on host plans, each after one warm-up step:
              simclr (two views of aug_max_voxels = 3000 voxels through
              one encoder, capacities 3072/2560/2048/1536/1024/1024 (the
              default shrink of 0.5 drops sites of these views: one
              forward at the default capacities prints how many): 4
              steps through train.trainer.train, finite loss, top-1 <=
              top-5 in [0, 1],
              0 dropped, twice a single-view step's launches of every
              kernel, no window_plan and no plain version; a profiled
              step; simclr_repeat: the views differ, and two backward
              passes of one batch give the same bits in every conv weight
              gradient); simclr view kernels (window_conv_apply, window_dw
              and the backward at the view's level-0 shape, bit-equal to
              their plain versions, timed, in the kernel rows); yolo (4
              steps, finite loss parts and vertex metrics, a profiled
              step, then mode=inference from its checkpoint writes
              val_rank_0.npz with an anchor map on the encoded grid
              (32, 16, 40)); unsupervised (the weak-label window of the
              24 events' energies and its label balance, 4 steps on the
              weak_label head, a profiled step); optimizers (one step
              under each of the eight kinds: finite loss, every head
              parameter moved; each kind's two updates of the model's
              parameters on the card equal the CPU's to rtol 1e-5);
              profile (run.profile=true, 2 steps: the trace names the
              port's kernels); fp32_simclr / fp32_yolo (z1, z2 and the
              anchor map, window kernels on host plans against the plain
              backend, rtol = atol = 1e-3); visualize (two event displays
              where matplotlib imports, else {"matplotlib": false})
 14. data parallelism (parallel/mesh.py) at full dune3d width on host
              plans: dp_world1 (a world-size-1 NCCL group joined from
              torchrun's variables: one step through the distributed path
              (sync batch norm, metric and gradient mean) from the same
              weights on batch 0 gives the one-process step's bits in every
              gradient the optimizer is given and every running statistic;
              then 4 steps through train.trainer.train(run.distributed=
              true), steps/s beside train's, the NCCL kernels' device ms of
              a step); dp_two_ranks (two ranks on the one card, gloo,
              framework.oversubscribe=2, started by torch.distributed.run,
              each rank running this script with --dp-rank DIR and taking 4
              of batch 0's 8 events: the fp32 step's loss within 1e-3 and
              every mean gradient within fp32_grad_compare's limit of one
              process on the 8 events; after 2 bf16 supervised steps and 2
              SimCLR steps (the gathered batch 2 x 4 events a view, top-1 <=
              top-5 in [0, 1]) the ranks' parameters and statistics the same
              bits, 0 dropped; steps/s and the collectives' ms a step, with
              two ranks sharing one card's SMs, no scaling number)
 15. the other models at full width (depth 5, 4 blocks a level, filters
              32->192, bottleneck 128), each through train.trainer.train
              (3 steps: one warm-up, two timed) and then validate() from the
              run's checkpoint, finite losses, 0 dropped, every launch
              count required (train_and_validate): groupnorm (dune3d,
              encoder.normalization=group, host plans; the fp32 window
              kernels against the plain backend, logits rtol = atol = 1e-3
              and one step's gradients within fp32_grad_compare's limit;
              normalization=layer, forward only); remat (dune3d bf16 from
              the same weights on batch 0: one step with framework.remat
              on and one off give the same bits in every conv weight
              gradient and every running statistic, the recomputation's
              48 series convs counted; peak GiB and steps/s over 3 steps
              each); before these, csrc/knn.cu's knn_topk at B=8,
              P=8192, k=20, F=4, 64 and 128 (phase_knn_kernels): the plain
              version's indices bit for bit on integer-valued clouds with
              ties, padding and a cloud of 15 points, the float64
              neighbour distances within KNN_REAL_TOL on real-valued ones,
              ms, bound_ms, plain_ms and library_ms (torch.topk on the
              materialised distances); pointnet and dgcnn
              (encoder=pointnet|dgcnn, 2048 points an event, trained at
              bf16: DGCNN launches knn_topk 4 times a forward, PointNet
              never; the card against the CPU from the same weights
              within rtol = atol = 1e-3, TF32 off, DGCNN's CPU pass on the
              card's neighbour lists, the first stage's own lists equal;
              DGCNN's knn_indices on the card equal the CPU's on integer
              coordinates with ties at the k-th neighbour); per_label
              (dune2d, encoder.per_label_final_series=true: one
              window_plan a forward on host plans, fp32 logits against the
              plain backend); dense (framework.mode=dense, fp32 with TF32
              off: the dune2d grid through PlaneAxisDataset, inference
              B=8, training DENSE_TRAIN_BATCH_2D; 3D at DENSE_GRID_3D; the
              card against the CPU on small inputs, eval mode).  The dense
              and point-cloud phases launch no sparse-conv kernel of
              csrc/, and only DGCNN the neighbour search's
 16. bench    the port's benchmark drivers (scripts/bench.py,
              bench_e2e.py, bench_extra.py) through their main functions,
              in this process, at their full default widths and reduced
              counts (BENCH_ARGS, BENCH_E2E_ARGS, BENCH_EXTRA_ARGS): bench's
              25k and 36k dune3d regimes (3 warm-up steps, blocks of 3, at
              most 2 + 1 blocks), bench_e2e's cold, warm and device-only
              loops on 32 events (1 warm epoch), bench_extra's seven
              configs (2 warm-up steps, 2 blocks of 3); each JSON line
              printed; every line 0 dropped and rates above 0, bench's
              mfu_useful in (0, 1] against the card's own peak, the data
              route "memory" where h5py does not import; host plans: no
              window_plan launch, every other train-step kernel launched,
              no plain version called
 17. accuracy  the kernel phase's checks at the small preset's shapes (one
              batch of its synthetic events on the 64^3 grid, capacities
              6144/3072/1536/768, widths 16 -> 64: the initial 125x1->16,
              the series at 16, 48 and 64 channels, the three downsamples;
              the sidecars, the dW sidecar too, at C = 16 on the plan's
              lists and hand-made lists and at C = 48 and 64 on hand-made
              lists; rows labelled "small ..."), then the
              convergence run (sparseeventid_tpu_torch/scripts/
              accuracy_run.py) through its main in this process at the
              small preset and reduced counts (ACCURACY_ARGS: 100 window
              steps, 50 xla and 50 matched window steps, resume 20 -> 40):
              0 dropped pairs in every run, finite losses, the resume pair,
              the window and xla step-0 losses within 0.01, each window
              run's launches exactly LAUNCHES_PER_SMALL_STEP a step and
              LAUNCHES_PER_SMALL_FORWARD a validation batch, no plain
              version, no port kernel in the xla run
 18. sparse_efficiency  the port's sparse-vs-dense sweep tool
              (sparseeventid_tpu_torch/scripts/sparse_efficiency.py) at its
              full default through sparse_efficiency.sweep: 2-D and 3-D
              grids of 256 a side, kernels 1, 3 and 5, six sparsities of
              uniformly random sites at a capacity of 65536, fp32 at 8 -> 8
              channels, 36 rows (sparse ms, dense ms, speedup, the overflow
              list's width, walked entries and real pairs).  Every row with
              K > 1: 0 dropped, and the window output at the live sites
              within 1e-4 of its scale of the xla rulebook backend and of
              cuDNN's dense conv with the same weights as a dense kernel
              (TF32 off); the run's launches exactly a window_plan a row of
              K > 1 and a window_conv_apply and an overflow_apply_batched a
              timed call and its warm-up.  Then window_plan,
              window_conv_apply and overflow_apply_batched at the densest
              2-D K = 25 and 3-D K = 125 rows bit-equal to their plain
              versions on integer fp32 data (the sidecar on the plan's list
              and on a hand-made list as wide), timed in the kernel rows.
              It runs last: it turns TF32 off for the process
 19. the total wall time, the {"kernels": [...]} line (window_plan's
     launches from main_device; launches_simclr, _yolo, _unsupervised of
     the task runs; launches_dp and launches_dp_two_ranks of the DP runs;
     launches_groupnorm, _remat, _pointnet, _dgcnn, _per_label and _dense
     of the model runs; launches_sparse_efficiency of the sweep;
     launches_bench of the drivers; launches_accuracy of the long window
     run of the accuracy phase; knn_topk's row last, its launches those of
     the dgcnn train run), then {"ok": true, "device": {...}} last.

It needs the repository around it and a CUDA device: without either it
prints no result and exits with 2.  Kernels build into build/torch_kernels/,
the host IO engine into build/host/; the runs write under a temporary
directory that is removed at the end.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
GRID = (1024, 512, 1280)
BATCH = 8
MAX_VOXELS = 50000
N_BATCHES = 3
SEED = 0
# dune2d: plane axis first; events are 3D tracks on (H, H, W) projected per
# plane, at the occupancy of the JAX package's dune2d bench file
GRID_2D = (3, 1536, 1024)
MAX_VOXELS_2D = 20000  # a plane
DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor FLOP/s
# and float32 FLOP/s outside the tensor cores (the fp32 kernels' route)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12

REPLACES = {
    "window_plan": "sparseeventid_tpu/ops/pallas/window_conv.py:607",
    "window_conv_apply": "sparseeventid_tpu/ops/pallas/window_conv.py:993",
    "overflow_apply_batched": "sparseeventid_tpu/ops/pallas/window_sidecar.py:266",
    "overflow_apply": "sparseeventid_tpu/ops/pallas/window_conv.py:1783",
    "window_bwd_strided": "sparseeventid_tpu/ops/pallas/window_conv.py:1506",
    "window_dw": "sparseeventid_tpu/ops/pallas/window_conv.py:1264",
    "overflow_dw_batched": "sparseeventid_tpu/ops/pallas/window_sidecar.py:377",
    "overflow_dw": "sparseeventid_tpu/ops/pallas/window_conv.py:1881",
    "window_gather": "sparseeventid_tpu/ops/pallas/window_conv.py:1608",
    "gather_conv": "sparseeventid_tpu/ops/pallas/gather_conv.py:62",
}
SOURCES = {
    "window_plan": "sparseeventid_tpu_torch/csrc/window_plan.cu",
    "window_conv_apply": "sparseeventid_tpu_torch/csrc/window_conv.cu",
    "overflow_apply_batched": "sparseeventid_tpu_torch/csrc/overflow_apply.cu",
    "overflow_apply": "sparseeventid_tpu_torch/csrc/overflow_apply.cu",
    "window_bwd_strided": "sparseeventid_tpu_torch/csrc/window_bwd.cu",
    "window_dw": "sparseeventid_tpu_torch/csrc/window_dw.cu",
    "overflow_dw_batched": "sparseeventid_tpu_torch/csrc/overflow_dw.cu",
    "overflow_dw": "sparseeventid_tpu_torch/csrc/overflow_dw.cu",
    "window_gather": "sparseeventid_tpu_torch/csrc/window_gather.cu",
    "gather_conv": "sparseeventid_tpu_torch/csrc/gather_conv.cu",
}
# kernels no model of the package selects: their path is the ops_path drive
OPS_KERNELS = ("window_gather", "gather_conv")
# kernels the inference path launches (it must launch no other); the rest
# only the train step does
FORWARD_KERNELS = ("window_plan", "window_conv_apply", "overflow_apply_batched",
                   "overflow_apply")
# launches per train step without framework.remat, dune3d and dune2d alike:
# 17 plans (1 initial + 6 series + 5 x 2 strided), 54 convs (1 + 48 + 5),
# each with a forward sidecar; the backward runs the fused kernel for the 53
# convs with C > 1 and window_dw for the initial one, a dX sidecar for the
# 53 (the image needs no gradient) and a dW sidecar for all 54
# The batch norms of a forward, dune3d and dune2d alike: 6 series x 4 blocks
# x 2 and the 5 downsamples (the initial conv has none).  A train step runs
# each as one bn_stats and one bn_apply forward and one bn_backward_reduce
# and one bn_backward_apply backward; inference as one bn_apply.
BATCH_NORMS = 53
NORM_WRAPPERS = ("bn_stats", "bn_apply", "bn_backward_reduce",
                 "bn_backward_apply")


def norm_launches(forward: int, backward: int, stats=None) -> dict:
    """The norm wrappers' launches of ``forward`` norms in training
    (``stats`` of them with the batch's statistics; all by default) and
    ``backward`` norms' backward passes."""
    return {"bn_stats": forward if stats is None else stats,
            "bn_apply": forward, "bn_backward_reduce": backward,
            "bn_backward_apply": backward}


LAUNCHES_PER_TRAIN_STEP_NO_REMAT = {
    "window_plan": 17, "window_conv_apply": 54, "overflow_apply_batched": 106,
    "overflow_apply": 1, "window_bwd_strided": 53, "window_dw": 1,
    "overflow_dw_batched": 53, "overflow_dw": 1,
    **norm_launches(BATCH_NORMS, BATCH_NORMS),
}
# with framework.remat (the default) the backward recomputes each block
# series' forward: its 48 convs (6 series x 4 blocks x 2) run again, each
# with its forward sidecar and its norm (the batch's statistics again, the
# running averages left alone); the plans are built outside the series, once
REMAT_SERIES_CONVS = 48
LAUNCHES_PER_TRAIN_STEP = {
    **LAUNCHES_PER_TRAIN_STEP_NO_REMAT,
    "window_conv_apply": 54 + REMAT_SERIES_CONVS,
    "overflow_apply_batched": 106 + REMAT_SERIES_CONVS,
    **norm_launches(BATCH_NORMS + REMAT_SERIES_CONVS, BATCH_NORMS),
}
# launches of the ops_path drive.  ConvolutionUpsample (64 -> 32 channels)
# forward and backward: the forward and the reverse plan; the forward conv
# over the reverse plan and dX over the forward plan, each with its sidecar;
# dW by window_gather and the batched dW sidecar; the block's batch norm
# forward and backward.  gather_submanifold_conv: the forward and dX are the
# same kernel.  Nothing else launches.
OPS_PATH_LAUNCHES = {
    "window_plan": 2, "window_conv_apply": 2, "overflow_apply_batched": 2,
    "overflow_apply": 0, "window_bwd_strided": 0, "window_dw": 0,
    "overflow_dw_batched": 1, "overflow_dw": 0, **norm_launches(1, 1),
    "window_gather": 1, "gather_conv": 2,
}
# launches of one inference forward (and of a train step's forward half)
LAUNCHES_PER_FORWARD = {
    "window_plan": 17, "window_conv_apply": 54, "overflow_apply_batched": 53,
    "overflow_apply": 1, "window_bwd_strided": 0, "window_dw": 0,
    "overflow_dw_batched": 0, "overflow_dw": 0,
    **norm_launches(BATCH_NORMS, 0, stats=0),  # eval: the running statistics
}
BACKWARD_KERNELS = ("window_bwd_strided", "window_dw", "overflow_dw_batched",
                    "overflow_dw", "bn_backward_reduce", "bn_backward_apply")
# on host-built plans (the main path) no plan kernel runs: the lists and
# starts come from the loader's thread; every other count is the same
HOST_PLANS_ENV = "SEID_HOST_PLANS"
LAUNCHES_PER_FORWARD_HOST = {**LAUNCHES_PER_FORWARD, "window_plan": 0}
LAUNCHES_PER_TRAIN_STEP_HOST = {**LAUNCHES_PER_TRAIN_STEP, "window_plan": 0}
TRAIN_STEPS = 4  # one warm-up, three timed
CAMPAIGN_EVENTS = 24
RUN_DIR = Path("output")  # the runs' output_dir: main() sets a fresh one
CAMPAIGN_OVERRIDES = []  # more overrides of the campaign's runs (rehearsals)
FP32_GRAD_EVENTS = 2  # the plain backend's fp32 backward keeps ~7 GB an event
STEPS_PER_S = {}  # steps/s of each train phase, by phase name


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Failure(Exception):
    pass


def require(cond, what: str) -> None:
    if not cond:
        raise Failure(what)


def timed_ms(fn, iters: int = 10, warmup: int = 2, graph: bool = True) -> float:
    """Mean device time of one call.  ``graph``: ``iters`` calls captured in
    one CUDA graph, replayed between two CUDA events, so the host's cost of
    a launch (the Python wrapper, ctypes) is left out and a call of a few
    microseconds is timed as the device runs it.  Otherwise (the plain
    versions, which synchronise): CUDA events around ``iters`` calls."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = None
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    if graph:
        g.replay()
    else:
        for _ in range(iters):
            fn()
    t1.record()
    torch.cuda.synchronize()
    del g
    return t0.elapsed_time(t1) / iters


def bound(nbytes: float, flops: float, dtype=None):
    """The card's least time for the bytes and the operations: fp32 at the
    CUDA cores' peak (the fp32 kernels' route), else bf16 at the tensor
    cores'."""
    import torch

    rate = FP32_FLOPS_PER_S if dtype == torch.float32 else BF16_FLOPS_PER_S
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / rate * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class CachedDataset:
    """Pre-generated padded batches (keyed by their first index) with the
    dataset interface validate() reads, so event generation stays out of
    the timed run."""

    def __init__(self, grid, batches: dict, n_events: int):
        self._grid = tuple(grid)
        self._batches = batches
        self.n = n_events

    def __len__(self):
        return self.n

    def batch_grid(self):
        return self._grid

    def batch(self, indices):
        return self._batches[indices[0]]

    @property
    def energy(self):
        """Every event's deposited energy, in index order (the weak-label
        window of unsupervised_eventID is fitted to them)."""
        import numpy as np

        return np.concatenate([self._batches[k]["energy"]
                               for k in sorted(self._batches)])


def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    emit({"phase": "device", "kind": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi_line, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return name, smi_line


def phase_build():
    from sparseeventid_tpu_torch.ops.window import _native

    t0 = time.perf_counter()
    reports = _native.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln]
        for name, log in reports.items()
    }
    for name in _native.SOURCES:
        _native.lib(name)  # load: raises if a library is missing
    emit({"phase": "build", "seconds": seconds, "built": sorted(reports),
          "ptxas": ptxas})


def make_dataset(n_batches=N_BATCHES):
    from sparseeventid_tpu_torch.io import SyntheticDataset, SyntheticEventConfig

    n = BATCH * n_batches
    ds = SyntheticDataset(
        n,
        SyntheticEventConfig(image_size=GRID, max_voxels=MAX_VOXELS,
                             mean_tracks=75.0, steps_per_track=900),
        seed=SEED,
    )
    batches = {i: ds.batch(list(range(i, i + BATCH))) for i in range(0, n, BATCH)}
    return CachedDataset(GRID, batches, n)


def make_dataset_2d():
    from sparseeventid_tpu_torch.io import SyntheticDataset, SyntheticEventConfig

    n = BATCH * N_BATCHES
    h, w = GRID_2D[1:]
    ds = SyntheticDataset(
        n,
        SyntheticEventConfig(image_size=(h, h, w), n_planes=GRID_2D[0],
                             max_voxels=MAX_VOXELS_2D, mean_tracks=40.0,
                             steps_per_track=900),
        seed=SEED,
    )
    batches = {i: ds.batch(list(range(i, i + BATCH))) for i in range(0, n, BATCH)}
    return CachedDataset(GRID_2D, batches, n)


# the recipes' filters by level, and the series levels the kernel phase
# holds with the sidecars it checks there
WIDTHS_RECIPE = (32, 64, 96, 128, 160, 192)
SERIES_LEVELS_RECIPE = ((0, ("apply", "dx", "dw")), (2, ("apply",)),
                        (4, ("apply", "dx")), (5, ("apply",)))

# the two geometries of the kernel phase
# (prefix: put before the labels of the rows)
GEOMETRY_3D = dict(grid=GRID, rows=MAX_VOXELS, stride=(2, 2, 2),
                   to_sparse="larcv_batch_to_sparse_3d", prefix="",
                   initial=(5, 5, 5), series=(3, 3, 3))
GEOMETRY_2D = dict(grid=GRID_2D, rows=MAX_VOXELS_2D * GRID_2D[0],
                   stride=(1, 2, 2), to_sparse="larcv_batch_to_sparse_2d",
                   prefix="2d ", initial=(1, 5, 5), series=(1, 3, 3))


def _kname(ksz) -> str:
    if len(set(ksz)) == 1:
        return f"{ksz[0]}^{len(ksz)}"
    return "x".join(str(k) for k in ksz)


def _int_like(shape, gen, device, dtype, lo=-2, hi=3):
    import torch

    return torch.randint(lo, hi, shape, generator=gen, device=device).to(dtype)


def _handmade_lists(n_q, n_t, k, width, seed, edge=None):
    """Overflow lists the engine rarely builds, at a real list's width, for
    the sidecar kernel's row-aligned chunks (csrc/overflow_apply.cu: a task
    owns the rows that start in its chunk of kernels._OV_SPAN entries of
    one event's list) -> (src, dst, kk, valid, n_bound) on the card.  Per event, rows ascend with 1..K entries each (distinct
    offsets) and 10% of the prefix are invalid holes (dst kept in order);
    in event 0 a row of all K offsets starts at entry max(0, edge - K // 2),
    across the chunk edge ``edge`` (default the first chunk's end); in
    event 1 one row of 300 entries (offsets repeated, holes included) is
    longer than a task loads at once; every third event is empty (n_bound
    0); past each prefix lie garbage entries, half of them flagged valid,
    with indices out of every range, and n_bound (< width) stops before
    them.  n_q, n_t: live output and table rows per event."""
    import numpy as np
    import torch

    from sparseeventid_tpu_torch.ops.window import kernels as K

    edge = K._OV_SPAN if edge is None else edge
    rng = np.random.default_rng(seed)
    b = len(n_q)
    src = rng.integers(-9, 2**20, (b, width))
    dst = rng.integers(-9, 2**20, (b, width))
    kk = rng.integers(-3, 4 * k, (b, width))
    valid = rng.random((b, width)) < 0.5
    n_bound = np.zeros(b, np.int64)
    for e in range(b):
        if e % 3 == 2:
            continue
        rows = np.sort(rng.choice(n_q[e], min(n_q[e], width // k), replace=False))
        if rows.size == 0:
            continue
        runs = rng.integers(1, k + 1, rows.size)
        if e == 0:
            lead = min(max(0, edge - k // 2), rows.size - 1)
            runs[:lead], runs[lead] = 1, k  # single-entry rows up to the K-row
        offs = [rng.permutation(k)[:r] for r in runs]
        if e == 1 and rows.size > 2 and width >= 300 + rows.size:
            runs[1] = 300
            offs[1] = rng.integers(0, k, 300)
        p = min(int(runs.sum()), width - 1)
        dst[e, :p] = np.repeat(rows, runs)[:p]
        kk[e, :p] = np.concatenate(offs)[:p]
        src[e, :p] = rng.integers(0, n_t[e], p)
        valid[e, :p] = rng.random(p) >= 0.1
        n_bound[e] = p
    dev = torch.device(DEVICE)
    return tuple(torch.as_tensor(a, device=dev).to(t).contiguous() for a, t in (
        (src, torch.int32), (dst, torch.int32), (kk, torch.int32),
        (valid, torch.bool), (n_bound, torch.int32)))


class ParentKernels:
    """The kernels of an earlier commit, built from its csrc/ (``--parent
    DIR``, DIR holding that commit's sparseeventid_tpu_torch/csrc) and run
    through the current wrappers, to time the earlier design beside the
    current one on the same inputs in the same run.  The earlier C entries
    take the current arguments, or, for the sidecar and window_dw, those of
    their design before the slab, grid and offset groups (read from the
    earlier source; ``overflow_apply`` and ``window_dw`` below call either).
    Each call's result is checked against the current kernel's."""

    SOURCES = ("window_plan", "window_conv", "overflow_apply", "window_bwd",
               "window_dw", "overflow_dw", "window_gather", "gather_conv")

    def __init__(self, tree):
        import ctypes

        from sparseeventid_tpu_torch.ops.window import _native

        csrc = Path(tree).resolve() / "sparseeventid_tpu_torch" / "csrc"
        out = HERE / "build" / "parent_kernels"
        out.mkdir(parents=True, exist_ok=True)
        procs = {name: subprocess.Popen(
            [_native._nvcc(), *_native.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
             str(csrc / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name in self.SOURCES}
        for name, proc in procs.items():
            log, _ = proc.communicate()
            require(proc.returncode == 0, f"parent {name} does not build:\n{log}")
        self.libs = {name: ctypes.CDLL(str(out / f"{name}.so"))
                     for name in self.SOURCES}
        for dll in self.libs.values():
            for fn, argtypes in _native.SIGNATURES.items():
                if hasattr(dll, fn):
                    getattr(dll, fn).argtypes = argtypes
                    getattr(dll, fn).restype = ctypes.c_int
        # a sidecar without slab and grid, a window_dw without offset
        # groups (it adds onto a zeroed dw)
        self.older = {
            "overflow_apply": "int slab" not in (csrc / "overflow_apply.cu").read_text(),
            "window_dw": "int groups" not in (csrc / "window_dw.cu").read_text(),
        }
        for kname, drop in (("overflow_apply", slice(-3, -1)),
                            ("window_dw", slice(-2, -1))):
            if not self.older[kname]:
                continue
            for dt in ("f32", "bf16"):
                sig = list(_native.SIGNATURES[f"seid_{kname}_{dt}"])
                del sig[drop]
                getattr(self.libs[kname], f"seid_{kname}_{dt}").argtypes = sig

    def run(self, fn, *args, **kwargs):
        """``fn`` (a wrapper of the current package, or a function that
        calls one) with the earlier kernels in place of the current ones."""
        from sparseeventid_tpu_torch.ops.window import _native

        with _native._lock:
            saved = {name: _native._libs.get(name) for name in self.libs}
            _native._libs.update(self.libs)
        try:
            return fn(*args, **kwargs)
        finally:
            with _native._lock:
                for name, dll in saved.items():
                    if dll is None:
                        _native._libs.pop(name, None)
                    else:
                        _native._libs[name] = dll

    @staticmethod
    def _suffix(t) -> str:
        import torch

        return "bf16" if t.dtype == torch.bfloat16 else "f32"

    def overflow_apply(self, base, table, w, src, dst, kk, valid, n_bound):
        """The earlier sidecar kernel, in place on ``base``."""
        import torch

        from sparseeventid_tpu_torch.ops.window import kernels as K

        if not self.older["overflow_apply"]:
            return self.run(K.launch_overflow_kernel, base, table, w, src, dst,
                            kk, valid, n_bound)
        b, m, co = base.shape
        k, c, _ = w.shape
        fn = getattr(self.libs["overflow_apply"],
                     f"seid_overflow_apply_{self._suffix(table)}")
        err = fn(base.data_ptr(), m, co, table.data_ptr(), table.shape[1], c,
                 w.data_ptr(), k, src.data_ptr(), dst.data_ptr(),
                 kk.data_ptr(), valid.data_ptr(), n_bound.data_ptr(),
                 src.shape[1], b, torch.cuda.current_stream().cuda_stream)
        require(err == 0, f"parent overflow_apply: CUDA error {err}")
        return base

    def window_dw(self, keys, feats, qmeta, start, gy, q_active, dkeys, *,
                  window_r):
        """The earlier window_dw kernel (one without offset groups with its
        own count of parts: four blocks an SM over its pieces, no more than
        tiles)."""
        import torch

        from sparseeventid_tpu_torch.ops.window import kernels as K

        if not self.older["window_dw"]:
            return self.run(K.window_dw, keys, feats, qmeta, start, gy,
                            q_active, dkeys, window_r=window_r)
        b, nw1, m = qmeta.shape
        n_in, c = feats.shape[1], feats.shape[2]
        co = gy.shape[2]
        k, dk, cols = K._offset_args(dkeys, None)
        sms = torch.cuda.get_device_properties(feats.device).multi_processor_count
        pieces = 1 if c == 1 and co <= 32 else k * -(-c // 32) * -(-co // 32)
        n_parts = max(1, min(b * -(-m // K.TILE_T), -(-4 * sms // pieces)))
        dw = torch.zeros((k, c, co), dtype=torch.float32, device=feats.device)
        part = torch.empty((n_parts, k * c * co), dtype=torch.float32,
                           device=feats.device)
        fn = getattr(self.libs["window_dw"],
                     f"seid_window_dw_{self._suffix(feats)}")
        err = fn(keys.data_ptr(), n_in, feats.data_ptr(), c, qmeta.data_ptr(),
                 nw1 - 1, m, start.data_ptr(), start.shape[1], k, gy.data_ptr(),
                 co, q_active.data_ptr(), m, int(window_r), dw.data_ptr(), dk,
                 cols, b, part.data_ptr(), n_parts,
                 torch.cuda.current_stream().cuda_stream)
        require(err == 0, f"parent window_dw: CUDA error {err}")
        return dw


PARENT: ParentKernels | None = None  # set by --parent


def _plan_row(label, args, r, table_cap, n_tab, n_q, keys, qkeys):
    """window_plan bit-equal to its plain version, timed beside the plain
    version, torch.searchsorted and (with --parent) the earlier design ->
    (row, start, uncov)."""
    import torch

    from sparseeventid_tpu_torch.ops.window import kernels as K

    start, uncov = K.window_plan(*args, window_r=r, table_cap=table_cap)
    start_p, uncov_p = K.window_plan_plain(*args, window_r=r,
                                           table_cap=table_cap)
    torch.cuda.synchronize()
    require(torch.equal(start, start_p) and torch.equal(uncov, uncov_p),
            f"window_plan differs from its plain version at {label}")
    ms = timed_ms(lambda: K.window_plan(*args, window_r=r, table_cap=table_cap))
    plain_ms = timed_ms(lambda: K.window_plan_plain(
        *args, window_r=r, table_cap=table_cap), iters=3, warmup=1, graph=False)
    qf = qkeys.reshape(qkeys.shape[0], -1)
    lib_ms = timed_ms(lambda: torch.searchsorted(keys, qf))
    parent_ms = None
    if PARENT is not None:
        got = PARENT.run(K.window_plan, *args, window_r=r, table_cap=table_cap)
        require(torch.equal(got[0], start) and torch.equal(got[1], uncov),
                f"the earlier window_plan differs at {label}")
        parent_ms = timed_ms(lambda: PARENT.run(
            K.window_plan, *args, window_r=r, table_cap=table_cap))
    # reads: the active keys, the live queries' keys; writes: start and
    # uncovered in full (the function defines every entry)
    b_ms, b_by = bound(
        4 * n_tab + 4 * qkeys.shape[2] * n_q + nbytes(args[2], start, uncov), 0)
    row = dict(shape=label, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
               parent_ms=parent_ms, uncovered=int(uncov.ne(0).sum()))
    return row, start, uncov


def _bf16_ulp(scale: float) -> float:
    """One bf16 ulp at magnitude ``scale`` (8 significant bits)."""
    import math

    return 2.0 ** (math.floor(math.log2(scale)) - 7) if scale > 0 else 0.0


def _conv_row(label, keys, plan, start, q_active, n_tab, n_q, live_tiles,
              idx, hit, pairs_in, x_int, w_int, x_real, w_real):
    """window_conv_apply bit-equal to its plain version on integer bf16
    data and within one bf16 ulp of the output scale on real-valued data,
    timed beside the plain version, the gather + matmul yardstick over the
    rulebook's neighbours ``idx`` / ``hit`` and (with --parent) the earlier
    design -> (row, integer output)."""
    import torch

    from sparseeventid_tpu_torch.ops.window import kernels as K

    r = plan.window_r
    cargs = (keys, x_int, plan.qmeta, start, w_int, q_active, plan.dkeys)
    out = K.window_conv_apply(*cargs, window_r=r)
    out_p = K.window_conv_apply_plain(*cargs, window_r=r)
    torch.cuda.synchronize()
    require(torch.equal(out, out_p),
            f"window_conv_apply differs from its plain version at {label}")
    require(float(out.abs().sum()) > 0, f"window_conv_apply is all 0 at {label}")
    rargs = (keys, x_real, plan.qmeta, start, w_real, q_active, plan.dkeys)
    want = K.window_conv_apply_plain(*rargs, window_r=r).float()
    err = (K.window_conv_apply(*rargs, window_r=r).float() - want
           ).abs().max().item()
    scale = want.abs().max().item()
    require(err <= _bf16_ulp(scale),
            f"window_conv_apply differs by {err} at {label}, more than one "
            f"bf16 ulp of the output scale {scale}")
    ms = timed_ms(lambda: K.window_conv_apply(*rargs, window_r=r))
    plain_ms = timed_ms(lambda: K.window_conv_apply_plain(*rargs, window_r=r),
                        iters=3, warmup=1, graph=False)
    b, m = x_real.shape[0], plan.qmeta.shape[2]
    k, c, co = w_real.shape
    w2 = w_real.reshape(k * c, co)

    def library():
        g = torch.gather(x_real, 1, idx[..., None].expand(-1, -1, c))
        return torch.matmul((g * hit).reshape(b, m, k * c), w2)

    lib_ms = timed_ms(library)
    parent_ms = None
    if PARENT is not None:
        # the same design: the same bits on integer and real-valued data
        got = K.window_conv_apply(*rargs, window_r=r)
        require(torch.equal(PARENT.run(K.window_conv_apply, *cargs, window_r=r),
                            out)
                and torch.equal(PARENT.run(K.window_conv_apply, *rargs,
                                           window_r=r), got),
                f"the earlier window_conv_apply differs at {label}")
        parent_ms = timed_ms(lambda: PARENT.run(K.window_conv_apply, *rargs,
                                                window_r=r))
    # reads: keys and features of the active table rows, the live
    # queries' meta, the live tiles' starts, W; writes: the output in
    # full (rows past the live ones are defined as 0)
    b_ms, b_by = bound(
        (4 + x_real.element_size() * c) * n_tab
        + 4 * plan.qmeta.shape[1] * n_q
        + 4 * k * live_tiles + nbytes(q_active, w_real, out),
        2.0 * pairs_in * c * co, x_real.dtype,
    )
    row = dict(shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
               parent_ms=parent_ms, pairs_in_window=pairs_in, out_scale=scale)
    return row, out


def _sidecar_row(label, entry, base, x, w, lst, q_cap, t_cap) -> dict:
    """An overflow sidecar entry (``kernels.overflow_apply`` or
    ``sidecar.overflow_apply_batched``) on one list (src, dst, kk, valid,
    n_bound) at real-valued features: within one bf16 ulp of the output
    scale of its plain version (fp32: 1e-5 of the scale), the same bits on
    two runs, its time beside the plain version's, the bmm + index_add_
    yardstick over the walked valid entries, the card's least time and,
    with --parent, the earlier kernel's time (within the same limit).
    ``q_cap`` / ``t_cap``: the output's and the table's capacity."""
    import torch

    from sparseeventid_tpu_torch.ops.window import kernels as K

    src, dst, kk, valid, nb = lst
    c, co = w.shape[1:]
    ok = valid & (torch.arange(src.shape[1], device=src.device)[None, :]
                  < nb[:, None])
    bi, si = torch.nonzero(ok, as_tuple=True)
    n_ov = int(bi.numel())
    got, again = entry(base.clone(), x, w, *lst), entry(base.clone(), x, w, *lst)
    want = K.overflow_apply_plain(base.clone(), x, w, *lst).float()
    torch.cuda.synchronize()
    require(torch.equal(got, again),
            f"the sidecar is not the same bits on two runs at {label}")
    err = (got.float() - want).abs().max().item()
    scale = want.abs().max().item()
    tol = _bf16_ulp(scale) if x.dtype == torch.bfloat16 else 1e-5 * scale
    require(err <= tol, f"the sidecar differs by {err} at {label}, more than "
            f"{tol} (output scale {scale})")
    scratch = base.clone()
    ms = timed_ms(lambda: entry(scratch, x, w, *lst))
    plain_ms = timed_ms(lambda: K.overflow_apply_plain(scratch, x, w, *lst),
                        iters=3, warmup=1, graph=False)
    parent_ms = None
    if PARENT is not None:
        e_p = (PARENT.overflow_apply(base.clone(), x, w, *lst).float()
               - want).abs().max().item()
        require(e_p <= tol, f"the earlier sidecar differs by {e_p} at {label}")
        parent_ms = timed_ms(lambda: PARENT.overflow_apply(scratch, x, w, *lst))
    target = bi * q_cap + dst[bi, si].long()
    source = bi * t_cap + src[bi, si].long()
    rows = x[bi, src[bi, si].long()]
    wk = w[kk[bi, si].long()]
    flat = scratch.view(-1, co)

    def library():
        flat.index_add_(0, target, torch.bmm(rows[:, None, :], wk)[:, 0])

    lib_ms = timed_ms(library)
    # reads: the valid flags of the walked prefix, (src, dst, k) of the
    # valid entries, each distinct source row once, W; each distinct output
    # row is read and written once (in place)
    esize = x.element_size()
    b_ms, b_by = bound(
        int(nb.sum()) + 12 * n_ov + nbytes(nb, w)
        + esize * c * int(torch.unique(source).numel())
        + 2 * esize * co * int(torch.unique(target).numel()),
        2.0 * n_ov * c * co, x.dtype)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    tc = K._ov_tensor_cores(x.dtype, c, co)
    slab, grid = K._ov_geometry(sms, src.shape[0], src.shape[1], c, co, tc)
    return dict(shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                parent_ms=parent_ms, entries=n_ov, walked=int(nb.sum()),
                list_width=src.shape[1], out_scale=scale,
                route="tensor cores" if tc else "CUDA cores", slab=slab,
                blocks=grid, repeats_bit_for_bit=True)


def _sidecar_checks(label, entry, lists, ints, reals, q_cap, t_cap) -> dict:
    """An overflow sidecar entry bit-equal to its plain version on
    integer-valued data in bf16 and fp32 on every list of ``lists`` ({what:
    (src, dst, kk, valid, n_bound)}; with --parent the earlier kernel too),
    then timed on real-valued data on the first list (``_sidecar_row``).
    ``ints`` / ``reals``: (base, table, w)."""
    import torch

    from sparseeventid_tpu_torch.ops.window import kernels as K

    for what, lst in lists.items():
        src, _, _, valid, nb = lst
        walked = torch.arange(src.shape[1], device=src.device)[None, :] < nb[:, None]
        n_valid = int((valid & walked).sum())
        for dt in (torch.bfloat16, torch.float32):
            base, x, w = (a.to(dt) for a in ints)
            got = entry(base.clone(), x, w, *lst)
            want = K.overflow_apply_plain(base.clone(), x, w, *lst)
            torch.cuda.synchronize()
            require(torch.equal(got, want),
                    f"the sidecar differs from its plain version on {what}, "
                    f"{dt}, at {label}")
            require(n_valid == 0 or not torch.equal(got, base),
                    f"the sidecar changed nothing on {what} at {label}")
            if PARENT is not None:
                require(torch.equal(PARENT.overflow_apply(base.clone(), x, w,
                                                          *lst), want),
                        f"the earlier sidecar differs on {what}, {dt}, at "
                        f"{label}")
    what, lst = next(iter(lists.items()))
    suffix = "" if what == "the plan's list" else f", {what}"
    return _sidecar_row(label + suffix, entry, *reals, lst, q_cap, t_cap)


def _dw_checks(label, int_args, real_args, window_r):
    """window_dw beyond its bit-equality on integer data: on real-valued
    data the same bits on two runs and within 1e-4 of the scale of its
    plain version; with --parent the earlier kernel bit-equal on the
    integer data (bf16 and fp32) and within 1e-4 of the scale on the
    real-valued data -> (max abs error, parent ms or None).  ``*_args``:
    (keys, feats, qmeta, start, gy, q_active, dkeys)."""
    import torch

    from sparseeventid_tpu_torch.ops.window import kernels as K

    got = K.window_dw(*real_args, window_r=window_r)
    again = K.window_dw(*real_args, window_r=window_r)
    want = K.window_dw_plain(*real_args, window_r=window_r)
    torch.cuda.synchronize()
    require(torch.equal(got, again),
            f"window_dw is not the same bits on two runs at {label}")
    err = (got - want).abs().max().item()
    tol = 1e-4 * want.abs().max().item()
    require(err <= tol, f"window_dw differs by {err} at {label}, limit {tol}")
    if PARENT is None:
        return err, None
    for dt in (torch.bfloat16, torch.float32):
        args = [a.to(dt) if a.is_floating_point() else a for a in int_args[:6]]
        require(torch.equal(PARENT.window_dw(*args, int_args[6],
                                             window_r=window_r),
                            K.window_dw(*args, int_args[6], window_r=window_r)),
                f"the earlier window_dw differs on integer data, {dt}, at "
                f"{label}")
    e_p = (PARENT.window_dw(*real_args, window_r=window_r) - want
           ).abs().max().item()
    require(e_p <= tol, f"the earlier window_dw differs by {e_p} at {label}")
    return err, timed_ms(lambda: PARENT.window_dw(*real_args,
                                                  window_r=window_r))


def phase_dense_tile():
    """window_plan and window_conv_apply on a hand-made dense block: two
    events of a full 34^3 cube of sites, queried at its 32^3 interior with
    a 3^3 kernel at 192 -> 192 channels (and, bit-equal only, 12 -> 20), so
    every query of every tile matches at all 27 offsets, each inside its
    plan window (128 consecutive interior queries span 133 table rows) ->
    (plan row, conv row)."""
    import numpy as np
    import torch

    from sparseeventid_tpu_torch.ops import build_sparse_tensor
    from sparseeventid_tpu_torch.ops import rulebook as rb
    from sparseeventid_tpu_torch.ops.window import kernels as K
    from sparseeventid_tpu_torch.ops.window import query as Q
    from sparseeventid_tpu_torch.ops.window.engine import WindowPlan

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    side, b, c, r = 34, 2, 192, Q.WindowTuning().for_level(5)
    grid = (side,) * 3
    cube = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1)
    inner = cube[1:-1, 1:-1, 1:-1].reshape(-1, 3)
    cube = cube.reshape(-1, 3)

    def sites(coords):
        xyz = torch.as_tensor(np.broadcast_to(coords, (b, *coords.shape)).copy(),
                              device=dev)
        return build_sparse_tensor(xyz, torch.zeros((*xyz.shape[:2], 1),
                                                    device=dev), grid)

    tab, qst = sites(cube), sites(inner)
    offs = rb.kernel_offsets((3, 3, 3), centered=True)
    k = len(offs)
    keys = tab.keys()
    qkeys = Q.compute_query_keys(qst, offs)
    n_tab, n_q = int(tab.n_active.sum()), int(qst.n_active.sum())
    label = f"dense 34^3 cube, 32^3 queries 3^3 {c}->{c}"
    args = (Q._padded_table(keys), qkeys, qst.n_active)
    plan_row, start, uncov = _plan_row(label, args, r, tab.capacity, n_tab,
                                       n_q, keys, qkeys)
    require(int(uncov.sum()) == 0, f"a pair of the dense block left its window")
    plan = WindowPlan(Q.compute_query_meta(qst, offs), start, qst.n_active,
                      *([None] * 5), offsets=tuple(map(tuple, offs.tolist())),
                      dkeys=Q.key_deltas(grid, offs), window_r=r)
    idx = torch.zeros((b, qst.capacity, k), dtype=torch.long, device=dev)
    found_all = torch.ones((b, qst.capacity, k), dtype=torch.bool, device=dev)
    for kk, found, rows in K._matched_rows(keys, plan.qmeta, start, qst.n_active,
                                           plan.dkeys, None, r, None):
        idx[:, :, kk], found_all[:, :, kk] = rows, found
    require(bool(found_all[:, : n_q // b].all()),
            "a query of the dense block misses an offset")
    live_tiles = int(((qst.n_active + Q.TILE_T - 1) // Q.TILE_T).sum())

    def feats(integer):
        shape = (b, tab.capacity, c)
        if integer:
            return _int_like(shape, gen, dev, torch.bfloat16)
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    w_int = _int_like((k, c, c), gen, dev, torch.bfloat16)
    w_real = (torch.randn((k, c, c), generator=gen, device=dev)
              / (k * c) ** 0.5).to(torch.bfloat16)
    conv_row, _ = _conv_row(
        label, keys, plan, start, qst.n_active, n_tab, n_q, live_tiles,
        idx.reshape(b, -1), found_all.reshape(b, -1, 1), k * n_q,
        feats(True), w_int, feats(False), w_real)
    # C and CO not multiples of 8: the tensor-core route stages element by
    # element
    cargs = (keys, feats(True)[..., :12].contiguous(), plan.qmeta, start,
             _int_like((k, 12, 20), gen, dev, torch.bfloat16), qst.n_active,
             plan.dkeys)
    got = K.window_conv_apply(*cargs, window_r=r)
    require(torch.equal(got, K.window_conv_apply_plain(*cargs, window_r=r))
            and float(got.abs().sum()) > 0,
            "window_conv_apply differs from its plain version at 12->20 "
            "channels on the dense block")
    emit({"phase": "kernel", "shape": label, "window_r": r,
          "rows": {"window_plan": plan_row, "window_conv_apply": conv_row}})
    return plan_row, conv_row


def phase_kernels(dataset, geo=GEOMETRY_3D):
    """Kernel against plain version at main-path shapes -> per-kernel rows."""
    import torch

    from sparseeventid_tpu_torch import io as port_io
    from sparseeventid_tpu_torch.models.encoder import capacity_schedule
    from sparseeventid_tpu_torch.ops import engine as E
    from sparseeventid_tpu_torch.ops import rulebook as rb
    from sparseeventid_tpu_torch.ops.window import kernels as K
    from sparseeventid_tpu_torch.ops.window import query as Q
    from sparseeventid_tpu_torch.ops.window.engine import _mirror_perm
    from sparseeventid_tpu_torch.ops.window.sidecar import (
        overflow_apply_batched,
        overflow_dw_batched,
    )

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    widths = geo.get("widths", WIDTHS_RECIPE)
    caps = capacity_schedule(geo["rows"], len(widths) - 1, 0.5,
                             geo.get("min_capacity", 1024))
    bf16 = torch.bfloat16
    stride, pre = geo["stride"], geo["prefix"]
    st0 = getattr(port_io, geo["to_sparse"])(
        dataset.batch([0])["image"], geo["grid"], capacity=caps[0], device=dev)
    # site sets of every level (the downsample chain)
    levels = [st0]
    for cap in caps[1:]:
        levels.append(rb.downsample_sites(levels[-1], stride, cap))
    tuning = Q.WindowTuning()

    def rows_of(st, c):
        return torch.where(
            st.row_mask()[..., None],
            torch.ones((*st.row_mask().shape, c), device=dev, dtype=bf16), 0,
        )

    def int_feats(st, c):
        return (_int_like((st.batch_size, st.capacity, c), gen, dev, bf16)
                * rows_of(st, c)).contiguous()

    def real_feats(st, c):
        x = torch.randn((st.batch_size, st.capacity, c), generator=gen, device=dev)
        return (x.to(bf16) * rows_of(st, c)).contiguous()

    def real_w(k, c, co):
        w = torch.randn((k, c, co), generator=gen, device=dev) / (k * c) ** 0.5
        return w.to(bf16).contiguous()

    k_init, k_ser = geo["initial"], geo["series"]
    # (label, table st, ksz, query capacity of a downsample, window_r, C,
    # CO, sidecars): the overflow sidecars are held against their plain
    # versions on the plan's list (and hand-made lists) of each case that
    # names them: "apply" the forward sidecar (the C == 1 entry at the
    # initial conv, the batched one elsewhere; the lists of the initial conv
    # and of the level-0 series must be non-empty, the deeper levels' may
    # be empty, as dune2d's levels 4 and 5 are), "dx" also the backward's dX
    # apply (the same list, gy as the table, W transposed and mirrored),
    # "dw" the dW sidecar.  At the recipes' widths levels 2 and 4 and the
    # level-1 downsample give the conv channel widths that are not
    # multiples of its 64-channel chunk; the small preset's (16 -> 64)
    # reach the one- and three-slab tensor-core routes.
    w = widths
    cases = [(f"{pre}initial {_kname(k_init)} 1->{w[0]}", levels[0], k_init,
              None, tuning.window_r_initial, 1, w[0], {"apply", "dw"})]
    for lv, sidecars in geo.get("series_levels", SERIES_LEVELS_RECIPE):
        cases.append((f"{pre}L{lv} series {_kname(k_ser)} {w[lv]}->{w[lv]}",
                       levels[lv], k_ser, None, tuning.for_level(lv), w[lv],
                       w[lv], set(sidecars)))
    for lv in geo.get("downsample_levels", (0, 1)):
        name = "L0" if lv == 0 else f"L{lv}->L{lv + 1}"
        cases.append((f"{pre}{name} downsample {_kname(stride)} "
                      f"{w[lv]}->{w[lv + 1]}", levels[lv], stride,
                      caps[lv + 1], tuning.window_r_strided, w[lv],
                      w[lv + 1], set()))

    if "cases" in geo:  # a geometry of a few shapes (the SimCLR views)
        cases = [(*case[:-1], case[-1] if geo.get("sidecars", True) else set())
                 for case in cases
                 if case[0][len(pre):].startswith(geo["cases"])]
    results = {n: [] for n in REPLACES if n not in OPS_KERNELS}
    for label, tab, ksz, qcap, r, c, co, sidecars in cases:
        strided = qcap is not None
        # the plan as the main path builds it (ops.engine), list included
        if strided:
            qst, (plan, rev), _ = E.build_downsample_plan(
                tab, ksz, qcap, backend=E.WINDOW, tuning=tuning)
        else:
            qst, plan = tab, E.build_series_plan(tab, ksz, backend=E.WINDOW,
                                                 window_r=r)
            rev = None
        require(plan.window_r == r, f"plan window {plan.window_r} at {label}")
        offs = rb.kernel_offsets(ksz, centered=not strided)
        keys = tab.keys()
        if strided:
            qkeys = Q.compute_strided_query_keys(qst, tab.grid_shape, ksz, offs)
            full = rb.build_downsample_rulebook(tab, qst, ksz)
        else:
            qkeys = Q.compute_query_keys(qst, offs)
            full = rb.build_submanifold_rulebook(tab, ksz)
        pk = Q._padded_table(keys)
        k = len(offs)
        # rows this run's data touches: active table rows, live query rows
        n_tab = int(tab.n_active.sum())
        n_q = int(qst.n_active.sum())
        live_tiles = int(((qst.n_active + Q.TILE_T - 1) // Q.TILE_T).sum())

        # ---- window_plan: bit-equal on the real site sets
        args = (pk, qkeys, qst.n_active)
        row, start, uncov = _plan_row(label, args, r, tab.capacity, n_tab,
                                      n_q, keys, qkeys)
        require(torch.equal(start, plan.start),
                f"window_plan differs from the engine's plan at {label}")
        results["window_plan"].append(row)
        candidates = uncov.ne(0).sum(dim=(1, 2))

        # the plan's overflow list, as the engine compacted it
        src, dst, kk, valid = plan.ov_src, plan.ov_dst, plan.ov_k, plan.ov_valid
        require(int(plan.ov_dropped.sum()) == 0, f"overflow list clamped at {label}")
        n_ov = int(valid.sum())
        pairs_total = int(full.hit.sum())
        pairs_in = pairs_total - n_ov
        occupancy = {
            "list_width": valid.shape[1],
            "candidates_max_per_event": int(candidates.max()),
            "real_pairs_max_per_event": int(valid.sum(dim=1).max()),
        }

        # ---- window_conv_apply: bit-equal on integer data
        w_int = _int_like((k, c, co), gen, dev, bf16)
        x_int = int_feats(tab, c)
        x_real, w_real = real_feats(tab, c), real_w(k, c, co)
        row, out = _conv_row(
            label, keys, plan, start, qst.n_active, n_tab, n_q, live_tiles,
            full.neighbor_idx.long().reshape(tab.batch_size, -1),
            full.hit.reshape(tab.batch_size, -1, 1), pairs_in, x_int, w_int,
            x_real, w_real)
        results["window_conv_apply"].append(row)
        rargs = (keys, x_real, plan.qmeta, start, w_real, qst.n_active,
                 plan.dkeys)

        # ---- sidecar on this plan's overflow list (C == 1: serial entry),
        # and on hand-made lists as wide
        name = "overflow_apply" if c == 1 else "overflow_apply_batched"
        if sidecars:
            # the lists of the initial conv and of the level-0 series
            require(n_ov > 0 or tab is not levels[0],
                    f"the overflow list is empty at {label}")
            nb = K._ov_bound(valid)
            hand = _handmade_lists(qst.n_active.tolist(), tab.n_active.tolist(),
                                   k, src.shape[1], SEED + c)
            require(K.overflow_dst_ordered(hand[1], hand[4])
                    and int(hand[4].max()) < src.shape[1],
                    f"hand-made lists are not as meant at {label}")
            lists = {"hand-made lists": hand}
            if n_ov > 0:
                lists = {"the plan's list": (src, dst, kk, valid, nb), **lists}
            walked = (torch.arange(src.shape[1], device=dev)[None, :]
                      < hand[4][:, None])
            occupancy["handmade_entries"] = int((hand[3] & walked).sum())
        if "apply" in sidecars:
            # the kernel's precondition (csrc/overflow_apply.cu)
            require(K.overflow_dst_ordered(dst, nb),
                    f"the overflow list's dst is out of order at {label}")
            entry = K.overflow_apply if c == 1 else overflow_apply_batched
            base_r = K.window_conv_apply(*rargs, window_r=r)
            results[name].append(_sidecar_checks(
                label, entry, lists, (out, x_int, w_int),
                (base_r, x_real, w_real), qst.capacity, tab.capacity))
            if "dx" in sidecars:
                # the submanifold backward's dX apply
                # (engine._SubmWindowConv.backward): the forward list as it
                # is, gy as the table, W transposed and mirrored
                perm_t = torch.as_tensor(_mirror_perm(plan.offsets), device=dev)

                def w_dx(w):
                    return w.transpose(1, 2)[perm_t].contiguous()

                results[name].append(_sidecar_checks(
                    f"{label} dX", entry, lists,
                    (int_feats(tab, c), int_feats(qst, co), w_dx(w_int)),
                    (real_feats(tab, c), real_feats(qst, co), w_dx(w_real)),
                    tab.capacity, qst.capacity))
        # ---- backward kernels.  gy lives on the OUTPUT sites (qst).
        gy_int = int_feats(qst, co)
        gy_real = real_feats(qst, co)
        nbr = full.neighbor_idx.long()  # [B, M, K] rows of tab per output row
        hit4 = full.hit[..., None]
        flat_rows = (nbr + torch.arange(tab.batch_size, device=dev)[:, None, None]
                     * tab.capacity).reshape(-1)

        def library_bwd(x, gy, w, want_dx=True):
            """PyTorch formulation over the full rulebook: one gather and
            one contraction for dW; one contraction and one index_add_ for
            dX."""
            xg = torch.gather(
                x, 1, nbr.reshape(tab.batch_size, -1, 1).expand(-1, -1, c)
            ).reshape(*nbr.shape, c) * hit4
            dw = torch.einsum("bmkc,bmo->kco", xg, gy)
            if not want_dx:
                return dw
            dxk = torch.einsum("bmo,kco->bmkc", gy, w) * hit4
            dx = torch.zeros((tab.batch_size * tab.capacity, c), dtype=x.dtype,
                             device=dev)
            return dx.index_add_(0, flat_rows, dxk.reshape(-1, c)), dw

        nw1 = plan.qmeta.shape[1]
        if c > 1:
            # kernel 5: the backward.  Submanifold: window_bwd_subm on the
            # forward plan (and window_bwd_strided with w[perm], its other
            # entry); strided: window_bwd_strided on the reverse plan
            # (queries are the INPUT rows, the table is gy's).
            bp = rev if strided else plan
            perm = None if strided else _mirror_perm(plan.offsets)
            bkeys = qst.keys()

            perm_t = None if strided else torch.as_tensor(perm, device=dev)

            def fused(x, gy, w, kernel=True):
                wk = w if strided else w[perm_t].contiguous()
                f = K.window_bwd_strided if kernel else K.window_bwd_strided_plain
                return f(bkeys, gy, x, bp.qmeta, bp.start, wk, bp.q_active,
                         bp.dkeys, window_r=bp.window_r)

            def subm(x, gy, w):  # the thin call the engine makes
                return K.window_bwd_subm(
                    bkeys, x, gy, bp.qmeta, bp.start, w, bp.q_active, perm,
                    bp.dkeys, window_r=bp.window_r)

            entries = [("window_bwd_strided", fused)]
            if not strided:
                entries.append(("window_bwd_subm", subm))
            for dt in (bf16, torch.float32):
                ints = (x_int.to(dt), gy_int.to(dt), w_int.to(dt))
                want = fused(*ints, kernel=False)
                for entry, f in entries:
                    before = K.window_bwd_strided.launches
                    got = f(*ints)
                    require(K.window_bwd_strided.launches == before + 1,
                            f"{entry} did not count its launch")
                    torch.cuda.synchronize()
                    require(torch.equal(got[0], want[0])
                            and torch.equal(got[1], want[1]),
                            f"{entry} differs from its plain version, {dt}, "
                            f"at {label}")
                require(float(got[1].abs().sum()) > 0, f"dw is all 0 at {label}")
            # real-valued data: dx within one bf16 ulp of its scale (fp32:
            # 1e-4 of it), dw within 1e-4 of its scale (float32 sums in
            # another order); two runs give the same bits
            err, worst = 0.0, {}
            for dt in (bf16, torch.float32):
                reals = (x_real.to(dt), gy_real.to(dt), w_real.to(dt))
                rp = fused(*reals, kernel=False)
                dx_scale = rp[0].float().abs().max().item()
                dw_scale = rp[1].abs().max().item()
                for entry, f in entries:
                    rk, again = f(*reals), f(*reals)
                    torch.cuda.synchronize()
                    require(torch.equal(rk[0], again[0])
                            and torch.equal(rk[1], again[1]),
                            f"{entry} is not the same bits on two runs, {dt}, "
                            f"at {label}")
                    dx_err = (rk[0].float() - rp[0].float()).abs().max().item()
                    dw_err = (rk[1] - rp[1]).abs().max().item()
                    dx_tol = (_bf16_ulp(dx_scale) if dt == bf16
                              else 1e-4 * dx_scale)
                    require(dx_err <= dx_tol and dw_err <= 1e-4 * dw_scale,
                            f"{entry} {dt} at {label}: dx off by {dx_err} "
                            f"(limit {dx_tol}), dw by {dw_err} (limit "
                            f"{1e-4 * dw_scale})")
                    worst[f"{entry} {dt}"] = dict(dx=dx_err, dw=dw_err)
                    if dt == bf16:
                        err = max(err, dx_err, dw_err)
            rk = fused(x_real, gy_real, w_real)
            ms = timed_ms(lambda: fused(x_real, gy_real, w_real))
            plain_ms = timed_ms(lambda: fused(x_real, gy_real, w_real, False),
                                iters=2, warmup=1, graph=False)
            lib_ms = timed_ms(lambda: library_bwd(x_real, gy_real, w_real),
                              iters=3, warmup=1)
            parent_ms = None
            if PARENT is not None:
                # the same design: the same bits
                got = PARENT.run(fused, x_real, gy_real, w_real)
                require(torch.equal(got[0], rk[0]) and torch.equal(got[1], rk[1]),
                        f"the earlier window_bwd_strided differs at {label}")
                parent_ms = timed_ms(
                    lambda: PARENT.run(fused, x_real, gy_real, w_real))
            # in-window pairs of the plan the kernel walks
            n_rev_ov = int(bp.ov_valid.sum())
            pairs_bwd = pairs_total - n_rev_ov
            rows_x = int(tab.n_active.sum())  # query side: the input rows
            rows_gy = int(qst.n_active.sum())
            tiles_x = int(((tab.n_active + Q.TILE_T - 1) // Q.TILE_T).sum())
            # reads: keys and gy of the active gy rows, x and meta of the
            # live input rows, the live tiles' starts, W; writes: dx in
            # full (dead rows are defined as 0) and dw
            b_ms, b_by = bound(
                (4 + 2 * co) * rows_gy
                + (2 * c + 4 * bp.qmeta.shape[1]) * rows_x + 4 * k * tiles_x
                + nbytes(bp.q_active, w_real, rk[0], rk[1]),
                4.0 * pairs_bwd * c * co,
            )
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            m_in = bp.qmeta.shape[2]
            results["window_bwd_strided"].append(dict(
                shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                parent_ms=parent_ms, pairs_in_window=pairs_bwd,
                entry="window_bwd_strided" if strided else "window_bwd_subm",
                real_valued_err=worst, repeats_bit_for_bit=True,
                dx_groups=K._conv_groups(sms, tab.batch_size, m_in, k, co, c),
                dw_parts=K._bwd_dw_parts(sms, tab.batch_size, m_in, k, c, co),
            ))
        else:
            # kernel 6: window_dw over the forward plan (the initial conv)
            # the persistent grid must stride: more live tiles than blocks
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            parts, groups = K._dw_parts(sms, tab.batch_size, qst.capacity, k,
                                        c, co)
            # (a view of 3000 voxels, or a batch of the small preset's
            # events, has no more live tiles than blocks)
            require(live_tiles > parts or "cases" in geo,
                    f"{live_tiles} live tiles, {parts} window_dw blocks at {label}")
            for dt in (bf16, torch.float32):
                dargs = (keys, x_int.to(dt), plan.qmeta, start, gy_int.to(dt),
                         qst.n_active, plan.dkeys)
                got = K.window_dw(*dargs, window_r=r)
                want = K.window_dw_plain(*dargs, window_r=r)
                torch.cuda.synchronize()
                require(torch.equal(got, want),
                        f"window_dw differs from its plain version, {dt}, at {label}")
                require(float(got.abs().sum()) > 0, f"dw is all 0 at {label}")
            rargs_dw = (keys, x_real, plan.qmeta, start, gy_real, qst.n_active,
                        plan.dkeys)
            err, parent_ms = _dw_checks(
                label, (keys, x_int, plan.qmeta, start, gy_int, qst.n_active,
                        plan.dkeys), rargs_dw, r)
            ms = timed_ms(lambda: K.window_dw(*rargs_dw, window_r=r))
            plain_ms = timed_ms(lambda: K.window_dw_plain(*rargs_dw, window_r=r),
                                iters=2, warmup=1, graph=False)
            lib_ms = timed_ms(
                lambda: library_bwd(x_real, gy_real, w_real, want_dx=False),
                iters=3, warmup=1)
            b_ms, b_by = bound(
                (4 + 2 * c) * n_tab + (4 * nw1 + 2 * co) * n_q
                + 4 * k * live_tiles + nbytes(qst.n_active, got),
                2.0 * pairs_in * c * co,
            )
            results["window_dw"].append(dict(
                shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                parent_ms=parent_ms, pairs_in_window=pairs_in,
                live_tiles=live_tiles, blocks=parts, offset_groups=groups,
                repeats_bit_for_bit=True,
            ))

        # ---- dW sidecar on the lists the backward walks: each list with
        # src and dst swapped for the fused submanifold backward, as it is
        # for C == 1 (the plan's list where it is non-empty, and the
        # hand-made lists)
        dname = "overflow_dw" if c == 1 else "overflow_dw_batched"
        if "dw" in sidecars:
            dw_lists = {what: lst if c == 1 else (lst[1], lst[0], *lst[2:])
                        for what, lst in lists.items()}

            def side_dw(x, gy, lst, kernel=True, entry=dname):
                sargs = (x, gy, k, *lst)
                if not kernel:
                    return K.overflow_dw_plain(*sargs)
                if entry == "overflow_dw":
                    return K.overflow_dw(*sargs)
                return overflow_dw_batched(*sargs)

            # both entries (one kernel), integer data bit-equal in bf16 and
            # fp32; real-valued data within 1e-4 of the scale and the same
            # bits on two runs
            err = 0.0
            for what, lst in dw_lists.items():
                for dt in (bf16, torch.float32):
                    ints = (x_int.to(dt), gy_int.to(dt))
                    reals = (x_real.to(dt), gy_real.to(dt))
                    want = side_dw(*ints, lst, kernel=False)
                    rp = side_dw(*reals, lst, kernel=False)
                    for entry in ("overflow_dw", "overflow_dw_batched"):
                        got = side_dw(*ints, lst, entry=entry)
                        torch.cuda.synchronize()
                        require(torch.equal(got, want),
                                f"{entry} differs from its plain version on "
                                f"{what}, {dt}, at {label}")
                        require(float(got.abs().sum()) > 0,
                                f"sidecar dw is all 0 on {what} at {label}")
                        rk, again = (side_dw(*reals, lst, entry=entry),
                                     side_dw(*reals, lst, entry=entry))
                        torch.cuda.synchronize()
                        require(torch.equal(rk, again),
                                f"{entry} is not the same bits on two runs on "
                                f"{what}, {dt}, at {label}")
                        e_ = (rk - rp).abs().max().item()
                        require(e_ <= 1e-4 * rp.abs().max().item(),
                                f"{entry} {dt} off by {e_} on {what} at {label}")
                        if dt == bf16:
                            err = max(err, e_)
            # timed on the first list
            what, lst = next(iter(dw_lists.items()))
            s_, d_, kk_, valid_, nb_ = lst
            ms = timed_ms(lambda: side_dw(x_real, gy_real, lst))
            plain_ms = timed_ms(lambda: side_dw(x_real, gy_real, lst, False),
                                iters=3, warmup=1, graph=False)
            parent_ms = None
            if PARENT is not None:
                require(torch.equal(PARENT.run(side_dw, x_real, gy_real, lst),
                                    side_dw(x_real, gy_real, lst)),
                        f"the earlier overflow_dw differs on {what} at {label}")
                parent_ms = timed_ms(
                    lambda: PARENT.run(side_dw, x_real, gy_real, lst))
            ok = valid_ & (torch.arange(s_.shape[1], device=dev)[None, :]
                           < nb_[:, None])
            n_e = int(ok.sum())
            bi, si = torch.nonzero(ok, as_tuple=True)
            xs = x_real[bi, s_[bi, si].long()]
            gs = gy_real[bi, d_[bi, si].long()]
            kidx = kk_[bi, si].long()
            acc = torch.zeros((k, c, co), dtype=torch.float32, device=dev)

            def library_dw():
                acc.index_add_(0, kidx, (xs[:, :, None] * gs[:, None, :]).float())

            lib_ms = timed_ms(library_dw)
            xrows = bi * tab.capacity + s_[bi, si].long()
            grows = bi * qst.capacity + d_[bi, si].long()
            # reads: the valid flags of the walked prefix, (src, dst, k) of
            # the valid entries, each distinct x and gy row once; writes dw
            b_ms, b_by = bound(
                int(nb_.sum()) + 12 * n_e + nbytes(nb_, got)
                + 2 * c * int(torch.unique(xrows).numel())
                + 2 * co * int(torch.unique(grows).numel()),
                2.0 * n_e * c * co,
            )
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            suffix = "" if what == "the plan's list" else f", {what}"
            results[dname].append(dict(
                shape=label + suffix, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                parent_ms=parent_ms, entries=n_e, walked=int(nb_.sum()),
                parts=K._ov_dw_parts(sms, k, c, co),
                piece=K._ov_dw_piece(k, c, co), repeats_bit_for_bit=True,
            ))
        del gy_int, gy_real, nbr, hit4, flat_rows
        emit({"phase": "kernel", "shape": label, "window_r": r,
              "table_rows_per_event": [int(tab.n_active.min()),
                                       int(tab.n_active.max())],
              "pairs": pairs_total, "overflow_entries": n_ov, **occupancy,
              "rows": {n: rs[0] if len(rs) == 1 else rs
                       for n, v in results.items()
                       for rs in [[r for r in v
                                   if r["shape"].startswith(label)]] if rs}})
    return results


def _swap_dx_list(apply, is_dx_call):
    """The dX sidecar as it was once wrong: the twin list TRANSPOSED and the
    weights left unpermuted, instead of the list as it is with permuted
    weights.  ``is_dx_call(out, table, plan)`` picks the calls to break."""
    import dataclasses

    import torch

    from sparseeventid_tpu_torch.ops.window.engine import _mirror_perm
    from sparseeventid_tpu_torch.ops.window.kernels import _ov_bound

    def patched(out, table, w, plan):
        if is_dx_call(out, table, plan):
            perm = torch.as_tensor(_mirror_perm(plan.offsets), device=w.device)
            # transposed, then sorted by the new dst over the walked prefix,
            # as the sidecar kernel needs every list: the fault is the pair
            # set, not the order
            nb = _ov_bound(plan.ov_valid)
            pos = torch.arange(plan.ov_src.shape[1], device=w.device)
            key = torch.where(pos[None, :] < nb[:, None], plan.ov_src.long(),
                              2**40)
            order = torch.sort(key, dim=1, stable=True).indices
            take = lambda x: torch.gather(x, 1, order)  # noqa: E731
            plan = dataclasses.replace(
                plan, ov_src=take(plan.ov_dst), ov_dst=take(plan.ov_src),
                ov_k=take(plan.ov_k), ov_valid=take(plan.ov_valid))
            w = w[perm].contiguous()  # perm is an involution: undoes it
        return apply(out, table, w, plan)

    return patched


def _no_dw_sidecar(x, gy, src, dst, plan):
    """The dW sidecar left out."""
    import torch

    return torch.zeros((plan.num_offsets, x.shape[-1], gy.shape[-1]),
                       device=x.device)


def phase_grad_check(dataset) -> None:
    """dX and dW of the window autograd Functions against the plain rulebook
    backend's autograd, integer-valued fp32 data: exact equality, then two
    planted faults that the equality must catch."""
    import torch

    from sparseeventid_tpu_torch.io import larcv_batch_to_sparse_3d
    from sparseeventid_tpu_torch.models.encoder import capacity_schedule
    from sparseeventid_tpu_torch.ops import conv as C
    from sparseeventid_tpu_torch.ops import engine as E
    from sparseeventid_tpu_torch.ops import rulebook as rb
    from sparseeventid_tpu_torch.ops.window import engine as WE
    from sparseeventid_tpu_torch.ops.window import query as Q

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    caps = capacity_schedule(MAX_VOXELS, 5, 0.5, 1024)
    st = larcv_batch_to_sparse_3d(dataset.batch([0])["image"], GRID,
                                  capacity=caps[0], device=dev)
    tuning = Q.WindowTuning()
    c_in, c_out = 32, 48  # unequal, so the planted fault can tell dX's call

    def ints(shape, mask=None):
        x = _int_like(shape, gen, dev, torch.float32)
        return x if mask is None else x * mask[..., None]

    def grads(conv, x0, w0, gy):
        x = x0.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        conv(st.with_feats(x), w).feats.backward(gy)
        torch.cuda.synchronize()
        return x.grad, w.grad

    x0 = ints((st.batch_size, st.capacity, c_in), st.row_mask())
    plan = E.build_series_plan(st, (3, 3, 3), backend=E.WINDOW,
                               window_r=tuning.for_level(0))
    book = rb.build_submanifold_rulebook(st, (3, 3, 3))
    sk, (fwd, rev), _ = E.build_downsample_plan(
        st, (2, 2, 2), caps[1], backend=E.WINDOW, tuning=tuning)
    dbook = rb.build_downsample_rulebook(st, sk, (2, 2, 2))
    # at the main path's reverse window nearly every parent is in-window;
    # a 64-row window puts tens of thousands of pairs on the reverse list
    _, (nfwd, nrev), _ = E.build_downsample_plan(
        st, (2, 2, 2), caps[1], backend=E.WINDOW,
        tuning=Q.WindowTuning(window_r=64))
    entries = {"series": int(plan.ov_valid.sum()),
               "down_fwd": int(fwd.ov_valid.sum()),
               "down_rev": int(rev.ov_valid.sum()),
               "down_rev_narrow": int(nrev.ov_valid.sum())}
    require(min(entries["series"], entries["down_fwd"],
                entries["down_rev_narrow"]) > 1000,
            f"overflow lists are too short to test the sidecars: {entries}")
    for p in (plan, fwd, rev, nfwd, nrev):
        require(int(p.ov_dropped.sum()) == 0, "an overflow list was clamped")
    cases = {
        "submanifold": (
            lambda s, w: WE.window_submanifold_conv(s, plan, w),
            lambda s, w: C.submanifold_conv(s, book, w),
            ints((27, c_in, c_out)),
            ints((st.batch_size, st.capacity, c_out), st.row_mask()),
        ),
        "strided": (
            lambda s, w: WE.window_strided_conv(s, sk, fwd, rev, w),
            lambda s, w: C.strided_conv(s, sk, dbook, w),
            ints((8, c_in, c_out)),
            ints((sk.batch_size, sk.capacity, c_out), sk.row_mask()),
        ),
    }
    cases["strided_narrow_reverse"] = (
        lambda s, w: WE.window_strided_conv(s, sk, nfwd, nrev, w),
        *cases["strided"][1:],
    )
    report = {"phase": "grad_check", "dtype": "float32", "entries": entries}
    want = {}
    for name, (win, ref, w0, gy) in cases.items():
        got = grads(win, x0, w0, gy)
        want[name] = grads(ref, x0, w0, gy)
        same = [torch.equal(g, r) for g, r in zip(got, want[name])]
        report[name] = {"dx_equal": same[0], "dw_equal": same[1],
                        "dx_abs_sum": float(got[0].abs().sum()),
                        "dw_abs_sum": float(got[1].abs().sum())}
        require(all(same), f"{name} conv gradients differ from the plain "
                f"backend's: dx, dw equal = {same}")
        require(report[name]["dw_abs_sum"] > 0, f"{name}: dw is all 0")

    # planted faults, on the submanifold case
    win, _, w0, gy = cases["submanifold"]
    faults = {
        "dw_sidecar_skipped": ("_overflow_dw", _no_dw_sidecar, 1),
        # c_in != c_out tells the dX call from the forward's
        "twin_list_transposed": ("_apply_overflow", _swap_dx_list(
            WE._apply_overflow,
            lambda out, table, p: out.shape[-1] == c_in != table.shape[-1]), 0),
    }
    for fault, (attr, patched, broken) in faults.items():
        sound = getattr(WE, attr)
        setattr(WE, attr, patched)
        try:
            got = grads(win, x0, w0, gy)
        finally:
            setattr(WE, attr, sound)
        same = [torch.equal(g, r) for g, r in zip(got, want["submanifold"])]
        report[fault] = {"dx_equal": same[0], "dw_equal": same[1],
                         "max_abs_diff": float(
                             (got[broken] - want["submanifold"][broken]).abs().max())}
        require(not same[broken],
                f"the exact gradient check is blind to the fault {fault}")
    emit(report)


def phase_gather_kernels(dataset):
    """Kernels 9 and 10 against their plain versions at dune3d shapes ->
    per-kernel rows.  window_gather: the deconv's shape (level-1 table,
    level-0 queries over the reverse plan, K = 8) and the level-0 series
    shape (K = 27, C = 32), bit-equal on real-valued bf16 and fp32 data.
    gather_conv: levels 0, 2, 4 and 5 over the real rulebooks, bit-equal
    on integer-valued bf16 and fp32 data, within one bf16 ulp on
    real-valued data and the same bits twice.  The deconv's two-step dW is
    timed beside window_dw at the same shape."""
    import torch

    from sparseeventid_tpu_torch.io import larcv_batch_to_sparse_3d
    from sparseeventid_tpu_torch.models.encoder import capacity_schedule
    from sparseeventid_tpu_torch.ops import engine as E
    from sparseeventid_tpu_torch.ops import gather_conv as GC
    from sparseeventid_tpu_torch.ops import rulebook as rb
    from sparseeventid_tpu_torch.ops.window import kernels as K
    from sparseeventid_tpu_torch.ops.window import query as Q

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    caps = capacity_schedule(MAX_VOXELS, 5, 0.5, 1024)
    bf16 = torch.bfloat16
    st0 = larcv_batch_to_sparse_3d(dataset.batch([0])["image"], GRID,
                                   capacity=caps[0], device=dev)
    levels = [st0]
    for cap in caps[1:]:
        levels.append(rb.downsample_sites(levels[-1], (2, 2, 2), cap))
    tuning = Q.WindowTuning()

    def feats_of(st, c, integer=False):
        shape = (st.batch_size, st.capacity, c)
        x = (_int_like(shape, gen, dev, bf16) if integer
             else torch.randn(shape, generator=gen, device=dev).to(bf16))
        return torch.where(st.row_mask()[..., None], x, 0).contiguous()

    results = {n: [] for n in OPS_KERNELS}
    results["window_dw"] = []  # its deconv shape; the main shapes: kernel phase

    # ---- window_gather
    fwd, rev = E.build_upsample_plan(levels[1], st0, (2, 2, 2),
                                     backend=E.WINDOW, tuning=tuning)
    series = E.build_series_plan(st0, (3, 3, 3), backend=E.WINDOW,
                                 window_r=tuning.for_level(0))
    gather_cases = [
        ("deconv L1->L0 2^3 C=64", levels[1], st0, rev, 64),
        ("L0 series 3^3 C=32", st0, st0, series, 32),
    ]
    for label, tab, qst, plan, c in gather_cases:
        require(int(plan.ov_dropped.sum()) == 0, f"list clamped at {label}")
        keys = tab.keys()
        x = feats_of(tab, c)
        args = (keys, x, plan.qmeta, plan.start, plan.q_active, plan.dkeys)
        got = K.window_gather(*args, window_r=plan.window_r)
        want = K.window_gather_plain(*args, window_r=plan.window_r)
        torch.cuda.synchronize()
        require(torch.equal(got, want),
                f"window_gather differs from its plain version at {label}")
        k = plan.num_offsets
        matched = got.view(*got.shape[:2], k, c).ne(0).any(dim=-1)
        n_matched = int(matched.sum())
        require(n_matched > 0, f"window_gather matched nothing at {label}")
        del want
        # real-valued fp32 data (the 16-byte route at these C), and at the
        # deconv's shape C = 12 bf16, 24-byte rows: the per-value route
        routes = [("fp32", torch.randn(x.shape, generator=gen, device=dev))]
        if plan is rev:
            routes.append(("bf16 C=12", feats_of(tab, 12)))
        for what, xr in routes:
            xr = torch.where(tab.row_mask()[..., None], xr, 0).contiguous()
            rargs = (keys, xr) + args[2:]
            require(torch.equal(K.window_gather(*rargs, window_r=plan.window_r),
                                K.window_gather_plain(*rargs,
                                                      window_r=plan.window_r)),
                    f"window_gather differs from its plain version, {what}, "
                    f"at {label}")
            del xr, rargs
        ms = timed_ms(lambda: K.window_gather(*args, window_r=plan.window_r))
        parent_ms = None
        if PARENT is not None:
            require(torch.equal(PARENT.run(K.window_gather, *args,
                                           window_r=plan.window_r), got),
                    f"the earlier window_gather differs at {label}")
            parent_ms = timed_ms(lambda: PARENT.run(
                K.window_gather, *args, window_r=plan.window_r))
        plain_ms = timed_ms(
            lambda: K.window_gather_plain(*args, window_r=plan.window_r),
            iters=2, warmup=1, graph=False)
        # yardstick: one index gather of the matched rows, indices given
        rows = torch.zeros((qst.batch_size, qst.capacity, k), dtype=torch.int64,
                           device=dev)
        found = torch.zeros_like(rows, dtype=torch.bool)
        for kk, f, r in K._matched_rows(keys, plan.qmeta, plan.start,
                                        plan.q_active, plan.dkeys, None,
                                        plan.window_r, None):
            rows[:, :, kk], found[:, :, kk] = r, f
        flat = rows.reshape(qst.batch_size, -1, 1)
        mask = found.reshape(qst.batch_size, -1, 1)

        def library():
            g = torch.gather(x, 1, flat.expand(-1, -1, c))
            return torch.where(mask, g, 0)

        require(torch.equal(library().reshape(got.shape), got),
                f"the library gather differs at {label}")
        lib_ms = timed_ms(library)
        n_q = int(qst.n_active.sum())
        live_tiles = int(((qst.n_active + Q.TILE_T - 1) // Q.TILE_T).sum())
        distinct = int(torch.unique(
            rows[found] + (torch.nonzero(found)[:, 0] * tab.capacity)).numel())
        # reads: keys of the active table rows, each distinct matched row
        # once, the live queries' meta, the live tiles' starts; writes: the
        # output in full (unmatched slots and dead rows are defined as 0)
        b_ms, b_by = bound(
            4 * int(tab.n_active.sum()) + 2 * c * distinct
            + 4 * plan.qmeta.shape[1] * n_q + 4 * k * live_tiles
            + nbytes(plan.q_active, got), 0)
        results["window_gather"].append(dict(
            shape=label, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            parent_ms=parent_ms, matched_slots=n_matched,
            output_mb=nbytes(got) / 1e6,
        ))
        row = {"window_gather": results["window_gather"][-1]}
        if plan is rev:
            # the deconv's dW both ways: gather + one float32 product (the
            # port's route), and window_dw at the same shape
            gy = feats_of(qst, 32)

            def two_step():
                g1 = K.window_gather(*args, window_r=plan.window_r)
                return torch.einsum("bno,bnm->mo", gy.float(), g1.float())

            def fused():
                return K.window_dw(keys, x, plan.qmeta, plan.start, gy,
                                   plan.q_active, plan.dkeys,
                                   window_r=plan.window_r)

            a, b = two_step().reshape(k, c, 32), fused()
            scale = float(b.abs().max())
            err = float((a - b).abs().max())
            # float32 sums of up to 4e5 bf16 products in two orders
            require(err <= 1e-3 * scale,
                    f"two-step dW differs from window_dw: {err} of {scale}")
            row["deconv_dw"] = dict(
                two_step_ms=timed_ms(two_step), window_dw_ms=timed_ms(fused),
                max_abs_diff=err, max_abs=scale)
            # window_dw's own row at this shape: bit-equal to its plain
            # version on integer data, then timed as in the kernel phase
            x_int, gy_int = feats_of(tab, c, integer=True), feats_of(qst, 32, True)
            for dt in (bf16, torch.float32):
                dargs = (keys, x_int.to(dt), plan.qmeta, plan.start,
                         gy_int.to(dt), plan.q_active, plan.dkeys)
                got_dw = K.window_dw(*dargs, window_r=plan.window_r)
                want_dw = K.window_dw_plain(*dargs, window_r=plan.window_r)
                torch.cuda.synchronize()
                require(torch.equal(got_dw, want_dw) and float(got_dw.abs().sum()) > 0,
                        f"window_dw differs from its plain version, {dt}, at {label}")

            def plain_dw():
                return K.window_dw_plain(keys, x, plan.qmeta, plan.start, gy,
                                         plan.q_active, plan.dkeys,
                                         window_r=plan.window_r)

            book = rb.build_upsample(tab, qst, (2, 2, 2))
            nbr_up = book.neighbor_idx.long().reshape(qst.batch_size, -1, 1)
            hit_up = book.hit[..., None]

            def library_dw():
                xg = torch.gather(x, 1, nbr_up.expand(-1, -1, c))
                xg = xg.reshape(*book.hit.shape, c) * hit_up
                return torch.einsum("bmkc,bmo->kco", xg, gy)

            pairs_in = int(found.sum())
            b_ms, b_by = bound(
                (4 + 2 * c) * int(tab.n_active.sum())
                + (4 * plan.qmeta.shape[1] + 2 * 32) * n_q + 4 * k * live_tiles
                + nbytes(plan.q_active, b), 2.0 * pairs_in * c * 32)
            dw_label = f"deconv L1->L0 2^3 {c}->32"
            dw_err, dw_parent_ms = _dw_checks(
                dw_label, (keys, x_int, plan.qmeta, plan.start, gy_int,
                           plan.q_active, plan.dkeys),
                (keys, x, plan.qmeta, plan.start, gy, plan.q_active,
                 plan.dkeys), plan.window_r)
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            results["window_dw"].append(dict(
                shape=dw_label, max_abs_err=dw_err, ms=timed_ms(fused),
                plain_ms=timed_ms(plain_dw, iters=2, warmup=1, graph=False),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=timed_ms(library_dw, iters=3, warmup=1),
                parent_ms=dw_parent_ms, pairs_in_window=pairs_in,
                live_tiles=live_tiles, repeats_bit_for_bit=True,
                blocks=K._dw_parts(sms, qst.batch_size, qst.capacity, k, c,
                                   32)[0]))
            row["window_dw"] = results["window_dw"][-1]
            del book, nbr_up, hit_up, x_int, gy_int
        emit({"phase": "gather_kernel", "shape": label,
              "window_r": plan.window_r, "rows": row})
        del got, rows, found, flat, mask, x
        torch.cuda.empty_cache()

    # ---- gather_conv over the full rulebooks (L0, L2, L4, L5 series)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for lv in (0, 2, 4, 5):
        st = levels[lv]
        c = co = (32, 64, 96, 128, 160, 192)[lv]
        label = f"L{lv} series 3^3 {c}->{co}"
        book = rb.build_submanifold_rulebook(st, (3, 3, 3))
        idx = GC._encode_miss(book, st.capacity)
        pairs = int(book.hit.sum())
        w_int = _int_like((27, c, co), gen, dev, bf16)
        x_int = feats_of(st, c, integer=True)
        # integer-valued data, bf16 and fp32: bit-equal to the plain version
        for dt in (bf16, torch.float32):
            got = GC.gather_conv(x_int.to(dt), idx, w_int.to(dt))
            want = GC.gather_conv_plain(x_int.to(dt), idx, w_int.to(dt))
            torch.cuda.synchronize()
            require(torch.equal(got, want),
                    f"gather_conv differs from its plain version, {dt}, at {label}")
            require(float(got.float().abs().sum()) > 0, f"all 0 at {label}")
        if lv == 0:
            # the backward's dX form: mirrored index columns, W transposed
            perm = torch.as_tensor(GC.mirror_permutation(book.offsets), device=dev)
            idx_m = idx[:, :, perm].contiguous()
            for dt in (bf16, torch.float32):
                w_t = w_int.to(dt).transpose(1, 2).contiguous()
                require(torch.equal(GC.gather_conv(x_int.to(dt), idx_m, w_t),
                                    GC.gather_conv_plain(x_int.to(dt), idx_m, w_t)),
                        f"gather_conv's dX form differs, {dt}, at {label}")
            del idx_m, w_t
        if lv == 5:
            # 12 -> 20 channels: the element-by-element route
            x12 = feats_of(st, 12, integer=True)
            w12 = _int_like((27, 12, 20), gen, dev, bf16)
            require(torch.equal(GC.gather_conv(x12, idx, w12),
                                GC.gather_conv_plain(x12, idx, w12)),
                    f"gather_conv differs from its plain version at {label} "
                    "12->20")
            del x12, w12
        # real-valued bf16: within one bf16 ulp of the output scale, the
        # same bits on two runs
        x = feats_of(st, c)
        w = (torch.randn((27, c, co), generator=gen, device=dev)
             / (27 * c) ** 0.5).to(bf16).contiguous()
        want = GC.gather_conv_plain(x, idx, w).float()
        got, again = GC.gather_conv(x, idx, w), GC.gather_conv(x, idx, w)
        torch.cuda.synchronize()
        require(torch.equal(got, again),
                f"gather_conv is not the same bits on two runs at {label}")
        scale = want.abs().max().item()
        err = (got.float() - want).abs().max().item()
        require(err <= _bf16_ulp(scale),
                f"gather_conv differs by {err} at {label}, more than one bf16 "
                f"ulp of the output scale {scale}")
        ms = timed_ms(lambda: GC.gather_conv(x, idx, w))
        plain_ms = timed_ms(lambda: GC.gather_conv_plain(x, idx, w),
                            iters=2, warmup=1, graph=False)
        flat = book.neighbor_idx.long().reshape(st.batch_size, -1, 1)
        hit = book.hit.reshape(st.batch_size, -1, 1)
        w2 = w.reshape(27 * c, co)

        def library():
            g = torch.gather(x, 1, flat.expand(-1, -1, c)) * hit
            return torch.matmul(g.reshape(st.batch_size, st.capacity, 27 * c), w2)

        lib_ms = timed_ms(library)
        parent_ms = None
        if PARENT is not None:
            require(torch.equal(PARENT.run(GC.gather_conv, x_int, idx, w_int),
                                GC.gather_conv(x_int, idx, w_int)),
                    f"the earlier gather_conv differs at {label}")
            parent_ms = timed_ms(lambda: PARENT.run(GC.gather_conv, x, idx, w))
        n_live = int(st.n_active.sum())
        # reads: the features of the active rows, the live rows' indices,
        # W; writes: the output in full; flops: the hit pairs only
        b_ms, b_by = bound(
            2 * c * n_live + 4 * 27 * n_live + nbytes(w, got),
            2.0 * pairs * c * co)
        results["gather_conv"].append(dict(
            shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            parent_ms=parent_ms, pairs=pairs, out_scale=scale,
            groups=GC.gather_groups(sms, st.batch_size, st.capacity, 27, c, co),
        ))
        emit({"phase": "gather_kernel", "shape": label,
              "rows": {"gather_conv": results["gather_conv"][-1]}})
        del got, again, want, x, x_int, w, w_int, flat, hit, idx, book
        torch.cuda.empty_cache()
    return results


def phase_engine_ops(dataset):
    """The engine's remaining ops on integer-valued fp32 data on the card,
    each against the plain backend under autograd, exactly; two planted
    faults that the equality must catch; then the two ops no model selects
    driven at full width in bf16 through the entry points a user calls
    (ConvolutionUpsample, gather_submanifold_conv) -> their launch counts."""
    import numpy as np
    import torch

    from sparseeventid_tpu_torch.config.schema import ConvRepresentation, Norm
    from sparseeventid_tpu_torch.io import larcv_batch_to_sparse_3d
    from sparseeventid_tpu_torch.models import blocks as B
    from sparseeventid_tpu_torch.models import init_parameters
    from sparseeventid_tpu_torch.models.encoder import capacity_schedule
    from sparseeventid_tpu_torch.ops import conv as C
    from sparseeventid_tpu_torch.ops import engine as E
    from sparseeventid_tpu_torch.ops import gather_conv as GC
    from sparseeventid_tpu_torch.ops import rulebook as rb
    from sparseeventid_tpu_torch.ops.window import engine as WE
    from sparseeventid_tpu_torch.ops.window import kernels as K
    from sparseeventid_tpu_torch.ops.window import query as Q

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    caps = capacity_schedule(MAX_VOXELS, 5, 0.5, 1024)
    fine = larcv_batch_to_sparse_3d(dataset.batch([0])["image"], GRID,
                                    capacity=caps[0], device=dev)
    coarse = rb.downsample_sites(fine, (2, 2, 2), caps[1])
    c_in, c_out = 32, 48

    def ints(shape, mask=None):
        x = _int_like(shape, gen, dev, torch.float32)
        return x if mask is None else x * mask[..., None]

    def grads(fn, st, x0, w0, gy):
        """(out, dx, dw) of fn(st with x0, w0) under the cotangent gy."""
        x = x0.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        out = fn(st.with_feats(x), w).feats
        out.backward(gy)
        torch.cuda.synchronize()
        return out.detach(), x.grad, w.grad

    def compare(got, want):
        return [bool(torch.equal(g, r)) for g, r in zip(got, want)]

    report = {"phase": "engine_ops", "dtype": "float32"}

    # ---- the deconv: coarse level 1 -> fine level 0
    xc = ints((coarse.batch_size, coarse.capacity, c_in), coarse.row_mask())
    gy_f = ints((fine.batch_size, fine.capacity, c_out), fine.row_mask())
    w8 = ints((8, c_in, c_out))
    book = rb.build_upsample(coarse, fine, (2, 2, 2))
    want = grads(lambda s, w: C.deconv(s, fine, book, w), coarse, xc, w8, gy_f)
    require(float(want[2].abs().sum()) > 0, "the plain deconv's dw is all 0")
    plans = {
        "deconv": E.build_upsample_plan(coarse, fine, (2, 2, 2),
                                        backend=E.WINDOW),
        # a 64-row reverse window fills the reverse list
        "deconv_narrow_reverse": E.build_upsample_plan(
            coarse, fine, (2, 2, 2), backend=E.WINDOW,
            tuning=Q.WindowTuning(window_r=64)),
    }
    for name, (fwd, rev) in plans.items():
        require(int(fwd.ov_dropped.sum() + rev.ov_dropped.sum()) == 0,
                f"{name}: an overflow list was clamped")
        got = grads(lambda s, w: E.apply_upsample(s, fine, (fwd, rev), w),
                    coarse, xc, w8, gy_f)
        same = compare(got, want)
        report[name] = {"out_dx_dw_equal": same,
                        "forward_entries": int(fwd.ov_valid.sum()),
                        "reverse_entries": int(rev.ov_valid.sum())}
        require(all(same), f"{name}: out, dx, dw equal the plain deconv's = {same}")
    narrow = plans["deconv_narrow_reverse"]
    require(int(narrow[1].ov_valid.sum()) > 1000,
            f"the narrow reverse list is too short: {report}")
    sound = WE._overflow_dw
    WE._overflow_dw = _no_dw_sidecar
    try:
        got = grads(lambda s, w: E.apply_upsample(s, fine, narrow, w),
                    coarse, xc, w8, gy_f)
    finally:
        WE._overflow_dw = sound
    same = compare(got, want)
    report["deconv_dw_sidecar_skipped"] = {
        "out_dx_dw_equal": same,
        "max_abs_diff": float((got[2] - want[2]).abs().max())}
    require(same[0] and same[1] and not same[2],
            "the exact deconv check is blind to a skipped dW sidecar")

    # ---- pooling downsample: the window branch against the plain branch
    # (no norm and a slope of 1, so every sum stays exact)
    params = ConvRepresentation(normalization=Norm.none, leakiness=1.0)
    xf = ints((fine.batch_size, fine.capacity, c_in), fine.row_mask())
    gy_c = ints((coarse.batch_size, coarse.capacity, c_out), coarse.row_mask())
    w_pool, b_pool = ints((1, c_in, c_out)), ints((c_out,))
    pooled = {}
    for backend in (E.WINDOW, E.XLA):
        mod = B.PoolingDownsample(c_in, c_out, (2, 2, 2), params,
                                  out_capacity=caps[1], backend=backend).to(dev)
        with torch.no_grad():
            mod.w.copy_(w_pool)
            mod.b.copy_(b_pool)
        x = xf.clone().requires_grad_(True)
        out, dropped = mod(fine.with_feats(x))
        require(int(dropped) == 0, f"pooling {backend}: dropped {int(dropped)}")
        out.feats.backward(gy_c)
        torch.cuda.synchronize()
        pooled[backend] = (out.feats.detach(), x.grad, mod.w.grad, mod.b.grad)
    same = compare(pooled[E.WINDOW], pooled[E.XLA])
    report["pooling_downsample"] = {"out_dx_dw_db_equal": same}
    require(all(same) and float(pooled[E.XLA][2].abs().sum()) > 0,
            f"pooling: window branch vs plain branch equal = {same}")
    del pooled

    # ---- the gather conv against the plain conv's autograd, level 0
    sbook = rb.build_submanifold_rulebook(fine, (3, 3, 3))
    w27 = ints((27, c_in, c_out))
    want = grads(lambda s, w: C.submanifold_conv(s, sbook, w), fine, xf, w27,
                 gy_f)
    got = grads(lambda s, w: GC.gather_submanifold_conv(s, sbook, w), fine, xf,
                w27, gy_f)
    same = compare(got, want)
    report["gather_conv"] = {"out_dx_dw_equal": same}
    require(all(same), f"gather conv vs plain conv equal = {same}")
    mirror = GC.mirror_permutation
    GC.mirror_permutation = lambda offsets: np.arange(len(offsets))
    try:
        got = grads(lambda s, w: GC.gather_submanifold_conv(s, sbook, w), fine,
                    xf, w27, gy_f)
    finally:
        GC.mirror_permutation = mirror
    same = compare(got, want)
    report["gather_conv_dx_both_permuted"] = {
        "out_dx_dw_equal": same,
        "max_abs_diff": float((got[1] - want[1]).abs().max())}
    require(same[0] and same[2] and not same[1],
            "the exact gather conv check is blind to dX with both permuted")
    emit(report)
    del want, got, xf, gy_f, gy_c, xc
    torch.cuda.empty_cache()

    # ---- ops_path: full width, bf16, forward and backward, counted
    bf16 = torch.bfloat16
    wrappers, plains = _kernel_counters()
    counted = wrappers + [K.window_gather, GC.gather_conv]
    plains = plains + [K.window_gather_plain, GC.gather_conv_plain]
    for f in counted:
        f.launches = 0
    for f in plains:
        f.calls = 0
    up = B.ConvolutionUpsample(64, 32, (2, 2, 2), ConvRepresentation(),
                               backend=E.WINDOW)
    init_parameters(up, SEED).to(dev).train()
    xc = torch.where(
        coarse.row_mask()[..., None],
        torch.randn((coarse.batch_size, coarse.capacity, 64), generator=gen,
                    device=dev), 0).to(bf16).requires_grad_(True)
    t0 = time.perf_counter()
    out, dropped = up(coarse.with_feats(xc), fine)
    out.feats.float().square().mean().backward()
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t0
    require(int(dropped) == 0, f"upsample block dropped {int(dropped)}")
    require(out.feats.shape == (fine.batch_size, fine.capacity, 32)
            and out.feats.dtype == bf16, "upsample block output shape")
    for name, t in (("out", out.feats), ("dx", xc.grad), ("dw", up.w.grad)):
        t = t.detach().float()
        require(bool(torch.isfinite(t).all()) and float(t.abs().sum()) > 0,
                f"upsample block {name} not finite or all 0")
    w = torch.nn.Parameter(
        torch.randn((27, 32, 32), generator=gen, device=dev) / (27 * 32) ** 0.5)
    xf = torch.where(
        fine.row_mask()[..., None],
        torch.randn((fine.batch_size, fine.capacity, 32), generator=gen,
                    device=dev), 0).to(bf16).requires_grad_(True)
    t0 = time.perf_counter()
    gout = GC.gather_submanifold_conv(fine.with_feats(xf), sbook, w)
    gout.feats.float().square().mean().backward()
    torch.cuda.synchronize()
    gather_s = time.perf_counter() - t0
    ref = C.submanifold_conv(fine.with_feats(xf.detach()), sbook, w.detach())
    err = float((gout.feats.detach().float() - ref.feats.float()).abs().max())
    # one bf16 rounding of sums of about 27 x 32 products of unit scale
    require(err <= 0.05, f"gather conv differs from the plain conv by {err}")
    for name, t in (("out", gout.feats), ("dx", xf.grad), ("dw", w.grad)):
        t = t.detach().float()
        require(bool(torch.isfinite(t).all()) and float(t.abs().sum()) > 0,
                f"gather conv {name} not finite or all 0")
    launches = {f.__name__: f.launches for f in counted}
    plain_calls = {f.__name__: f.calls for f in plains}
    require(launches == OPS_PATH_LAUNCHES,
            f"ops_path launch counts {launches} differ from the expected "
            f"{OPS_PATH_LAUNCHES}")
    require(all(v == 0 for v in plain_calls.values()),
            f"plain version called on the ops path: {plain_calls}")
    emit({"phase": "ops_path", "precision": "bfloat16", "launches": launches,
          "plain_calls": plain_calls, "upsample_block_s": up_s,
          "gather_conv_s": gather_s, "gather_conv_max_abs_diff": err})
    return launches


def train_config(extra=(), recipe="dune3d"):
    from sparseeventid_tpu_torch.config import load_config

    return load_config(recipe, [
        "mode=train", f"run.minibatch_size={BATCH}", f"run.seed={SEED}",
        "framework.sparse_backend=window", "data.mode=serial_access",
        f"output_dir={RUN_DIR}", *extra,
    ])


@contextlib.contextmanager
def plan_source(host: bool):
    """Plans built on the host (the default) or, with ``host`` False, on the
    device (SEID_HOST_PLANS=0) while the block runs."""
    before = os.environ.pop(HOST_PLANS_ENV, None)
    if not host:
        os.environ[HOST_PLANS_ENV] = "0"
    try:
        yield
    finally:
        os.environ.pop(HOST_PLANS_ENV, None)
        if before is not None:
            os.environ[HOST_PLANS_ENV] = before


def host_plans(model, image, grid, st):
    """The encoder's plans of one padded batch, built on the host and copied
    to ``st``'s device."""
    from sparseeventid_tpu_torch.train.plans import HostPlanner

    planner = HostPlanner(model.encoder, grid)
    return planner.plans(st, planner.to_device(planner.build(image), st.device))


# ---- the masked batch norm (csrc/masked_norm.cu): its kernel rows

NORM_LEVELS = ("series_0.block_0.conv1", "final_series.block_0.conv1")
NORM_BATCHES = (BATCH, 4 * BATCH)  # B = 32: the B = 8 batch's rows 4 times
NORM_SLOPE = 0.333  # the recipes' leakiness
NORM_ROWS = []  # every recipe's norm rows, for the last lines


def _norm_live(dataset, grid, recipe):
    """{label: (input shape, n_active)} of the batch norms at level 0 and at
    the deepest level, as a train-mode bf16 forward of the recipe's model
    on host plans hands them their input (one B = BATCH batch)."""
    import torch

    from sparseeventid_tpu_torch.models import build_sparse_classifier, init_parameters
    from sparseeventid_tpu_torch.train.evaluate import prepare_batch

    dev = torch.device(DEVICE)
    cfg = train_config(["run.precision=bfloat16"], recipe)
    model = init_parameters(build_sparse_classifier(cfg), SEED).to(dev)
    batch = dataset.batch([0])
    st, _ = prepare_batch(batch, grid, model.encoder.capacities[0],
                          torch.bfloat16, dev)
    seen, hooks = {}, []
    for path in NORM_LEVELS:
        norm = model.encoder.get_submodule(path).norm

        def grab(module, args, path=path):
            seen[path] = (args[0].shape, args[1].clone())

        hooks.append(norm.register_forward_pre_hook(grab))
    with torch.no_grad():
        model.train()(st, plans=host_plans(model, batch["image"], grid, st))
    for h in hooks:
        h.remove()
    depth = model.encoder.params.depth
    del model
    torch.cuda.empty_cache()
    return {label: seen[path] for label, path in
            zip(("L0", f"L{depth}"), NORM_LEVELS)}


def _norm_case(label, shape, n_active):
    """The four norm wrappers on real-valued bf16 features of ``shape``
    (``n_active`` live rows an event) against their plain versions (the
    output within one bf16 ulp of its scale, dx, dscale and doffset within
    1e-3 of their norms, the running averages within float32 rounding, the
    dead rows 0), twice for the same bits, then timed beside their bound
    (bytes / 3.35 TB/s), the plain versions and the library's batch norm
    over the packed live rows (its forward in training and its backward)
    -> one row a wrapper."""
    import torch

    from sparseeventid_tpu_torch.ops import norm_kernels as NK

    b, n, c = shape
    dev = n_active.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    live = NK.live_rows(n_active, n)[..., None]
    x = torch.where(live, torch.randn(shape, generator=gen, device=dev) * 1.7
                    + 0.4, 0.0).to(torch.bfloat16)
    dy = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    scale = torch.rand(c, generator=gen, device=dev) + 0.5
    offset = torch.randn(c, generator=gen, device=dev)
    rm = torch.randn(c, generator=gen, device=dev)
    rv = torch.rand(c, generator=gen, device=dev) + 0.5
    kw = dict(eps=1e-4, momentum=0.9, update=True, slope=NORM_SLOPE)

    def route(kernel):
        f = [getattr(NK, w if kernel else f"{w}_plain") for w in NORM_WRAPPERS]
        m, v = rm.clone(), rv.clone()
        stats = f[0](x, n_active)
        out, saved = f[1](x, n_active, stats, scale, offset, m, v, **kw)
        sums = f[2](dy, x, n_active, saved, scale, offset, slope=NORM_SLOPE)
        dx = f[3](dy, x, n_active, saved, scale, offset, sums,
                  slope=NORM_SLOPE, batch_stats=True)
        return stats, out, saved, sums, dx, m, v

    def rel(got, want):
        return float((got.float() - want.float()).norm()
                     / want.float().norm().clamp_min(1e-30))

    got, want, again = route(True), route(False), route(True)
    stats, out, saved, sums, dx, m, v = got
    top = float(want[1].float().abs().max())
    ulp = 2.0 ** (int(torch.tensor(top).log2().floor()) - 7)
    checks = {
        "out_max_abs_diff": float((out.float() - want[1].float()).abs().max()),
        "out_ulp": ulp,
        "dscale_rel": rel(sums[c:], want[3][c:]),
        "doffset_rel": rel(sums[:c], want[3][:c]),
        "dx_rel": rel(dx, want[4]),
        "stats_rel": rel(stats, want[0]),
        "running_max_abs_diff": max(float((m - want[5]).abs().max()),
                                    float((v - want[6]).abs().max())),
        "dead_rows_zero": not (out.masked_select(~live).any()
                               or dx.masked_select(~live).any()),
        "same_bits": all(torch.equal(a, b_) for a, b_ in zip(got, again)),
    }
    require(checks["out_max_abs_diff"] <= ulp
            and max(checks["dscale_rel"], checks["doffset_rel"],
                    checks["dx_rel"], checks["stats_rel"]) <= 1e-3
            and checks["running_max_abs_diff"] <= 1e-5
            and checks["dead_rows_zero"] and checks["same_bits"],
            f"norm kernels {label}: {checks}")

    n_live = int(n_active.clamp(0, n).sum())
    rows_bytes = b * n * c * x.element_size()
    live_bytes = n_live * c * x.element_size()
    nbytes_ = {"bn_stats": live_bytes, "bn_apply": live_bytes + rows_bytes,
               "bn_backward_reduce": 2 * live_bytes,
               "bn_backward_apply": 2 * live_bytes + rows_bytes}
    m, v = rm.clone(), rv.clone()
    calls = {
        "bn_stats": lambda f: f(x, n_active),
        "bn_apply": lambda f: f(x, n_active, stats, scale, offset, m, v, **kw),
        "bn_backward_reduce": lambda f: f(dy, x, n_active, saved, scale,
                                          offset, slope=NORM_SLOPE),
        "bn_backward_apply": lambda f: f(dy, x, n_active, saved, scale, offset,
                                         sums, slope=NORM_SLOPE,
                                         batch_stats=True),
    }
    # the library's batch norm over the packed live rows: its training
    # forward (statistics and apply) and its backward
    xl, gl = x[live[..., 0]], dy[live[..., 0]]
    lm, lv = rm.clone(), rv.clone()
    _, s_mean, s_invstd = torch.ops.aten.native_batch_norm(
        xl, scale, offset, lm, lv, True, 0.1, 1e-4)
    library = {
        "forward": timed_ms(lambda: torch.ops.aten.native_batch_norm(
            xl, scale, offset, lm, lv, True, 0.1, 1e-4)),
        "backward": timed_ms(lambda: torch.ops.aten.native_batch_norm_backward(
            gl, xl, scale, lm, lv, s_mean, s_invstd, True, 1e-4,
            [True, True, True])),
    }
    rows = []
    for w in NORM_WRAPPERS:
        kernel, plain = getattr(NK, w), getattr(NK, f"{w}_plain")
        bound_ms, bound_by = bound(nbytes_[w], 0)
        rows.append(dict(
            name=w, shape=label, batch=b, capacity=n, channels=c,
            live_rows=n_live, ms=timed_ms(lambda: calls[w](kernel)),
            bound_ms=bound_ms, bound_by=bound_by,
            plain_ms=timed_ms(lambda: calls[w](plain), iters=5, graph=False),
            library_pass="forward" if w in NORM_WRAPPERS[:2] else "backward",
            library_ms=library["forward" if w in NORM_WRAPPERS[:2]
                               else "backward"],
            **checks))
    return rows


def phase_norm_kernels(dataset, grid=GRID, recipe="dune3d"):
    """The norm kernel rows of a recipe: level 0 and the deepest level at
    B = 8 and B = 32 (dune2d: level 0 only, its planes in the batch)."""
    import torch

    shapes = _norm_live(dataset, grid, recipe)
    if recipe != "dune3d":
        shapes = {"L0": shapes["L0"]}
    for level, (shape, n_active) in shapes.items():
        for b in NORM_BATCHES:
            reps = b // BATCH
            label = f"{recipe} {level} B={b}"
            rows = _norm_case(label, (shape[0] * reps, *shape[1:]),
                              n_active.repeat(reps))
            for row in rows:
                emit({"phase": "norm_kernel", "recipe": recipe, **row})
            NORM_ROWS.extend(rows)
            torch.cuda.empty_cache()


def _kernel_counters():
    from sparseeventid_tpu_torch.ops import norm_kernels as NK
    from sparseeventid_tpu_torch.ops.window import kernels as K
    from sparseeventid_tpu_torch.ops.window import sidecar as S

    wrappers = [K.window_plan, K.window_conv_apply, K.overflow_apply,
                S.overflow_apply_batched, K.window_bwd_strided, K.window_dw,
                S.overflow_dw_batched, K.overflow_dw,
                *(getattr(NK, name) for name in NORM_WRAPPERS)]
    plains = [K.window_plan_plain, K.window_conv_apply_plain,
              K.overflow_apply_plain, K.window_bwd_strided_plain,
              K.window_dw_plain, K.overflow_dw_plain,
              *(getattr(NK, f"{name}_plain") for name in NORM_WRAPPERS)]
    return wrappers, plains


def phase_train(dataset, recipe="dune3d", grid=GRID, phase="train",
                host=True):
    """The train step at full width through the trainer's loop, on host
    plans (``host``) or on device plans (SEID_HOST_PLANS=0) -> the launch
    counts of the run.  The host-plan run also takes two backward passes of
    one batch (train_repeat)."""
    import numpy as np
    import torch

    from sparseeventid_tpu_torch.train.trainer import train

    # a run directory of its own: a train run resumes from the checkpoints
    # of an earlier one in its directory
    cfg = train_config(["run.precision=bfloat16", f"run.id={phase}",
                        f"mode.iterations={TRAIN_STEPS}"], recipe)
    require(cfg.head.dropout > 0, "the train phase runs with dropout on")
    wrappers, plains = _kernel_counters()
    for f in wrappers:
        f.launches = 0
    for f in plains:
        f.calls = 0
    torch.cuda.reset_peak_memory_stats()
    with plan_source(host):
        run = train(cfg, dataset=dataset, device=DEVICE)
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in wrappers}
    plain_calls = {f.__name__: f.calls for f in plains}
    history, state = run.history, run.state
    per_step = LAUNCHES_PER_TRAIN_STEP_HOST if host else LAUNCHES_PER_TRAIN_STEP
    require(len(history) == TRAIN_STEPS == state.step, "steps taken")
    for i, m in enumerate(history):
        require(np.isfinite(m["loss/loss"]), f"step {i}: loss not finite: {m}")
        require(m["overflow/dropped"] == 0, f"step {i}: dropped pairs: {m}")
    expected = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    require(launches == expected,
            f"launch counts {launches} differ from the expected {expected}")
    require(all(v == 0 for v in plain_calls.values()),
            f"plain version called on the train path: {plain_calls}")
    # every update moved Adam's moments by that step's gradient: a moment
    # that is finite shows finite gradients, one that is 0 everywhere a
    # gradient that was 0 at every step
    conv_weights, zero_grad, not_finite = 0, [], []
    for name, p in state.model.named_parameters():
        moments = state.optimizer.state[p]
        if not (torch.isfinite(moments["exp_avg"]).all()
                and torch.isfinite(moments["exp_avg_sq"]).all()
                and torch.isfinite(p).all()):
            not_finite.append(name)
        if p.dim() == 3:
            conv_weights += 1
            if float(moments["exp_avg_sq"].max()) == 0.0:
                zero_grad.append(name)
    require(not not_finite, f"gradient or parameter not finite: {not_finite}")
    require(conv_weights == 55 and not zero_grad,
            f"{conv_weights} conv weights, gradient 0 on {zero_grad}")
    stats = [(n, b) for n, b in state.model.named_buffers()]
    still = [n for n, b in stats
             if torch.equal(b, torch.zeros_like(b) if n.endswith("mean")
                            else torch.ones_like(b))]
    require(stats and not still, f"running statistics did not move: {still}")
    timed = [m["time/io_s"] + m["time/step_s"] for m in history[1:]]
    steps_per_s = len(timed) / sum(timed)
    emit({"phase": phase, "recipe": recipe, "steps": TRAIN_STEPS,
          "plans": "host" if host else "device",
          "io_s": [m["time/io_s"] for m in history],
          "step_s": [m["time/step_s"] for m in history],
          "loss": [m["loss/loss"] for m in history],
          "lr": [m["opt/lr"] for m in history],
          "launches": launches, "launches_per_step": per_step,
          "plain_calls": plain_calls, "conv_weights": conv_weights,
          "running_stats": len(stats),
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    print(json.dumps({f"{phase}_steps_per_s": steps_per_s,
                      f"{phase}_events_per_s": steps_per_s * BATCH,
                      "timed_steps": len(timed), "batch": BATCH,
                      "precision": "bfloat16"}), flush=True)
    STEPS_PER_S[phase] = steps_per_s
    profile_train_step(dataset, recipe, grid, phase, host)
    if host:
        gradients_repeat(dataset, recipe, grid, phase)
    return launches


def gradients_repeat(dataset, recipe="dune3d", grid=GRID, phase="train"):
    """Two backward passes of one bf16 batch on host plans from the same
    weights (and the same dropout draws): every conv weight's gradient must
    be the same bits on both.  Prints how many parameter gradients differ in
    any bit."""
    import torch

    from sparseeventid_tpu_torch.config.schema import OptimizerConfig
    from sparseeventid_tpu_torch.train.evaluate import (
        class_weights_of,
        feature_dtype,
        prepare_batch,
    )
    from sparseeventid_tpu_torch.train.losses import multi_head_loss
    from sparseeventid_tpu_torch.train.trainer import build_training

    cfg = train_config(["run.precision=bfloat16"], recipe)
    dev = torch.device(DEVICE)
    state, _, _ = build_training(cfg, N_BATCHES, None, dev)
    model = state.model
    scheme = (getattr(cfg.mode, "optimizer", None)
              or OptimizerConfig()).loss_balance_scheme
    weights = class_weights_of(scheme, dev)
    batch = dataset.batch([0])
    st, labels = prepare_batch(batch, grid, model.encoder.capacities[0],
                               feature_dtype(cfg), dev)
    plans = host_plans(model, batch["image"], grid, st)

    def gradients():
        model.zero_grad(set_to_none=True)
        model.train()
        gen = torch.Generator(device=dev).manual_seed(SEED + 2)
        logits, _ = model(st, gen, plans)
        loss, _ = multi_head_loss(logits, labels, scheme, weights)
        loss.backward()
        torch.cuda.synchronize()
        return {n: p.grad.detach().clone()
                for n, p in model.named_parameters() if p.grad is not None}

    first, second = gradients(), gradients()
    params = dict(model.named_parameters())
    differ = sorted(n for n in first if not torch.equal(first[n], second[n]))
    conv_differ = [n for n in differ if params[n].dim() == 3]
    conv_weights = sum(1 for p in params.values() if p.dim() == 3)
    emit({"phase": f"{phase}_repeat", "recipe": recipe,
          "gradients": len(first), "differ": len(differ),
          "differ_names": differ[:20], "conv_weights": conv_weights,
          "conv_weights_differ": len(conv_differ)})
    require(len(first) == len(params) and conv_weights == 55,
            f"{len(first)} gradients of {len(params)} parameters, "
            f"{conv_weights} conv weights")
    require(not conv_differ,
            f"conv weight gradients differ between two backward passes of one "
            f"batch: {conv_differ}")


def _device_profile(fn):
    """Run ``fn`` under torch.profiler -> (wall ms, device-busy ms, the 15
    kernels with the most device time, and the device time and launches of
    each kernel of csrc/ by function name, bf16 and fp32 instances merged)."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    port = {}
    for e in kernels:  # the port's kernels live in anonymous namespaces
        found = re.search(r"\(anonymous namespace\)::(\w+)", e.key)
        if found:
            # the backward's dX runs the conv kernels as seid::BwdDx
            name = found.group(1) + (" (dX)" if "BwdDx" in e.key else "")
            row = port.setdefault(name, {"ms": 0.0, "count": 0})
            row["ms"] += e.self_device_time_total / 1e3
            row["count"] += e.count
    return wall_ms, busy_ms, [
        {"name": e.key[:90], "ms": e.self_device_time_total / 1e3,
         "count": e.count} for e in top], port


def profile_train_step(dataset, recipe="dune3d", grid=GRID,
                       phase="train", host=True) -> None:
    """Device time by kernel over one bf16 train step (input preparation
    and the copy of the host plans included, as in the loop; the plans are
    built before, as the loader's thread builds them), and the share of the
    wall time the device was busy.  The step before it warms the new model
    up."""
    import torch

    from sparseeventid_tpu_torch.models import build_sparse_classifier
    from sparseeventid_tpu_torch.train.evaluate import feature_dtype, prepare_batch
    from sparseeventid_tpu_torch.train.plans import HostPlanner
    from sparseeventid_tpu_torch.train.trainer import build_training, host_plans_of

    cfg = train_config(["run.precision=bfloat16"], recipe)
    dev = torch.device(DEVICE)
    planner = (HostPlanner(build_sparse_classifier(cfg).encoder, grid)
               if host else None)
    state, step, _ = build_training(cfg, N_BATCHES, None, dev, planner)
    generator = torch.Generator(device=dev).manual_seed(SEED + 1)
    cap0 = state.model.encoder.capacities[0]
    batches = {}
    for first in (0, BATCH):
        batches[first] = dataset.batch([first])
        if host:
            batches[first] = planner.transform("train")(batches[first])

    def one_step(first):
        st, labels = prepare_batch(batches[first], grid, cap0,
                                   feature_dtype(cfg), dev)
        plans = host_plans_of(planner, batches[first], dev)
        return float(step(st, labels, generator, plans)["loss/loss"])

    one_step(0)
    wall_ms, busy_ms, top, port = _device_profile(lambda: one_step(BATCH))
    emit({"phase": f"profile_{phase}", "plans": "host" if host else "device",
          "wall_ms": wall_ms,
          "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
          "top_kernels": top, "port_kernels": port})


def profile_one_batch(cfg, dataset, grid=GRID, phase="profile") -> None:
    """Device time by kernel over one bf16 batch through validate() (on the
    plans of the caller's plan_source: validate builds host plans in its own
    thread, inside the profiled time), and the share of the wall time the
    device was busy."""
    from sparseeventid_tpu_torch.train.evaluate import validate

    one = CachedDataset(grid, {0: dataset.batch([0])}, BATCH)
    wall_ms, busy_ms, top, port = _device_profile(
        lambda: validate(cfg, dataset=one, device=DEVICE))
    emit({"phase": phase, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "device_busy_share": busy_ms / wall_ms, "top_kernels": top,
          "port_kernels": port})


HOST_BUILD_REPS = 3  # timed builds of each thread count


def phase_host_plans(dataset, recipe="dune3d", grid=GRID, phase="host_plans"):
    """The host plan builder on batch 0 at full width: build ms on 1 and 8
    threads and the host's core count, the pool's peak concurrency, plan
    cache miss and hit ms, the dict's MB and its copy to the card; for every
    plan its largest real-pair count an event against its width (0 dropped,
    the list dst-ordered), and how many (tile, offset) starts differ from
    the window_plan kernel's on the same site set; then every conv of the
    encoder (initial, series, strided forward and reverse) on host plans
    against device plans, output, dX and dW exactly equal on
    integer-valued fp32 data."""
    import numpy as np
    import torch

    from sparseeventid_tpu_torch.io import hostio
    from sparseeventid_tpu_torch.io.plan_cache import PlanCache
    from sparseeventid_tpu_torch.models import build_sparse_classifier
    from sparseeventid_tpu_torch.ops import engine as E
    from sparseeventid_tpu_torch.ops.window import engine as WE
    from sparseeventid_tpu_torch.ops.window.kernels import (
        _ov_bound,
        overflow_dst_ordered,
    )
    from sparseeventid_tpu_torch.train.evaluate import prepare_batch
    from sparseeventid_tpu_torch.train.plans import (
        HostPlanner,
        grown_widths,
        plan_coords,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE)
    encoder = build_sparse_classifier(
        train_config(["run.precision=float32"], recipe)).encoder
    planner = HostPlanner(encoder, grid)
    batch = dataset.batch([0])
    coords = plan_coords(batch["image"], grid)

    def build_ms(threads):
        os.environ["SEID_PLAN_THREADS"] = str(threads)
        try:
            host = hostio.build_window_plans(coords, **planner.geometry)
            hostio.plan_pool_peak_concurrency()
            t0 = time.perf_counter()
            for _ in range(HOST_BUILD_REPS):
                hostio.build_window_plans(coords, **planner.geometry)
            ms = (time.perf_counter() - t0) / HOST_BUILD_REPS * 1e3
            return ms, hostio.plan_pool_peak_concurrency(), host
        finally:
            os.environ.pop("SEID_PLAN_THREADS", None)

    ms_1, peak_1, serial = build_ms(1)
    ms_8, peak_8, host = build_ms(8)
    require(all(np.array_equal(serial[k], host[k]) for k in host),
            f"{recipe}: 8 plan threads differ from 1")
    require(peak_1 == 1 and peak_8 > 1,
            f"{recipe}: plan pool peak concurrency {peak_1} / {peak_8}")
    cache = PlanCache(planner.build_coords, max_bytes=1 << 34)
    t0 = time.perf_counter()
    cache.plans_for("train", coords, batch["index"])
    miss_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    cached = cache.plans_for("train", coords, batch["index"])
    hit_ms = (time.perf_counter() - t0) * 1e3
    require(cache.hits == BATCH and all(np.array_equal(cached[k], host[k])
                                        for k in host),
            f"{recipe}: the cached plans differ from a build")
    planner.to_device(host, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_BUILD_REPS):
        host_t = planner.to_device(host, dev)
    torch.cuda.synchronize()
    copy_ms = (time.perf_counter() - t0) / HOST_BUILD_REPS * 1e3
    st0, _ = prepare_batch(batch, grid, encoder.capacities[0], torch.float32, dev)
    plans = planner.plans(st0, host_t)
    require(int(plans.site_dropped) == 0, f"{recipe}: host sites dropped")

    lists = {}
    for key in host:
        if not key.endswith("/ov_valid"):
            continue
        prefix = key[:-len("/ov_valid")]
        pairs = host[key].sum(axis=1)
        dropped = int(host[f"{prefix}/ov_dropped"].sum())
        ordered = overflow_dst_ordered(host_t[f"{prefix}/ov_dst"],
                                       _ov_bound(host_t[key]))
        lists[prefix] = {"max_pairs": int(pairs.max()), "pairs": int(pairs.sum()),
                         "width": int(host[key].shape[1]), "dropped": dropped,
                         "dst_ordered": ordered}
        require(dropped == 0, f"{recipe} {prefix}: host list dropped {dropped}")
        require(ordered, f"{recipe} {prefix}: host list not dst-ordered")
    # the other batches at the JAX widths: the largest list of any, and
    # whether the planner would widen one (it never drops a pair)
    widened = []
    for first in range(BATCH, len(dataset), BATCH):
        other = hostio.build_window_plans(
            plan_coords(dataset.batch([first])["image"], grid),
            **planner.geometry)
        widened.append(grown_widths(other, planner.geometry) is not None)
        for prefix, row in lists.items():
            row["max_pairs_all_batches"] = max(
                row.get("max_pairs_all_batches", row["max_pairs"]),
                int((other[f"{prefix}/ov_valid"].sum(axis=1)
                     + other[f"{prefix}/ov_dropped"]).max()))

    # every conv on host and on device plans, integer-valued fp32 data
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    ik, sks, stride = encoder.plan_kernels()
    tuning, caps = encoder.tuning, encoder.capacities
    width = 32

    def ints(shape, st):
        return _int_like(shape, gen, dev, torch.float32) * st.row_mask()[..., None]

    def grads(conv, st, x0, w0, gy):
        x = x0.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        out = conv(st.with_feats(x), w).feats
        out.backward(gy)
        return out.detach(), x.grad, w.grad

    convs, starts = {}, {}

    def check(name, st, host_conv, dev_conv, host_plan, dev_plans, c_in, k,
              out_st):
        x0, w0 = ints((st.batch_size, st.capacity, c_in), st), _int_like(
            (k, c_in, width), gen, dev, torch.float32)
        gy = ints((out_st.batch_size, out_st.capacity, width), out_st)
        a = grads(host_conv, st, x0, w0, gy)
        b = grads(dev_conv, st, x0, w0, gy)
        same = [torch.equal(u, v) for u, v in zip(a, b)]
        convs[name] = dict(zip(("out", "dx", "dw"), same))
        require(all(same), f"{recipe} {name}: host and device plans give "
                f"other out, dx, dw: {same}")
        require(float(a[2].abs().sum()) > 0, f"{recipe} {name}: dw all 0")
        for hp, dp, label in zip(host_plan, dev_plans, ("", " reverse")):
            starts[name + label] = {
                "differ": int((hp.start != dp.start).sum()),
                "entries": int(hp.start.numel())}

    plan = E.build_series_plan(st0, ik, backend=E.WINDOW,
                               q_bound_frac=encoder._qb_frac(0),
                               window_r=tuning.window_r_initial)
    check("initial", st0,
          lambda s, w: WE.window_submanifold_conv(s, plans.initial, w),
          lambda s, w: WE.window_submanifold_conv(s, plan, w),
          (plans.initial,), (plan,), 1, len(plan.offsets), st0)
    st = st0
    for l in range(len(caps)):
        plan = E.build_series_plan(st, sks[l], backend=E.WINDOW,
                                   q_bound_frac=encoder._qb_frac(l),
                                   window_r=tuning.for_level(l))
        hp = plans.series[l]
        check(f"L{l} series", st,
              lambda s, w: WE.window_submanifold_conv(s, hp, w),
              lambda s, w: WE.window_submanifold_conv(s, plan, w),
              (hp,), (plan,), width, len(plan.offsets), st)
        if l == len(caps) - 1:
            break
        skel, (fwd, rev), dropped = E.build_downsample_plan(
            st, stride, caps[l + 1], backend=E.WINDOW,
            q_bound_frac_in=encoder._qb_frac(l),
            q_bound_frac_out=encoder._qb_frac(l + 1), tuning=tuning)
        hskel, (hfwd, hrev) = plans.skeletons[l], plans.down[l]
        require(int(dropped.sum()) == 0
                and torch.equal(hskel.coords, skel.coords)
                and torch.equal(hskel.n_active, skel.n_active),
                f"{recipe} L{l}: the host skeleton differs from downsample_sites")
        check(f"L{l} down", st,
              lambda s, w: WE.window_strided_conv(s, hskel, hfwd, hrev, w),
              lambda s, w: WE.window_strided_conv(s, skel, fwd, rev, w),
              (hfwd, hrev), (fwd, rev), width, len(fwd.offsets), skel)
        st = skel
    torch.cuda.synchronize()
    emit({"phase": phase, "recipe": recipe, "host_cpus": os.cpu_count(),
          "build_ms_1_thread": ms_1, "build_ms_8_threads": ms_8,
          "peak_concurrency": peak_8, "cache_miss_ms": miss_ms,
          "cache_hit_ms": hit_ms,
          "dict_mb": sum(v.nbytes for v in host.values()) / 2**20,
          "copy_ms": copy_ms, "widened_batches": widened, "lists": lists,
          "starts": starts, "convs": convs})


def phase_main(dataset, out_dir: Path, recipe="dune3d", grid=GRID,
               phase="main", host=True):
    """Inference at full width through validate(), on host plans
    (``host``) or on device plans (SEID_HOST_PLANS=0) -> the launch counts
    of the run; then a profiled batch."""
    import numpy as np
    import torch

    from sparseeventid_tpu_torch.config import load_config
    from sparseeventid_tpu_torch.config.schema import OUTPUT_SHAPE
    from sparseeventid_tpu_torch.train.evaluate import validate

    out_file = out_dir / f"chip_smoke_softmax_{recipe}.npz"
    cfg = load_config(recipe, [
        "mode=inference", "run.precision=bfloat16",
        f"run.minibatch_size={BATCH}", "framework.sparse_backend=window",
        f"run.seed={SEED}", f"mode.output_file={out_file}",
        f"output_dir={RUN_DIR}", f"run.id={phase}",
    ])
    wrappers, plains = _kernel_counters()
    # warm-up on the first batch (allocator, cuBLAS handles), then the run
    warm = CachedDataset(grid, {0: dataset.batch([0])}, BATCH)
    with plan_source(host):
        validate(cfg, dataset=warm, device=DEVICE)
        for f in wrappers:
            f.launches = 0
        for f in plains:
            f.calls = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics = validate(cfg, dataset=dataset, device=DEVICE)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in wrappers}
    plain_calls = {f.__name__: f.calls for f in plains}
    require(np.isfinite(metrics["loss/loss"]), f"loss not finite: {metrics}")
    require(metrics["overflow/dropped"] == 0, f"dropped pairs: {metrics}")
    # inference launches every forward kernel and no backward one; on host
    # plans no plan kernel
    per_forward = LAUNCHES_PER_FORWARD_HOST if host else LAUNCHES_PER_FORWARD
    expected = {k: v * N_BATCHES for k, v in per_forward.items()}
    require({k: launches[k] for k in expected} == expected
            and all(v == 0 for k, v in launches.items() if k not in expected),
            f"launch counts of the inference path {launches}, expected {expected}")
    require(all(v == 0 for v in plain_calls.values()),
            f"plain version called on the main path: {plain_calls}")
    soft = np.load(out_file)
    for k, n in OUTPUT_SHAPE.items():
        require(soft[k].shape == (BATCH * N_BATCHES, n), f"softmax {k} shape")
        require(np.all(np.isfinite(soft[k])), f"softmax {k} not finite")
    events = BATCH * N_BATCHES
    print(json.dumps({f"{phase}_events_per_s": events / seconds,
                      "events": events, "batch": BATCH,
                      "precision": "bfloat16"}), flush=True)
    emit({"phase": phase, "recipe": recipe, "plans": "host" if host else "device",
          "events": events, "seconds": seconds,
          "events_per_s": events / seconds, "metrics": metrics,
          "launches": launches, "launches_per_forward":
          {k: v / N_BATCHES for k, v in launches.items() if v},
          "plain_calls": plain_calls,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})

    with plan_source(host):
        profile_one_batch(cfg, dataset, grid,
                          "profile" if phase == "main" else f"profile_{phase}")
    return launches


# fp32 agreement of the window kernels with the plain rulebook backend.
# At random init the eval-mode norms are identities and the final series'
# features reach ~1e3, so their check scales atol with the reference's
# magnitude; the logits (a pool over the grid volume, then the heads) are
# ~1e-2 and keep the absolute atol.  Planted faults show where the limits
# sit: a fault must fail the feature check.
FP32_RTOL = 1e-3
FP32_ATOL_LOGITS = 1e-3
FP32_ATOL_FEATS_PER_SCALE = 1e-3


def phase_fp32(dataset) -> None:
    import torch

    from sparseeventid_tpu_torch.config import load_config
    from sparseeventid_tpu_torch.config.schema import OUTPUT_SHAPE
    from sparseeventid_tpu_torch.io import larcv_batch_to_sparse_3d
    from sparseeventid_tpu_torch.models import build_sparse_classifier, init_parameters
    from sparseeventid_tpu_torch.ops.window import engine as WE

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    image = dataset.batch([0])["image"]

    def model_of(backend):
        c32 = load_config("dune3d", [
            "mode=inference", "run.precision=float32",
            f"framework.sparse_backend={backend}",
        ])
        return init_parameters(build_sparse_classifier(c32), SEED).to(DEVICE).eval()

    def forward(model, what):
        st = larcv_batch_to_sparse_3d(image, GRID,
                                      capacity=model.encoder.capacities[0],
                                      device=DEVICE)
        got = {}
        hook = model.encoder.final_series.register_forward_hook(
            lambda mod, inp, out: got.__setitem__("feats", out.feats.cpu())
        )
        # the window model on host plans, as the main path runs it
        plans = (host_plans(model, image, GRID, st)
                 if model.encoder.backend == "window" else None)
        with torch.no_grad():
            lg, dropped = model(st, plans=plans)
        hook.remove()
        require(int(dropped) == 0, f"{what}: dropped {int(dropped)}")
        return got["feats"], torch.cat([lg[k] for k in OUTPUT_SHAPE], dim=1).cpu()

    ref_feats, ref_logits = forward(model_of("xla"), "xla")
    scale = ref_feats.abs().max().item()
    limits = {"final_series_feats": FP32_ATOL_FEATS_PER_SCALE * scale,
              "logits": FP32_ATOL_LOGITS}

    def compare(feats, logits):
        row = {}
        for what, a, b in (("final_series_feats", feats, ref_feats),
                           ("logits", logits, ref_logits)):
            row[what] = {"max_abs_diff": (a - b).abs().max().item(),
                         "max_abs": b.abs().max().item(),
                         "atol": limits[what],
                         "within": torch.allclose(a, b, rtol=FP32_RTOL,
                                                  atol=limits[what])}
        return row

    window = model_of("window")
    report = {"phase": "fp32_compare", "plans": "host", "rtol": FP32_RTOL,
              "sound": compare(*forward(window, "window"))}
    for what, row in report["sound"].items():
        require(row["within"], f"fp32 {what} differ: {row}")

    # planted faults: out-of-window pairs lost, or counted twice (what a
    # conv that ignored its window would do)
    apply = WE._apply_overflow
    faults = {
        "sidecar_skipped": lambda out, table, w, plan: out,
        "sidecar_twice": lambda out, table, w, plan: apply(
            apply(out, table, w, plan), table, w, plan),
    }
    for fault, patched in faults.items():
        WE._apply_overflow = patched
        try:
            report[fault] = compare(*forward(window, fault))
        finally:
            WE._apply_overflow = apply
        require(not report[fault]["final_series_feats"]["within"],
                f"fp32 check blind to the planted fault {fault}: {report[fault]}")
    emit(report)


# fp32 agreement of one train step's parameter gradients, window kernels
# against the plain rulebook backend: per tensor, the L2 norm of the
# difference over the L2 norm of the reference gradient, and the worst
# tensor decides.  The conv biases ahead of a batch norm are left out: their
# true gradient is 0 and both backends return rounding noise (1e-11 of the
# largest gradient).  At random init the backward passes 53 batch norms in
# train mode, each a cancellation, so float32 summation order alone moves a
# tensor's gradient by several 1e-3 of its norm (the plain backend does not
# repeat its own gradients bit for bit either: its gather's backward adds
# atomically); the planted faults move it by 0.2 and more.
FP32_GRAD_LIMIT = 0.04


def phase_fp32_grad(dataset) -> None:
    import numpy as np
    import torch

    from sparseeventid_tpu_torch.models import build_sparse_classifier, init_parameters
    from sparseeventid_tpu_torch.ops.window import engine as WE
    from sparseeventid_tpu_torch.scripts import grad_gap
    from sparseeventid_tpu_torch.train.plans import HostPlanner

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    batch = {k: v[:FP32_GRAD_EVENTS] for k, v in dataset.batch([0]).items()}

    def model_of(backend):
        cfg = train_config(["run.precision=float32", "head.dropout=0.0",
                            f"framework.sparse_backend={backend}"])
        model = init_parameters(build_sparse_classifier(cfg), SEED)
        return cfg, model.to(dev).train()

    in_backward = {"on": False}  # read by the twin-list fault below

    def backward(loss):
        in_backward["on"] = True
        try:
            loss.backward()
        finally:
            in_backward["on"] = False

    def gradients(cfg, model, what):
        # the window model on host plans, as the main path runs it
        planner = (HostPlanner(model.encoder, GRID)
                   if model.encoder.backend == "window" else None)
        loss, dropped, grads = grad_gap.step_gradients(
            model, cfg, batch, GRID, dev, planner, backward)
        require(dropped == 0, f"{what}: dropped {dropped}")
        require(np.isfinite(loss), f"{what}: loss {loss}")
        return loss, grads

    cfg_x, model_x = model_of("xla")
    ref_loss, ref = gradients(cfg_x, model_x, "xla")
    del model_x
    torch.cuda.empty_cache()
    compared = [n for n in ref if not n.endswith(".b")]
    require(all(float(ref[n].norm()) > 0 for n in compared),
            "a reference gradient is all 0")

    def compare(loss, grads):
        rel = grad_gap.rel_l2(grads, ref)
        worst_name = max(rel, key=rel.get)
        worst_max = max(float((grads[n] - ref[n]).abs().max())
                        / float(ref[n].abs().max()) for n in rel)
        return {"loss": loss, "worst_rel_l2": rel[worst_name],
                "worst_tensor": worst_name, "worst_rel_max_abs": worst_max,
                "within": rel[worst_name] <= FP32_GRAD_LIMIT}

    cfg_w, model_w = model_of("window")
    report = {"phase": "fp32_grad_compare", "plans": "host",
              "events": FP32_GRAD_EVENTS,
              "limit": FP32_GRAD_LIMIT, "tensors": len(compared),
              "tensors_left_out": len(ref) - len(compared), "ref_loss": ref_loss,
              "sound": compare(*gradients(cfg_w, model_w, "window"))}

    # the twin-list fault breaks the dX sidecar of the series convs only in
    # the backward: the forward's calls of the same function stay sound
    faults = {
        "dw_sidecar_skipped": ("_overflow_dw", _no_dw_sidecar),
        "twin_list_transposed": ("_apply_overflow", _swap_dx_list(
            WE._apply_overflow,
            lambda out, table, p: in_backward["on"] and len(p.offsets) == 27)),
    }

    def run_fault(fault):
        attr, patched = faults[fault]
        sound = getattr(WE, attr)
        setattr(WE, attr, patched)
        try:
            return gradients(cfg_w, model_w, fault)
        finally:
            setattr(WE, attr, sound)

    for fault in faults:
        report[fault] = compare(*run_fault(fault))
    emit(report)
    require(report["sound"]["within"], f"fp32 gradients differ: {report['sound']}")
    for fault in faults:
        require(not report[fault]["within"],
                f"fp32 gradient check blind to the planted fault {fault}: "
                f"{report[fault]}")


@contextlib.contextmanager
def captured_train_runs():
    """Keep the TrainRun of each train() that main() makes while the block
    runs (main returns only the last step's metrics) -> the list of them."""
    from sparseeventid_tpu_torch.train import trainer

    runs, train = [], trainer.train

    def keep(*args, **kwargs):
        run = train(*args, **kwargs)
        runs.append(run)
        return run

    trainer.train = keep
    try:
        yield runs
    finally:
        trainer.train = train
        runs.clear()


def campaign_assembly(dataset) -> None:
    """Campaign step 1: the events of one dune3d batch as linear ids and
    values through the native assembler and its numpy version."""
    import numpy as np

    from sparseeventid_tpu_torch.io import hostio

    image = dataset.batch([0])["image"]
    events = []
    for ev in image:
        live = ev[ev[:, 3] != -999.0]
        c = live[:, :3].astype(np.uint64)
        ids = (c[:, 0] * GRID[1] + c[:, 1]) * GRID[2] + c[:, 2]
        events.append((ids, live[:, 3].copy()))
    native, threads = hostio.assemble_native(events, MAX_VOXELS, GRID)
    plain = hostio._assemble_numpy(events, MAX_VOXELS, GRID, True, False,
                                   0.05, None, 0)
    require(np.array_equal(native[..., :3], plain[..., :3]),
            "native assembly: coordinates or padding differ from numpy")
    require(np.array_equal(native[..., 3] == -999.0, plain[..., 3] == -999.0),
            "native assembly: padding differs from numpy")
    err = float(np.abs(native[..., 3] - plain[..., 3]).max())
    require(err <= 1e-5, f"native assembly: values differ by {err} (> 1e-5)")

    def per_batch_ms(fn, reps=5):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3

    native_ms = per_batch_ms(
        lambda: hostio.assemble_native(events, MAX_VOXELS, GRID))
    numpy_ms = per_batch_ms(
        lambda: hostio._assemble_numpy(events, MAX_VOXELS, GRID, True, False,
                                       0.05, None, 0))
    emit({"phase": "campaign_assembly", "events": len(events),
          "voxels": [len(i) for i, _ in events], "threads": threads,
          "native_ms": native_ms, "numpy_ms": numpy_ms,
          "max_abs_err": err})


def phase_campaign(dataset) -> None:
    """The slice's path: a dune3d training campaign at full width through
    the command line (B=8, bf16, depth 5, 24 synthetic events, prefetching
    loaders): train with a validation batch and checkpoints, a restore held
    against the trained state, auto-resume, inference from the checkpoint,
    encoder-only transfer; then the larcv file path where h5py imports."""
    campaign_assembly(dataset)
    out = RUN_DIR / "campaign"
    base = ["--config-name", "dune3d", "run.precision=bfloat16",
            f"run.minibatch_size={BATCH}", f"run.seed={SEED}",
            "framework.sparse_backend=window", "data.mode=serial_access",
            "data.train=synthetic", "data.val=synthetic",
            f"data.synthetic_events={CAMPAIGN_EVENTS}", f"output_dir={out}"]
    with captured_train_runs() as runs:
        cfg = campaign_runs(base + CAMPAIGN_OVERRIDES, runs,
                            out / "dune3d" / "debug" / "checkpoints")
    campaign_larcv(base + CAMPAIGN_OVERRIDES, cfg)


def campaign_runs(base, runs, ckpt_dir):
    """Campaign steps 2-6 -> the train config."""
    import numpy as np
    import torch

    from sparseeventid_tpu_torch.__main__ import main as cli
    from sparseeventid_tpu_torch.config import load_config
    from sparseeventid_tpu_torch.config.schema import OptimizerConfig
    from sparseeventid_tpu_torch.models import build_sparse_classifier, init_parameters
    from sparseeventid_tpu_torch.train.evaluate import (
        build_dataset,
        class_weights_of,
        feature_dtype,
        prepare_batch,
        validate,
    )
    from sparseeventid_tpu_torch.train.supervised import make_train_step
    from sparseeventid_tpu_torch.train.trainer import build_training, step_generator
    from sparseeventid_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        load_checkpoint,
    )

    dev = torch.device(DEVICE)
    wrappers, _ = _kernel_counters()

    def drive(args):
        for f in wrappers:
            f.launches = 0
        metrics = cli(base + args)
        torch.cuda.synchronize()
        return metrics, {f.__name__: f.launches for f in wrappers}

    # 2. train: 4 steps, a checkpoint every 2, a validation batch at step 0
    _, launches = drive(["mode=train", "mode.iterations=4",
                         "mode.checkpoint_iteration=2"])
    run = runs[-1]
    index = (ckpt_dir / "checkpoint").read_text().splitlines()
    require(index == ["latest: step_4.pt", "step: step_2.pt", "step: step_4.pt"],
            f"checkpoint index after 4 steps: {index}")
    require(list(run.validation) == [0], f"validation at {list(run.validation)}")
    for i, m in enumerate([*run.history, run.validation[0]]):
        require(np.isfinite(m["loss/loss"]) and m["overflow/dropped"] == 0,
                f"campaign train: loss or dropped pairs: {m}")
    expected = {k: 4 * LAUNCHES_PER_TRAIN_STEP_HOST[k] + LAUNCHES_PER_FORWARD_HOST[k]
                for k in LAUNCHES_PER_TRAIN_STEP_HOST}
    require(launches == expected,
            f"campaign train launches {launches}, expected {expected}")
    emit({"phase": "campaign_train", "steps": len(run.history),
          "io_ms": [m["time/io_s"] * 1e3 for m in run.history],
          "step_ms": [m["time/step_s"] * 1e3 for m in run.history],
          "loss": [m["loss/loss"] for m in run.history],
          "val_loss": run.validation[0]["loss/loss"], "launches": launches,
          "index": index, "checkpoint_bytes": (ckpt_dir / "step_4.pt").stat().st_size})

    # 3. restore step 4 into a fresh state: the same bits, and one more step
    # from each on the same batch gives the same parameters
    cfg = load_config("dune3d", base[2:] + ["mode=train"])
    fresh, _, _ = build_training(cfg, CAMPAIGN_EVENTS // BATCH, None, dev)
    t0 = time.perf_counter()
    CheckpointManager(ckpt_dir).restore(fresh, dev, step=4)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    trained = run.state
    require(fresh.step == trained.step == 4, f"restored step {fresh.step}")
    want = trained.model.state_dict()
    differ = [k for k, v in fresh.model.state_dict().items()
              if not torch.equal(v, want[k])]
    opt_a, opt_b = fresh.optimizer.state_dict(), trained.optimizer.state_dict()
    require(opt_a["param_groups"] == opt_b["param_groups"],
            "restored AdamW parameter groups differ")
    for i, st in opt_b["state"].items():
        for k, v in st.items():
            if not torch.equal(opt_a["state"][i][k].cpu(), v.cpu()):
                differ.append(f"optimizer {i} {k}")
    require(fresh.scheduler.state_dict() == trained.scheduler.state_dict(),
            "restored schedule state differs")
    require(not differ, f"restored state differs: {differ[:10]}")
    scheme = (getattr(cfg.mode, "optimizer", None)
              or OptimizerConfig()).loss_balance_scheme
    weights = class_weights_of(scheme, dev)
    batch = build_dataset(cfg, "train").batch(list(range(BATCH)))
    for state in (fresh, trained):
        st, labels = prepare_batch(batch, GRID, state.model.encoder.capacities[0],
                                   feature_dtype(cfg), dev)
        make_train_step(state, scheme, None, weights)(
            st, labels, step_generator(SEED, 4, dev))
    torch.cuda.synchronize()
    after = dict(trained.model.named_parameters())
    moved_apart = [n for n, p in fresh.model.named_parameters()
                   if not torch.equal(p, after[n])]
    require(not moved_apart,
            f"one step after the restore differs: {moved_apart[:10]}")
    probe = CheckpointManager(RUN_DIR / "campaign_probe")
    t0 = time.perf_counter()
    saved = probe.save(fresh)
    save_ms = (time.perf_counter() - t0) * 1e3
    emit({"phase": "campaign_restore", "tensors": len(want),
          "optimizer_states": len(opt_b["state"]), "restore_ms": restore_ms,
          "save_ms": save_ms, "checkpoint_bytes": saved.stat().st_size,
          "step_after_restore_equal": True})
    del fresh, trained, run

    # 4. auto-resume: from step 4 to 6
    _, _ = drive(["mode=train", "mode.iterations=6"])
    resumed = runs[-1]
    require(resumed.first_step == 4 and len(resumed.history) == 2
            and resumed.state.step == 6,
            f"resume: first step {resumed.first_step}, "
            f"{len(resumed.history)} steps, ends at {resumed.state.step}")
    index = (ckpt_dir / "checkpoint").read_text().splitlines()
    require(index[0] == "latest: step_6.pt" and (ckpt_dir / "step_6.pt").exists(),
            f"checkpoint index after resume: {index}")
    emit({"phase": "campaign_resume", "first_step": resumed.first_step,
          "steps": len(resumed.history), "index": index,
          "io_ms": [m["time/io_s"] * 1e3 for m in resumed.history],
          "step_ms": [m["time/step_s"] * 1e3 for m in resumed.history]})
    del resumed

    # 5. inference auto-resumes step 6: the same metrics as validate() given
    # step 6's weights, bit for bit
    cli_metrics, launches = drive(["mode=inference"])
    sd6 = load_checkpoint(ckpt_dir / "step_6.pt", dev)["model"]
    in_process = validate(load_config("dune3d", base[2:] + ["mode=inference"]),
                          params=sd6, device=DEVICE)
    require(cli_metrics == in_process,
            f"inference from the checkpoint {cli_metrics} != validate {in_process}")
    n_batches = CAMPAIGN_EVENTS // BATCH
    require(launches == {k: n_batches * v
                         for k, v in LAUNCHES_PER_FORWARD_HOST.items()},
            f"campaign inference launches {launches}")
    emit({"phase": "campaign_inference", "metrics": cli_metrics,
          "launches": launches})

    # 6. encoder-only transfer from step 4, encoder frozen
    step4 = load_checkpoint(ckpt_dir / "step_4.pt", dev)["model"]
    _, launches = drive(["mode=train", "mode.iterations=2", "run.id=transfer",
                         f"mode.weights_location={ckpt_dir / 'step_4.pt'}",
                         "mode.restore_encoder_only=true"])
    transfer = runs[-1]
    init = init_parameters(build_sparse_classifier(cfg), SEED).to(dev)
    start = init.state_dict()
    final = transfer.state.model.state_dict()
    params = dict(transfer.state.model.named_parameters())
    enc = [n for n in params if n.startswith("encoder.")]
    head = [n for n in params if not n.startswith("encoder.")]
    require(all(torch.equal(final[n], step4[n]) for n in enc),
            "transfer moved the frozen encoder")
    require(all(not params[n].requires_grad for n in enc),
            "transfer left an encoder parameter trainable")
    still = [n for n in head if torch.equal(final[n], start[n])]
    require(not still, f"head parameters that did not move: {still}")
    stats = [n for n, _ in transfer.state.model.named_buffers()
             if n.startswith("encoder.")]
    stuck = [n for n in stats if torch.equal(final[n], start[n])]
    require(stats and not stuck,
            f"encoder running statistics that did not move: {stuck[:10]}")
    # two train steps (the frozen encoder's norms take the batch's
    # statistics and move the running averages) and a validation batch
    expected = {k: 3 * v for k, v in LAUNCHES_PER_FORWARD_HOST.items()}
    expected["bn_stats"] = 2 * BATCH_NORMS
    require(launches == expected,
            f"transfer launches {launches}, expected {expected}: a frozen "
            "encoder launches no backward kernel")
    require(all(np.isfinite(m["loss/loss"]) for m in transfer.history),
            "transfer loss not finite")
    emit({"phase": "campaign_transfer", "frozen": len(enc), "trained": len(head),
          "encoder_stats_moved": len(stats), "launches": launches,
          "backward_launches": {k: launches[k] for k in BACKWARD_KERNELS},
          "loss": [m["loss/loss"] for m in transfer.history]})
    return cfg


def campaign_larcv(base, cfg) -> None:
    """Campaign step 7: a dune3d larcv file written by the port, read back
    against the synthetic split it was written from, then inference and
    iotest on it.  Needs h5py: without it, says so and returns."""
    import zlib

    import numpy as np

    try:
        import h5py
    except ModuleNotFoundError:
        emit({"phase": "campaign_larcv", "h5py": False})
        return
    from sparseeventid_tpu_torch.__main__ import main as cli
    from sparseeventid_tpu_torch.config.schema import OUTPUT_SHAPE
    from sparseeventid_tpu_torch.io.larcv import LarcvDataset, write_synthetic_larcv_file
    from sparseeventid_tpu_torch.train.evaluate import build_dataset

    path = RUN_DIR / "campaign_val.h5"
    t0 = time.perf_counter()
    write_synthetic_larcv_file(
        path, CAMPAIGN_EVENTS, image_size=GRID, max_voxels=cfg.data.max_voxels,
        seed=(zlib.crc32(b"val") + SEED) % 2**31)
    write_s = time.perf_counter() - t0
    larcv = LarcvDataset(path, "dunevoxels", max_voxels=cfg.data.max_voxels,
                         image_size=GRID)
    route = larcv.read_route
    synthetic = build_dataset(cfg, "val")
    err = 0.0
    for first in range(0, CAMPAIGN_EVENTS, BATCH):
        idx = list(range(first, first + BATCH))
        a, b = larcv.batch(idx), synthetic.batch(idx)
        require(np.array_equal(a["image"][..., :3], b["image"][..., :3]),
                f"larcv batch {first}: coordinates differ from the synthetic split")
        for k in OUTPUT_SHAPE:
            require(np.array_equal(a[k], b[k]), f"larcv batch {first}: {k} differs")
        err = max(err, float(np.abs(a["image"][..., 3] - b["image"][..., 3]).max()))
    require(err <= 1e-5, f"larcv values differ by {err} from the synthetic split")
    t0 = time.perf_counter()
    for first in range(0, CAMPAIGN_EVENTS, BATCH):
        larcv.batch(list(range(first, first + BATCH)))
    batch_ms = (time.perf_counter() - t0) / (CAMPAIGN_EVENTS // BATCH) * 1e3
    larcv.close()
    out_file = RUN_DIR / "campaign_softmax.h5"
    metrics = cli(base + ["mode=inference", f"data.val={path}",
                          f"mode.output_file={out_file}"])
    require(np.isfinite(metrics["loss/loss"]) and metrics["overflow/dropped"] == 0,
            f"larcv inference: {metrics}")
    with h5py.File(out_file, "r") as f:
        for k, n in OUTPUT_SHAPE.items():
            scores = f[f"Data/softmax_{k}_group/scores"][:]
            require(scores.shape == (CAMPAIGN_EVENTS, n)
                    and np.all(np.isfinite(scores)), f"softmax {k}: {scores.shape}")
    io = cli(base + ["mode=iotest", f"data.train={path}", f"data.val={path}",
                     "mode.iterations=10"])
    emit({"phase": "campaign_larcv", "h5py": True, "route": route,
          "write_s": write_s, "batch_ms": batch_ms, "max_abs_err": err,
          "inference": metrics, "iotest": io})



# ---- the other tasks (simclr, yolo, unsupervised_eventID), the optimizers
# and run.profile, all at full dune3d width on host plans

TASK_STEPS = 4  # one warm-up, three timed
SIMCLR_TASK = ["name=simclr", "data.transform1=true", "data.transform2=true"]
# The views' default capacities, capacity_schedule(3000, 5, 0.5, 1024) =
# 3072/1536/1024/..., drop sites of these track-like events (their first
# 3000 voxels keep about 3/4 of their sites at each 2x2x2 downsample: up
# to 2238 at level 1, 1617 at level 2); the phases run a shrink of 0.75
# (3072/2560/2048/1536/1024/1024), and simclr prints what the default
# drops
SIMCLR = [*SIMCLR_TASK, "framework.capacity_shrink=0.75"]
SIMCLR_CAPACITIES = (3072, 2560, 2048, 1536, 1024, 1024)
# a SimCLR step runs two forwards and two backwards, one of each a view
LAUNCHES_PER_SIMCLR_STEP = {k: 2 * v for k, v in
                            LAUNCHES_PER_TRAIN_STEP_HOST.items()}
OPTIMIZERS = ("adam", "rmsprop", "sgd", "adagrad", "adadelta", "lars", "lamb",
              "novograd")
OPT_RTOL, OPT_ATOL = 1e-5, 1e-7  # an update on the card against the CPU's
TASK_FP32_TOL = 1e-3  # rtol and atol of z1, z2 and the anchor map (fp32)


def _counted(fn):
    """Run ``fn`` with every wrapper's launch count and every plain
    version's call count at 0 -> (its result, launches, plain calls)."""
    import torch

    wrappers, plains = _kernel_counters()
    for f in wrappers:
        f.launches = 0
    for f in plains:
        f.calls = 0
    out = fn()
    torch.cuda.synchronize()
    return (out, {f.__name__: f.launches for f in wrappers},
            {f.__name__: f.calls for f in plains})


TASK_OVERRIDES = []  # more overrides of the task phases' runs (rehearsals)


def task_config(phase, extra=(), precision="bfloat16"):
    """A task phase's config: its own run directory (a train run resumes
    from the checkpoints of an earlier one in its directory)."""
    return train_config([f"run.precision={precision}", f"run.id={phase}",
                         f"mode.iterations={TASK_STEPS}", *extra,
                         *TASK_OVERRIDES])


def phase_task(dataset, phase, extra, per_step, metric_keys):
    """TASK_STEPS steps of a task at full width through trainer.train on
    host plans: finite loss and ``metric_keys``, 0 dropped, launches of
    every kernel ``per_step`` times the steps, no plain version and no
    window_plan launch -> (config, run, launches)."""
    import numpy as np
    import torch

    from sparseeventid_tpu_torch.train.trainer import train

    cfg = task_config(phase, extra)
    torch.cuda.reset_peak_memory_stats()
    run, launches, plain_calls = _counted(
        lambda: train(cfg, dataset=dataset, device=DEVICE))
    history = run.history
    require(len(history) == TASK_STEPS == run.state.step, f"{phase}: steps")
    for i, m in enumerate(history):
        for k in ("loss/loss", *metric_keys):
            require(np.isfinite(m[k]), f"{phase} step {i}: {k} not finite: {m}")
        require(m["overflow/dropped"] == 0, f"{phase} step {i}: dropped: {m}")
    expected = {k: v * TASK_STEPS for k, v in per_step.items()}
    require(launches == expected,
            f"{phase}: launch counts {launches}, expected {expected}")
    require(launches["window_plan"] == 0
            and all(v == 0 for v in plain_calls.values()),
            f"{phase}: window_plan or a plain version on the path: "
            f"{launches['window_plan']}, {plain_calls}")
    timed = [m["time/io_s"] + m["time/step_s"] for m in history[1:]]
    steps_per_s = len(timed) / sum(timed)
    emit({"phase": phase, "steps": TASK_STEPS, "plans": "host",
          "io_s": [m["time/io_s"] for m in history],
          "step_s": [m["time/step_s"] for m in history],
          "loss": [m["loss/loss"] for m in history],
          "last": {k: history[-1][k] for k in metric_keys},
          "launches": launches, "launches_per_step": per_step,
          "plain_calls": plain_calls, "steps_per_s": steps_per_s,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    print(json.dumps({f"{phase}_steps_per_s": steps_per_s,
                      f"{phase}_events_per_s": steps_per_s * BATCH,
                      "timed_steps": len(timed), "batch": BATCH,
                      "precision": "bfloat16"}), flush=True)
    return cfg, run, launches


def build_task_of(cfg, dataset):
    """-> (the task of ``cfg`` on the card as the trainer builds it, its
    loader's planner: None for SimCLR, whose views carry their own, and on
    the plain backend)."""
    import torch

    from sparseeventid_tpu_torch.models import build_sparse_classifier
    from sparseeventid_tpu_torch.train.plans import planner_for
    from sparseeventid_tpu_torch.train.tasks import LOADER_PLANS, build_task

    planner = None
    if cfg.name in LOADER_PLANS:
        planner = planner_for(cfg, build_sparse_classifier(cfg).encoder, GRID)
    task = build_task(cfg, dataset, GRID, N_BATCHES, None,
                      torch.device(DEVICE), planner)
    return task, planner


def profile_task_step(cfg, dataset, phase):
    """Device time by kernel over one step of the task, ``prepare``
    included (the SimCLR views and their plans are made there, on the
    loop's thread), after a warm-up step -> the task."""
    import torch

    task, planner = build_task_of(cfg, dataset)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    batches = {}
    for first in (0, BATCH):
        batches[first] = dataset.batch([first])
        if planner is not None:  # built in the loader's thread
            batches[first] = planner.transform("train")(batches[first])

    def one_step(first):
        args = task.prepare(batches[first])
        return float(task.train_step(args, gen)["loss/loss"])

    one_step(0)
    wall_ms, busy_ms, top, port = _device_profile(lambda: one_step(BATCH))
    emit({"phase": f"profile_{phase}", "plans": "host", "wall_ms": wall_ms,
          "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
          "top_kernels": top, "port_kernels": port})
    return task


def phase_simclr(dataset):
    """SimCLR at full width: two views of aug_max_voxels (3000) voxels
    through one encoder, each step twice a single-view step's launches;
    a profiled step; two backward passes of one batch from the same weights
    give the same bits in every conv weight gradient (simclr_repeat), and
    the views differ -> launches."""
    import torch

    from sparseeventid_tpu_torch.train.losses import nt_xent_loss
    from sparseeventid_tpu_torch.train.plans import HostPlanner

    cfg, run, launches = phase_task(dataset, "simclr", SIMCLR,
                                    LAUNCHES_PER_SIMCLR_STEP,
                                    ("acc/top1", "acc/top5"))
    for m in run.history:
        require(0 <= m["acc/top1"] <= m["acc/top5"] <= 1,
                f"simclr: top-k out of [0, 1]: {m}")
    caps = run.state.model.encoder.capacities
    require(caps == SIMCLR_CAPACITIES, f"simclr view capacities {caps}")
    del run
    # one forward of both views of batch 0 at the default capacities
    default, _ = build_task_of(task_config("simclr_default", SIMCLR_TASK),
                               dataset)
    probe = default.eval_step(default.prepare(dataset.batch([0])))
    emit({"phase": "simclr_default_capacities",
          "capacities": list(default.state.model.encoder.capacities),
          "dropped": float(probe["overflow/dropped"]),
          "loss": float(probe["loss/loss"])})
    del default, probe
    task = profile_task_step(cfg, dataset, "simclr")
    model = task.state.model
    v1, v2, host = task.prepare(dataset.batch([0]))
    require(not torch.equal(v1.coords, v2.coords), "simclr: the views are equal")
    require(int(v1.n_active.max()) <= 3000 and int(v2.n_active.max()) <= 3000,
            "simclr: a view passes aug_max_voxels")
    planner = HostPlanner(model.encoder, GRID)
    plans = [planner.plans(v, h) for v, h in zip((v1, v2), host)]

    def gradients():
        model.zero_grad(set_to_none=True)
        model.train()
        z1, z2, _ = model(v1, v2, *plans)
        nt_xent_loss(z1, z2).backward()
        torch.cuda.synchronize()
        return {n: p.grad.detach().clone()
                for n, p in model.named_parameters() if p.grad is not None}

    first, second = gradients(), gradients()
    params = dict(model.named_parameters())
    differ = sorted(n for n in first if not torch.equal(first[n], second[n]))
    conv_differ = [n for n in differ if params[n].dim() == 3]
    conv_weights = sum(1 for p in params.values() if p.dim() == 3)
    emit({"phase": "simclr_repeat", "gradients": len(first),
          "differ": len(differ), "differ_names": differ[:20],
          "conv_weights": conv_weights, "conv_weights_differ": len(conv_differ),
          "view_active": [v1.n_active.tolist(), v2.n_active.tolist()]})
    require(len(first) == len(params) and conv_weights == 55,
            f"simclr: {len(first)} gradients of {len(params)} parameters, "
            f"{conv_weights} conv weights")
    require(not conv_differ, f"simclr: conv weight gradients differ between "
            f"two backward passes of one batch: {conv_differ}")
    return launches


def phase_simclr_kernels(dataset):
    """window_conv_apply and the backward (window_dw for the initial conv)
    at a SimCLR view's level-0 shape (capacity 3072: 125x1->32 initial,
    27x32->32 series) on the views of batch 0, against their plain versions
    as the kernel phase holds them -> rows."""
    from sparseeventid_tpu_torch.train.tasks import augment_views

    cfg = task_config("simclr_kernels", SIMCLR)
    image = augment_views(cfg, GRID)(dataset.batch([0])["image"])
    views = CachedDataset(GRID, {0: {"image": image}}, BATCH)
    geo = dict(GEOMETRY_3D, rows=cfg.data.aug_max_voxels,
               prefix="simclr view ", cases=("initial", "L0 series"),
               sidecars=False)
    return phase_kernels(views, geo)


def phase_yolo(dataset):
    """Vertex finding at full width: TASK_STEPS steps (finite loss parts and
    vertex metrics), a profiled step, then mode=inference from the run's
    checkpoint writes val_rank_0.npz whose anchor map lies on the encoded
    grid (32, 16, 40) -> launches of the train run."""
    import numpy as np

    from sparseeventid_tpu_torch.train.evaluate import run_dir, validate

    parts = ("loss/objectness", "loss/offset", "loss/event",
             "vertex/mean_dist_cm", "vertex/frac_5cm", "vertex/frac_10cm",
             "vertex/frac_20cm")
    cfg, run, launches = phase_task(dataset, "yolo", ["name=yolo"],
                                    LAUNCHES_PER_TRAIN_STEP_HOST, parts)
    del run
    profile_task_step(cfg, dataset, "yolo")
    icfg = task_config("yolo", ["name=yolo", "mode=inference"])
    metrics, inf_launches, plain_calls = _counted(
        lambda: validate(icfg, dataset=dataset, device=DEVICE))
    # each batch: the eval step's forward and the predict step's
    expected = {k: 2 * N_BATCHES * v for k, v in LAUNCHES_PER_FORWARD_HOST.items()}
    require({k: inf_launches[k] for k in expected} == expected
            and all(v == 0 for v in plain_calls.values()),
            f"yolo inference launches {inf_launches}, expected {expected}; "
            f"plain {plain_calls}")
    require(metrics["overflow/dropped"] == 0
            and all(np.isfinite(metrics[k]) for k in ("loss/loss", *parts)),
            f"yolo inference metrics {metrics}")
    out = np.load(run_dir(icfg) / "validation_output" / "val_rank_0.npz")
    n = BATCH * N_BATCHES
    anchor_grid = tuple(g // 2**5 for g in GRID)
    require(set(out.files) == {"label", "vertex_true", "anchor", "vertex",
                               "pred_label"}, f"yolo outputs {out.files}")
    require(anchor_grid == (32, 16, 40)
            and out["anchor"].shape == (n, *anchor_grid)
            and out["vertex"].shape == out["vertex_true"].shape == (n, 3)
            and np.isfinite(out["vertex"]).all(),
            f"yolo outputs: anchor {out['anchor'].shape}, vertex "
            f"{out['vertex'].shape}")
    emit({"phase": "yolo_inference", "metrics": metrics,
          "anchor_grid": list(out["anchor"].shape[1:]),
          "vertex_shape": list(out["vertex"].shape), "launches": inf_launches,
          "plain_calls": plain_calls})
    return launches


def phase_unsupervised(dataset):
    """Weak-label event ID at full width: the energy window fitted to the
    split's 24 events, TASK_STEPS steps on the weak_label head, a profiled
    step -> launches."""
    import numpy as np

    from sparseeventid_tpu_torch.train.unsupervised import weak_labels_from_energy

    weak = weak_labels_from_energy(dataset.energy)
    cfg, run, launches = phase_task(dataset, "unsupervised",
                                    ["name=unsupervised_eventID"],
                                    LAUNCHES_PER_TRAIN_STEP_HOST,
                                    ("acc/weak_label",))
    heads = sorted({n.split(".")[1] for n, _ in
                    run.state.model.named_parameters() if n.startswith("head.")})
    require(heads == ["weak_label"], f"unsupervised heads {heads}")
    del run
    emit({"phase": "unsupervised_labels",
          "window": [float(x) for x in weak["window"]],
          "events": int(len(weak["weak_label"])),
          "label_1_share": float(np.mean(weak["weak_label"]))})
    profile_task_step(cfg, dataset, "unsupervised")
    return launches


def phase_optimizers(dataset):
    """One dune3d train step under each of the eight kinds (finite loss,
    every head parameter moved), and each kind's two updates of the
    model's parameters under seeded gradients on the card against the same
    on the CPU (rtol 1e-5)."""
    import numpy as np
    import torch

    from sparseeventid_tpu_torch.models import build_sparse_classifier
    from sparseeventid_tpu_torch.train import TrainState, build_lr_schedule
    from sparseeventid_tpu_torch.train.optimizers import build_optimizer
    from sparseeventid_tpu_torch.train.plans import HostPlanner
    from sparseeventid_tpu_torch.train.trainer import (
        build_training,
        host_plans_of,
        step_generator,
    )
    from sparseeventid_tpu_torch.train.evaluate import feature_dtype, prepare_batch

    dev = torch.device(DEVICE)
    report = {"phase": "optimizers"}
    for kind in OPTIMIZERS:
        cfg = task_config(f"optimizer_{kind}", [f"mode.optimizer.name={kind}"])
        planner = HostPlanner(build_sparse_classifier(cfg).encoder, GRID)
        state, step, _ = build_training(cfg, N_BATCHES, None, dev, planner)
        before = {n: p.detach().clone() for n, p in state.model.named_parameters()
                  if n.startswith("head.")}
        batch = planner.transform("train")(dataset.batch([0]))
        st, labels = prepare_batch(batch, GRID, state.model.encoder.capacities[0],
                                   feature_dtype(cfg), dev)
        m = step(st, labels, step_generator(SEED, 0, dev),
                 host_plans_of(planner, batch, dev))
        loss = float(m["loss/loss"])
        still = [n for n, p in state.model.named_parameters()
                 if n in before and torch.equal(p, before[n])]
        require(np.isfinite(loss) and int(m["overflow/dropped"]) == 0,
                f"optimizer {kind}: loss {loss}, dropped {m['overflow/dropped']}")
        require(not still, f"optimizer {kind}: head parameters did not move: "
                f"{still}")
        # the update rule alone, card against CPU, from the same tensors
        gen = torch.Generator().manual_seed(SEED + 7)
        p0 = {n: p.detach().float().cpu() for n, p in
              state.model.named_parameters()}
        grads = [{n: torch.randn(t.shape, generator=gen) * 1e-2
                  for n, t in p0.items()} for _ in range(2)]
        sched = build_lr_schedule(cfg.mode.optimizer.lr_schedule, N_BATCHES, 1)
        ends = {}
        for where in ("cpu", DEVICE):
            params = {n: torch.nn.Parameter(t.clone().to(where))
                      for n, t in p0.items()}
            holder = torch.nn.Module()
            for n, p in params.items():
                holder.register_parameter(n.replace(".", "_"), p)
            opt, sch = build_optimizer(cfg.mode.optimizer, sched,
                                       list(params.values()))
            upd = TrainState(holder, opt, sch)
            for g in grads:
                for n, p in params.items():
                    p.grad = g[n].to(where)
                upd.apply_gradients()
            ends[where] = {n: p.detach().cpu() for n, p in params.items()}
        worst = 0.0
        for n, want in ends["cpu"].items():
            got = ends[DEVICE][n]
            excess = ((got - want).abs() - OPT_RTOL * want.abs()).max().item()
            worst = max(worst, excess)
            require(torch.allclose(got, want, rtol=OPT_RTOL, atol=OPT_ATOL),
                    f"optimizer {kind}: {n} on the card differs from the CPU "
                    f"update by {(got - want).abs().max().item()}")
        report[kind] = {"loss": loss, "head_params_moved": len(before),
                        "card_vs_cpu_max_excess_over_rtol": worst,
                        "tensors": len(p0)}
        del state, step
    emit(report)


def phase_profile(dataset):
    """run.profile=true through trainer.train, 2 steps: the Chrome trace
    under <run dir>/profile/ names the port's CUDA kernels."""
    import torch

    from sparseeventid_tpu_torch.train.evaluate import run_dir
    from sparseeventid_tpu_torch.train.trainer import train

    cfg = task_config("profile_run", ["mode.iterations=2", "run.profile=true"])
    run = train(cfg, dataset=dataset, device=DEVICE)
    torch.cuda.synchronize()
    trace = run_dir(cfg) / "profile" / "trace.json"
    require(trace.is_file(), f"no profiler trace at {trace}")
    names = set()
    for e in json.loads(trace.read_text())["traceEvents"]:
        for kname in ("conv_tc_kernel", "bwd_dw_kernel", "overflow_kernel",
                      "dw_tile_kernel", "overflow_dw_kernel"):
            if kname in str(e.get("name", "")):
                names.add(kname)
    require(names, "the profiler trace names none of the port's kernels")
    emit({"phase": "profile_trace", "steps": len(run.history),
          "trace_mb": trace.stat().st_size / 2**20,
          "port_kernels_named": sorted(names)})


def phase_fp32_tasks(dataset) -> None:
    """fp32 forward of the SimCLR and vertex models from the same weights,
    window kernels on host plans against the plain rulebook backend: z1, z2
    and the anchor map within rtol = atol = 1e-3, and within 1e-3 of their
    scale (fp32_simclr, fp32_yolo)."""
    import torch

    from sparseeventid_tpu_torch.train.plans import HostPlanner

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for phase, extra in (("fp32_simclr", SIMCLR), ("fp32_yolo", ["name=yolo"])):
        got = {}
        for backend in ("xla", "window"):
            cfg = task_config(phase, [*extra, "mode=inference",
                                      f"framework.sparse_backend={backend}"],
                              precision="float32")
            task, planner = build_task_of(cfg, dataset)
            args = task.prepare(dataset.batch([0]))
            model = task.state.model.eval()
            with torch.no_grad():
                if cfg.name == "simclr":
                    v1, v2, host = args
                    plans = (None, None)
                    if host is not None:  # the views' own plans
                        views = HostPlanner(model.encoder, GRID)
                        plans = (views.plans(v1, host[0]),
                                 views.plans(v2, host[1]))
                    z1, z2, dropped = model(v1, v2, *plans)
                    out = {"z1": z1, "z2": z2}
                else:
                    st, _, _, host = args
                    plans = (None if host is None
                             else planner.plans(st, host))
                    anchor, _, dropped = model(st, plans)
                    out = {"anchor": anchor}
            require(int(dropped) == 0, f"{phase} {backend}: dropped {int(dropped)}")
            got[backend] = {k: v.float().cpu() for k, v in out.items()}
            del task, model
        row = {"phase": phase, "plans": "host", "rtol": TASK_FP32_TOL,
               "atol": TASK_FP32_TOL}
        for k, ref in got["xla"].items():
            diff = (got["window"][k] - ref).abs().max().item()
            scale = ref.abs().max().item()
            # z is small at random init (a mean over the grid's volume), so
            # the difference is also held to 1e-3 of the output's scale
            within = (torch.allclose(got["window"][k], ref, rtol=TASK_FP32_TOL,
                                     atol=TASK_FP32_TOL)
                      and diff <= TASK_FP32_TOL * scale)
            row[k] = {"max_abs_diff": diff, "max_abs": scale,
                      "diff_over_scale": diff / scale if scale else None,
                      "within": within}
            require(scale > 0 and within,
                    f"{phase}: {k} differs from the plain backend: {row}")
        emit(row)


def phase_visualize() -> None:
    """mode=visualize through __main__.main on two synthetic dune3d events,
    where matplotlib imports; elsewhere a line that says so."""
    try:
        import matplotlib  # noqa: F401
    except ModuleNotFoundError:
        emit({"phase": "visualize", "matplotlib": False})
        return
    from sparseeventid_tpu_torch.__main__ import main as cli

    shown = cli(["--config-name", "dune3d", "mode=visualize", "mode.events=2",
                 "data.val=synthetic", "data.synthetic_events=2",
                 "run.minibatch_size=2", f"output_dir={RUN_DIR}",
                 "run.id=visualize"])
    written = shown["written"]
    require(len(written) == 2 and all(Path(p).stat().st_size > 1000
                                      for p in written),
            f"visualize wrote {written}")
    emit({"phase": "visualize", "matplotlib": True, "written": len(written)})


# ---- data parallelism (parallel/mesh.py) ----------------------------------

DP_STEPS = 4  # one warm-up, three timed
DP_WORLD = 2  # ranks of dp_two_ranks, all on the one card
DP_TWO_RANK_STEPS = 2
DP_RANK_TIMEOUT_S = 420  # the ranks' whole run, start-up included
DP_FP32_LOSS_RTOL = 1e-3


class EventsDataset:
    """One padded batch served event by event: a rank's loader takes its
    shard's events out of it."""

    def __init__(self, grid, batch):
        self._grid = tuple(grid)
        self._batch = batch

    def __len__(self):
        return len(self._batch["image"])

    def batch_grid(self):
        return self._grid

    def batch(self, indices):
        import numpy as np

        idx = np.asarray(indices)
        return {k: v[idx] for k, v in self._batch.items()}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def digest(tensors) -> str:
    """One hash of the bits of every tensor of a name -> tensor mapping."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for name, t in tensors.items():
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def optimizer_gradients(cfg, dataset, events):
    """One train step of ``cfg``'s task, built as the trainer builds it from
    the run's seed, on ``events`` (host plans built as the loader's thread
    builds them) -> (its metrics, the gradients its optimizer was given,
    the buffers after the step)."""
    import torch

    task, planner = build_task_of(cfg, dataset)
    state = task.state
    grads = {}
    update = state.optimizer.step

    def spy(*args, **kwargs):
        grads.update({n: p.grad.detach().clone()
                      for n, p in state.model.named_parameters()
                      if p.grad is not None})
        return update(*args, **kwargs)

    state.optimizer.step = spy
    batch = dataset.batch(list(events))
    if planner is not None:
        batch = planner.transform("train")(batch)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    metrics = task.train_step(task.prepare(batch), gen)
    torch.cuda.synchronize()
    return ({k: float(v) for k, v in metrics.items()}, grads,
            {n: b.detach().clone() for n, b in state.model.named_buffers()})


def _counted_dp(fn):
    """``_counted``, and the launches of the two ops-path kernels, which no
    model selects -> (result, launches, plain calls, ops-path launches)."""
    from sparseeventid_tpu_torch.ops import gather_conv as GC
    from sparseeventid_tpu_torch.ops.window import kernels as K

    ops = (K.window_gather, GC.gather_conv)
    for f in ops:
        f.launches = 0
    out, launches, plain_calls = _counted(fn)
    return out, launches, plain_calls, {f.__name__: f.launches for f in ops}


def profile_dp_step(cfg, dataset):
    """One train step of ``cfg``'s task after a warm-up: the wall ms of
    three steps (batches 1, 2, 1), then one profiled step -> its device-busy
    ms, the device ms and launches of NCCL kernels, and the host ms of the
    collectives (the self CPU time of the c10d ops and their
    ``record_param_comms``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    task, planner = build_task_of(cfg, dataset)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    batches = [planner.transform("train")(dataset.batch([first]))
               for first in (0, BATCH, 2 * BATCH)]

    def step(b):
        task.train_step(task.prepare(batches[b]), gen)
        torch.cuda.synchronize()

    step(0)
    walls = []
    for b in (1, 2, 1):
        t0 = time.perf_counter()
        step(b)
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(1)
    events = prof.key_averages()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    nccl = [e for e in device if "nccl" in e.key.lower()]
    comms = [e for e in events if e.device_type != torch.autograd.DeviceType.CUDA
             and (e.key.startswith("c10d::") or e.key == "record_param_comms")]
    return {"wall_ms": walls,
            "device_busy_ms": sum(e.self_device_time_total for e in device) / 1e3,
            "nccl_device_ms": sum(e.self_device_time_total for e in nccl) / 1e3,
            "nccl_launches": sum(e.count for e in nccl),
            "collective_calls": sum(e.count for e in comms
                                    if e.key.startswith("c10d::")),
            "collective_host_ms": sum(e.self_cpu_time_total for e in comms) / 1e3}


def phase_dp_world1(dataset):
    """dune3d at full width on host plans as a world-size-1 NCCL group,
    joined by ``mesh.initialize_distributed`` from torchrun's variables: one
    train step through the distributed path (sync batch norm, metrics and
    gradient mean) from the same weights on batch 0 as the one-process
    step gives the same bits in every gradient the optimizer is given and
    in every running statistic; then DP_STEPS steps through
    train.trainer.train(run.distributed=true), their steps/s beside the
    train phase's; one profiled step each without and with the group (wall,
    device-busy, the NCCL kernels' device ms and the collectives' host ms)
    -> the launches of the train run."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from sparseeventid_tpu_torch.parallel import mesh
    from sparseeventid_tpu_torch.train.trainer import train

    base = ["run.precision=bfloat16", "run.id=dp_world1"]
    events = range(BATCH)
    ref_metrics, ref_grads, ref_bufs = optimizer_gradients(
        train_config(base), dataset, events)
    one_process = profile_dp_step(train_config(base), dataset)
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}
    os.environ.update(env)
    try:
        cfg = train_config([*base, "run.distributed=true"])
        dev = mesh.initialize_distributed(cfg)
        backend = dist.get_backend()
        require(mesh.world() == 1 and backend == "nccl",
                f"dp_world1: world {mesh.world()}, backend {backend}")
        dp_metrics, dp_grads, dp_bufs = optimizer_gradients(cfg, dataset, events)
        differ = sorted(n for n in ref_grads
                        if not torch.equal(ref_grads[n], dp_grads.get(n)))
        buf_differ = sorted(n for n in ref_bufs
                            if not torch.equal(ref_bufs[n], dp_bufs[n]))
        metric_differ = sorted(k for k in ref_metrics
                               if ref_metrics[k] != dp_metrics[k])
        emit({"phase": "dp_world1_step", "backend": backend, "device": str(dev),
              "gradients": len(dp_grads), "gradients_differ": len(differ),
              "differ_names": differ[:20], "running_stats": len(dp_bufs),
              "running_stats_differ": len(buf_differ),
              "metrics_differ": metric_differ, "loss": dp_metrics["loss/loss"]})
        require(len(dp_grads) == len(ref_grads) > 0 and not differ,
                f"dp_world1: gradients differ from the one-process step: {differ}")
        require(not buf_differ and not metric_differ,
                f"dp_world1: running statistics {buf_differ} or metrics "
                f"{metric_differ} differ from the one-process step")

        run_cfg = train_config([*base, "run.distributed=true",
                                f"mode.iterations={DP_STEPS}"])
        run, launches, plain_calls, ops = _counted_dp(
            lambda: train(run_cfg, dataset))
        history = run.history
        require(len(history) == DP_STEPS == run.state.step, "dp_world1: steps")
        for i, m in enumerate(history):
            require(np.isfinite(m["loss/loss"]) and m["overflow/dropped"] == 0,
                    f"dp_world1 step {i}: {m}")
        expected = {k: v * DP_STEPS for k, v in LAUNCHES_PER_TRAIN_STEP_HOST.items()}
        require(launches == expected,
                f"dp_world1: launch counts {launches}, expected {expected}")
        require(all(v == 0 for v in plain_calls.values())
                and not any(ops.values()),
                f"dp_world1: plain version or ops-path kernel on the path: "
                f"{plain_calls}, {ops}")
        timed = [m["time/io_s"] + m["time/step_s"] for m in history[1:]]
        steps_per_s = len(timed) / sum(timed)
        distributed = profile_dp_step(cfg, dataset)
    finally:
        mesh.destroy()
        for k in env:
            os.environ.pop(k, None)
    emit({"phase": "dp_world1", "steps": DP_STEPS, "backend": backend,
          "step_s": [m["time/step_s"] for m in history],
          "io_s": [m["time/io_s"] for m in history],
          "loss": [m["loss/loss"] for m in history],
          "launches": launches, "plain_calls": plain_calls,
          "profiled_step": {"one_process": one_process,
                            "distributed": distributed}})
    launches.update(ops)
    print(json.dumps({"dp_world1_steps_per_s": steps_per_s,
                      "train_steps_per_s": STEPS_PER_S.get("train"),
                      "timed_steps": len(timed), "batch": BATCH,
                      "precision": "bfloat16",
                      "nccl_device_ms_per_step": distributed["nccl_device_ms"],
                      "collective_host_ms_per_step":
                      distributed["collective_host_ms"]}), flush=True)
    return launches


def phase_dp_two_ranks():
    """Two ranks on the one card (framework.oversubscribe=2, gloo), started
    by torch.distributed.run: each takes 4 of the 8 events of dune3d batch
    0 (its loader's shard).  Supervised at fp32: the data-parallel step's
    loss within DP_FP32_LOSS_RTOL of one process on the 8 events and every
    mean gradient within FP32_GRAD_LIMIT (relative L2, conv biases ahead of
    a batch norm left out); two bf16 steps through train.trainer.train: the
    ranks' parameters and running statistics the same bits, 0 dropped;
    SimCLR, two steps: the gathered batch holds 2 x 4 events a view, finite
    loss, top-1 <= top-5 in [0, 1], the ranks' parameters the same bits.
    Steps/s and the collectives' ms a step are printed; two ranks share one
    card's SMs, so they are no scaling number -> rank 0's launches of the
    supervised run."""
    import torch

    torch.cuda.empty_cache()
    out = RUN_DIR / "dp_two_ranks"
    out.mkdir(parents=True, exist_ok=True)
    # each rank runs the script that is running (chip_smoke.py, or a
    # rehearsal that imports it) with --dp-rank
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={DP_WORLD}", str(Path(sys.argv[0]).resolve()),
           "--dp-rank", str(out)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=HERE, start_new_session=True, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        log, _ = proc.communicate(timeout=DP_RANK_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        raise Failure(f"dp_two_ranks: ranks still ran after {DP_RANK_TIMEOUT_S} s: "
                      f"{log[-4000:]}")
    wall_s = time.perf_counter() - t0
    require(proc.returncode == 0,
            f"dp_two_ranks: exit code {proc.returncode}: {log[-4000:]}")
    ranks = [json.loads((out / f"rank_{r}.json").read_text())
             for r in range(DP_WORLD)]
    r0 = ranks[0]
    emit({"phase": "dp_two_ranks", "wall_s": wall_s, "ranks": ranks,
          "note": "two ranks share one card's SMs: no scaling number"})
    fp32 = r0["fp32"]
    require(fp32["loss_within"] and fp32["within"],
            f"dp_two_ranks: fp32 step against one process: {fp32}")
    for key in ("grads_digest", "supervised_digest", "simclr_digest"):
        require(len({r[key] for r in ranks}) == 1,
                f"dp_two_ranks: ranks differ in {key}: {[r[key] for r in ranks]}")
    for r in ranks:
        require(r["supervised"]["dropped"] == 0 and r["simclr"]["dropped"] == 0,
                f"dp_two_ranks: dropped: {r}")
        require(r["supervised"]["finite"] and r["simclr"]["finite"],
                f"dp_two_ranks: loss not finite: {r}")
        require(r["simclr"]["top1_le_top5"],
                f"dp_two_ranks: top-1/top-5 out of order: {r['simclr']}")
        # every rank's 4 events a view, 128-wide projections
        require(r["simclr"]["gathered"]
                and all(s == [BATCH, 128] for s in r["simclr"]["gathered"]),
                f"dp_two_ranks: gathered batch {r['simclr']['gathered']}")
        expected = {k: v * DP_TWO_RANK_STEPS
                    for k, v in LAUNCHES_PER_TRAIN_STEP_HOST.items()}
        require(r["supervised"]["launches"] == expected,
                f"dp_two_ranks: launches {r['supervised']['launches']}, "
                f"expected {expected}")
    print(json.dumps({"dp_two_ranks_steps_per_s": r0["supervised"]["steps_per_s"],
                      "dp_two_ranks_collective_ms_per_step":
                      r0["supervised"]["collective_ms_per_step"],
                      "dp_two_ranks_simclr_steps_per_s":
                      r0["simclr"]["steps_per_s"],
                      "events_per_rank": BATCH // DP_WORLD, "backend": "gloo",
                      "note": "two ranks on one card"}), flush=True)
    return {**r0["supervised"]["launches"], **r0["supervised"]["ops_launches"]}


@contextlib.contextmanager
def timed_collectives():
    """Time every collective of torch.distributed the block calls, each
    between two synchronisations of the card -> {name: [calls, ms]}."""
    import torch
    import torch.distributed as dist

    names = ("all_reduce", "all_gather", "broadcast", "barrier")
    saved = {n: getattr(dist, n) for n in names}
    spent = {n: [0, 0.0] for n in names}

    def timed(name):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = saved[name](*args, **kwargs)
            torch.cuda.synchronize()
            spent[name][0] += 1
            spent[name][1] += (time.perf_counter() - t0) * 1e3
            return out
        return call

    for n in names:
        setattr(dist, n, timed(n))
    try:
        yield spent
    finally:
        for n, f in saved.items():
            setattr(dist, n, f)


def dp_rank_main(out: Path) -> int:
    """One rank of dp_two_ranks (started by torch.distributed.run): writes
    ``out/rank_<rank>.json``."""
    import numpy as np
    import torch

    from sparseeventid_tpu_torch.parallel import mesh
    from sparseeventid_tpu_torch.train.trainer import train

    global RUN_DIR
    RUN_DIR = out / "runs"
    rank = int(os.environ["RANK"])
    dataset = EventsDataset(GRID, make_dataset(1).batch([0]))
    mine = range(rank * BATCH // DP_WORLD, (rank + 1) * BATCH // DP_WORLD)
    shared = ["framework.oversubscribe=2",
              f"run.minibatch_size={BATCH // DP_WORLD}"]
    fp32 = ["run.precision=float32", "head.dropout=0.0", *shared]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if rank == 0:  # one process on the 8 events, before the group exists
        ref_metrics, ref_grads, _ = optimizer_gradients(
            train_config([*fp32, "run.id=dp_fp32_ref"]), dataset, range(BATCH))
    cfg = train_config([*fp32, "run.distributed=true", "run.id=dp_fp32"])
    dev = mesh.initialize_distributed(cfg)
    require(str(dev) == "cuda:0" and torch.distributed.get_backend() == "gloo",
            f"rank {rank}: {dev}, {torch.distributed.get_backend()}")
    metrics, grads, _ = optimizer_gradients(cfg, dataset, mine)
    result = {"rank": rank, "device": str(dev), "grads_digest": digest(grads),
              "fp32_loss": metrics["loss/loss"],
              "fp32_dropped": metrics["overflow/dropped"]}
    if rank == 0:
        worst, worst_name = 0.0, ""
        for name, g in grads.items():
            if name.endswith(".b"):  # a conv bias ahead of a batch norm
                continue
            rel = float((g - ref_grads[name]).norm()) / float(ref_grads[name].norm())
            if rel > worst:
                worst, worst_name = rel, name
        ref_loss = ref_metrics["loss/loss"]
        result["fp32"] = {
            "loss": metrics["loss/loss"], "ref_loss": ref_loss,
            "loss_within": abs(metrics["loss/loss"] - ref_loss)
            <= DP_FP32_LOSS_RTOL * abs(ref_loss),
            "worst_rel_l2": worst, "worst_tensor": worst_name,
            "limit": FP32_GRAD_LIMIT, "within": worst <= FP32_GRAD_LIMIT,
            "tensors": len(grads)}
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True

    def run_task(run_id, extra):
        cfg = train_config(["run.precision=bfloat16", *shared, *extra,
                            "run.distributed=true", f"run.id={run_id}",
                            f"mode.iterations={DP_TWO_RANK_STEPS}"])
        with timed_collectives() as spent:
            run, launches, plain, ops = _counted_dp(lambda: train(cfg, dataset))
        h = run.history
        timed = [m["time/io_s"] + m["time/step_s"] for m in h[1:]]
        steps = len(h)
        report = {
            "steps": steps, "loss": [m["loss/loss"] for m in h],
            "finite": all(np.isfinite(m["loss/loss"]) for m in h),
            "dropped": sum(m["overflow/dropped"] for m in h),
            "steps_per_s": len(timed) / sum(timed), "launches": launches,
            "ops_launches": ops,
            "plain_calls": plain, "collectives": spent,
            "collective_ms_per_step": (spent["all_reduce"][1]
                                       + spent["all_gather"][1]) / steps}
        require(steps == DP_TWO_RANK_STEPS and not any(plain.values())
                and not any(ops.values()),
                f"rank {rank} {run_id}: {report}")
        return run, report

    run, result["supervised"] = run_task("dp_supervised", [])
    result["supervised_digest"] = digest(run.state.model.state_dict())
    gathered = []
    gather = mesh.all_gather_rows

    def spy(x):
        y = gather(x)
        gathered.append(list(y.shape))
        return y

    mesh.all_gather_rows = spy
    try:
        run, report = run_task("dp_simclr", SIMCLR)
    finally:
        mesh.all_gather_rows = gather
    last = run.history[-1]
    report.update(gathered=gathered, top1=last["acc/top1"], top5=last["acc/top5"],
                  top1_le_top5=all(0.0 <= m["acc/top1"] <= m["acc/top5"] <= 1.0
                                   for m in run.history))
    result["simclr"] = report
    result["simclr_digest"] = digest(run.state.model.state_dict())
    mesh.destroy()
    (out / f"rank_{rank}.json").write_text(json.dumps(result))
    return 0


# ---- the other models: group and layer norm, per-label final series,
# framework.remat, the dense and point-cloud families

MODEL_STEPS = 3  # train steps of each model phase: one warm-up, two timed
# the per-label final series: 4 labels x 4 blocks x 2 convs on one plan,
# built on the card from the encoded sites (so on host plans too); they are
# not recomputed under remat
PER_LABEL_CONVS = 4 * 4 * 2
LAUNCHES_PER_FORWARD_PER_LABEL = {
    **LAUNCHES_PER_FORWARD_HOST, "window_plan": 1,
    "window_conv_apply": 54 + PER_LABEL_CONVS,
    "overflow_apply_batched": 53 + PER_LABEL_CONVS,
    **norm_launches(BATCH_NORMS + PER_LABEL_CONVS, 0, stats=0),
}
LAUNCHES_PER_TRAIN_STEP_PER_LABEL = {
    **LAUNCHES_PER_TRAIN_STEP_HOST, "window_plan": 1,
    "window_conv_apply": 54 + REMAT_SERIES_CONVS + PER_LABEL_CONVS,
    # forward, recomputed forward, and dX of every conv with C > 1
    "overflow_apply_batched": (106 + REMAT_SERIES_CONVS
                               + 2 * PER_LABEL_CONVS),
    "window_bwd_strided": 53 + PER_LABEL_CONVS,
    "overflow_dw_batched": 53 + PER_LABEL_CONVS,
    **norm_launches(BATCH_NORMS + REMAT_SERIES_CONVS + PER_LABEL_CONVS,
                    BATCH_NORMS + PER_LABEL_CONVS),
}
NO_LAUNCHES = {k: 0 for k in LAUNCHES_PER_TRAIN_STEP}
# the dense family on the dune2d grid (3 planes of 1536 x 1024): inference
# at BATCH, training at the largest batch that fits the card's 80 GB (the
# phase prints its peak: half of it an event); in 3D at a cut grid,
# 1/8 of dune3d's in each axis (the dune3d grid's level-0 activation alone
# is 85.9 GB an event at 32 fp32 channels)
DENSE_TRAIN_BATCH_2D = 2
DENSE_GRID_3D = (128, 64, 160)
DENSE_TRAIN_BATCH_3D = BATCH
DENSE_COMPARE_TOL = 1e-3  # rtol and atol of the card's logits against the CPU's
POINTS_COMPARE_EVENTS = 2  # events of the card-against-CPU forward
KNN_PER_DGCNN_FORWARD = 4  # one neighbour search an EdgeConv stage
# the neighbour search kernel's rows: B clouds of P points, k neighbours,
# at each EdgeConv stage's input width F (as the dgcnn3d benchmark runs it)
KNN_B, KNN_P, KNN_K = 8, 8192, 20
KNN_FEATURES = (4, 64, 128)
# on real-valued data the kernel and the plain version round apart: the
# float64 distances of the neighbours each picks, row by row in ascending
# order, within this share of the largest of them
KNN_REAL_TOL = 1e-5


def _fp32_window_vs_plain(phase, extra, dataset, grid, recipe="dune3d",
                          gradients=True):
    """One batch's first FP32_GRAD_EVENTS events at fp32 through the window
    kernels on host plans and through the plain rulebook backend, from the
    same weights: the logits within rtol = atol = 1e-3 (eval mode) and, with
    ``gradients``, every parameter gradient of one train-mode loss within
    fp32_grad_compare's limit (conv biases ahead of a norm left out)."""
    import torch

    from sparseeventid_tpu_torch.config.schema import OUTPUT_SHAPE
    from sparseeventid_tpu_torch.models import build_sparse_classifier, init_parameters
    from sparseeventid_tpu_torch.train.evaluate import prepare_batch
    from sparseeventid_tpu_torch.train.losses import multi_head_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    batch = {k: v[:FP32_GRAD_EVENTS] for k, v in dataset.batch([0]).items()}
    out = {}
    for backend in ("xla", "window"):
        cfg = train_config(["run.precision=float32", "head.dropout=0.0",
                            f"framework.sparse_backend={backend}", *extra],
                           recipe)
        model = init_parameters(build_sparse_classifier(cfg), SEED).to(dev)
        st, labels = prepare_batch(batch, grid, model.encoder.capacities[0],
                                   torch.float32, dev)
        plans = (host_plans(model, batch["image"], grid, st)
                 if backend == "window" else None)
        with torch.no_grad():
            logits, dropped = model.eval()(st, plans=plans)
        require(int(dropped) == 0, f"{phase} fp32 {backend}: dropped {int(dropped)}")
        logits = torch.cat([logits[k] for k in OUTPUT_SHAPE], dim=1).cpu()
        grads = {}
        if gradients:
            lg, _ = model.train()(st, plans=plans)
            loss, _ = multi_head_loss(lg, labels,
                                      cfg.mode.optimizer.loss_balance_scheme)
            loss.backward()
            grads = {n: p.grad.detach().clone()
                     for n, p in model.named_parameters() if not n.endswith(".b")}
        out[backend] = (logits, grads)
        del model
        torch.cuda.empty_cache()
    (ref_logits, ref), (logits, grads) = out["xla"], out["window"]
    report = {"logits_max_abs_diff": float((logits - ref_logits).abs().max()),
              "logits_max_abs": float(ref_logits.abs().max()),
              "logits_within": torch.allclose(logits, ref_logits, rtol=FP32_RTOL,
                                              atol=FP32_ATOL_LOGITS)}
    if gradients:
        worst, worst_name = 0.0, ""
        for name, g in grads.items():
            rel = float((g - ref[name]).norm()) / max(float(ref[name].norm()),
                                                      1e-30)
            if rel > worst:
                worst, worst_name = rel, name
        report.update(tensors=len(grads), worst_rel_l2=worst,
                      worst_tensor=worst_name, limit=FP32_GRAD_LIMIT,
                      grads_within=worst <= FP32_GRAD_LIMIT)
    emit({"phase": f"{phase}_fp32_compare", "plans": "host",
          "events": FP32_GRAD_EVENTS, **report})
    require(report["logits_within"], f"{phase}: fp32 logits differ: {report}")
    require(report.get("grads_within", True),
            f"{phase}: fp32 gradients differ: {report}")


def _knn_counted(fn):
    """Run ``fn`` with the neighbour search's launch and plain-call counts
    at 0 -> (its result, {"knn_topk": launches, "knn_topk_plain": calls})."""
    from sparseeventid_tpu_torch.ops import knn_kernels as KNN

    KNN.knn_topk.launches = KNN.knn_topk_plain.calls = 0
    out = fn()
    return out, {"knn_topk": KNN.knn_topk.launches,
                 "knn_topk_plain": KNN.knn_topk_plain.calls}


def train_and_validate(phase, extra, dataset, grid, recipe="dune3d",
                       per_step=None, per_forward=None, train_batch=BATCH,
                       knn_per_forward=0):
    """MODEL_STEPS steps through trainer.train, then validate() over the
    dataset from the run's checkpoint: finite losses, 0 dropped, the launch
    counts of every kernel ``per_step`` times the steps and ``per_forward``
    times the batches, the neighbour search's kernel ``knn_per_forward``
    times each forward (a train step runs one), no plain version -> (steps/s,
    events/s of training, events/s of inference, the train run's launches,
    knn_topk's among them)."""
    import numpy as np
    import torch

    from sparseeventid_tpu_torch.train.evaluate import validate
    from sparseeventid_tpu_torch.train.trainer import train

    cfg = train_config(["run.precision=bfloat16", f"run.id={phase}",
                        f"mode.iterations={MODEL_STEPS}",
                        f"run.minibatch_size={train_batch}", *extra], recipe)
    torch.cuda.reset_peak_memory_stats()
    (run, launches, plain_calls, ops), knn = _knn_counted(
        lambda: _counted_dp(lambda: train(cfg, dataset=dataset, device=DEVICE)))
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    history = run.history
    require(len(history) == MODEL_STEPS == run.state.step, f"{phase}: steps")
    for i, m in enumerate(history):
        require(np.isfinite(m["loss/loss"]) and m["overflow/dropped"] == 0,
                f"{phase} step {i}: {m}")
    if per_step is not None:
        expected = {k: v * MODEL_STEPS for k, v in per_step.items()}
        require(launches == expected,
                f"{phase}: launch counts {launches}, expected {expected}")
    require(all(v == 0 for v in plain_calls.values()) and not any(ops.values()),
            f"{phase}: plain version or ops-path kernel on the path: "
            f"{plain_calls}, {ops}")
    want_knn = {"knn_topk": knn_per_forward * MODEL_STEPS, "knn_topk_plain": 0}
    require(knn == want_knn,
            f"{phase}: neighbour search {knn}, expected {want_knn}")
    timed = [m["time/io_s"] + m["time/step_s"] for m in history[1:]]
    steps_per_s = len(timed) / sum(timed)
    del run
    torch.cuda.empty_cache()

    # inference from the run's last checkpoint, after a warm-up batch
    cfg_v = train_config(["mode=inference", "run.precision=bfloat16",
                          f"run.id={phase}", *extra], recipe)
    warm = CachedDataset(grid, {0: dataset.batch(list(range(BATCH)))}, BATCH)
    validate(cfg_v, dataset=warm, device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (metrics, v_launches, v_plain, v_ops), v_knn = _knn_counted(
        lambda: _counted_dp(
            lambda: validate(cfg_v, dataset=dataset, device=DEVICE)))
    seconds = time.perf_counter() - t0
    require(np.isfinite(metrics["loss/loss"]) and metrics["overflow/dropped"] == 0,
            f"{phase} inference: {metrics}")
    n_batches = len(dataset) // BATCH
    if per_forward is not None:
        expected = {k: v * n_batches for k, v in per_forward.items()}
        require(v_launches == expected,
                f"{phase} inference: launch counts {v_launches}, expected {expected}")
    require(all(v == 0 for v in v_plain.values()) and not any(v_ops.values()),
            f"{phase} inference: plain version or ops-path kernel on the path: "
            f"{v_plain}, {v_ops}")
    want_knn = {"knn_topk": knn_per_forward * n_batches, "knn_topk_plain": 0}
    require(v_knn == want_knn,
            f"{phase} inference: neighbour search {v_knn}, expected {want_knn}")
    events_per_s = n_batches * BATCH / seconds
    emit({"phase": phase, "recipe": recipe, "steps": MODEL_STEPS,
          "train_batch": train_batch,
          "io_s": [m["time/io_s"] for m in history],
          "step_s": [m["time/step_s"] for m in history],
          "loss": [m["loss/loss"] for m in history], "launches": launches,
          "train_peak_mem_gib": train_peak, "inference_metrics": metrics,
          "knn_launches": knn["knn_topk"],
          "inference_knn_launches": v_knn["knn_topk"],
          "inference_launches": v_launches, "inference_batch": BATCH,
          "inference_seconds": seconds,
          "inference_peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    print(json.dumps({f"{phase}_steps_per_s": steps_per_s,
                      f"{phase}_train_events_per_s": steps_per_s * train_batch,
                      f"{phase}_inference_events_per_s": events_per_s,
                      "train_peak_mem_gib": train_peak,
                      "timed_steps": len(timed), "precision": "bfloat16"}),
          flush=True)
    STEPS_PER_S[phase] = steps_per_s
    return {**launches, **ops, "knn_topk": knn["knn_topk"]}


def phase_groupnorm(dataset):
    """dune3d with encoder.normalization=group through train and validate
    on host plans (the launch counts of the batch-norm model), the fp32
    window-vs-plain logits and gradients; normalization=layer, the same
    function, forward only -> the train run's launches."""
    no_bn = norm_launches(0, 0)
    launches = train_and_validate(
        "groupnorm", ["encoder.normalization=group"], dataset, GRID,
        per_step={**LAUNCHES_PER_TRAIN_STEP_HOST, **no_bn},
        per_forward={**LAUNCHES_PER_FORWARD_HOST, **no_bn})
    _fp32_window_vs_plain("groupnorm", ["encoder.normalization=group"],
                          dataset, GRID)
    _fp32_window_vs_plain("layernorm", ["encoder.normalization=layer"],
                          dataset, GRID, gradients=False)
    return launches


def phase_per_label(dataset_2d):
    """dune2d with encoder.per_label_final_series=true through train and
    validate: every label's series on one plan built on the card from the
    encoded sites (window_plan once a forward, on host plans too); fp32
    window-vs-plain logits -> the train run's launches."""
    import torch

    from sparseeventid_tpu_torch.models import build_sparse_classifier, init_parameters
    from sparseeventid_tpu_torch.train.evaluate import prepare_batch

    extra = ["encoder.per_label_final_series=true"]
    launches = train_and_validate(
        "per_label", extra, dataset_2d, GRID_2D, "dune2d",
        per_step=LAUNCHES_PER_TRAIN_STEP_PER_LABEL,
        per_forward=LAUNCHES_PER_FORWARD_PER_LABEL)
    _fp32_window_vs_plain("per_label", extra, dataset_2d, GRID_2D, "dune2d",
                          gradients=False)
    # the window_plan launches of one forward on host plans
    cfg = train_config(["run.precision=bfloat16", *extra], "dune2d")
    model = init_parameters(build_sparse_classifier(cfg), SEED).to(DEVICE).eval()
    batch = dataset_2d.batch([0])
    st, _ = prepare_batch(batch, GRID_2D, model.encoder.capacities[0],
                          torch.bfloat16, torch.device(DEVICE))
    plans = host_plans(model, batch["image"], GRID_2D, st)
    with torch.no_grad():
        _, one, _ = _counted(lambda: model(st, plans=plans))
    emit({"phase": "per_label_forward", "plans": "host",
          "label_kernel": list(model.label_kernel), "launches": one})
    require(one == LAUNCHES_PER_FORWARD_PER_LABEL,
            f"per_label: one forward's launches {one}")
    return launches


def phase_remat(dataset):
    """framework.remat on and off at dune3d width, bf16, host plans: one
    forward and backward of batch 0 from the same weights with the same
    dropout draws gives the same bits in every conv weight gradient and
    every running statistic, the recomputation's launches counted; then
    MODEL_STEPS steps through train for each, steps/s and peak GiB ->
    the remat step's launches."""
    import torch

    from sparseeventid_tpu_torch.train.evaluate import (
        class_weights_of,
        prepare_batch,
    )
    from sparseeventid_tpu_torch.train.losses import multi_head_loss
    from sparseeventid_tpu_torch.train.trainer import build_training, train

    dev = torch.device(DEVICE)
    batch = dataset.batch([0])
    result, report = {}, {"phase": "remat", "plans": "host"}
    for remat in (True, False):
        cfg = train_config(["run.precision=bfloat16",
                            f"framework.remat={str(remat).lower()}"])
        state, _, _ = build_training(cfg, N_BATCHES, None, dev)
        model = state.model
        require(model.encoder.remat == remat, "remat not taken from the config")
        scheme = cfg.mode.optimizer.loss_balance_scheme
        st, labels = prepare_batch(batch, GRID, model.encoder.capacities[0],
                                   torch.bfloat16, dev)
        plans = host_plans(model, batch["image"], GRID, st)

        def one_step():
            model.train()
            gen = torch.Generator(device=dev).manual_seed(SEED + 2)
            logits, _ = model(st, gen, plans)
            loss, _ = multi_head_loss(logits, labels, scheme,
                                      class_weights_of(scheme, dev))
            loss.backward()

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _, launches, _, ops = _counted_dp(one_step)
        require(not any(ops.values()), f"remat: ops-path kernel launched: {ops}")
        key = "on" if remat else "off"
        report[f"step_peak_gib_{key}"] = torch.cuda.max_memory_allocated() / 2**30
        report[f"step_activation_peak_gib_{key}"] = (
            torch.cuda.max_memory_allocated() - base) / 2**30
        report[f"launches_{key}"] = launches
        result[key] = ({n: p.grad.detach().clone()
                        for n, p in model.named_parameters() if p.grad is not None},
                       {n: b.clone() for n, b in model.named_buffers()},
                       {n for n, p in model.named_parameters() if p.dim() == 3})
        del state, model
        torch.cuda.empty_cache()
    (g_on, b_on, conv), (g_off, b_off, _) = result["on"], result["off"]
    differ = sorted(n for n in g_on if not torch.equal(g_on[n], g_off[n]))
    stats_differ = sorted(n for n in b_on if not torch.equal(b_on[n], b_off[n]))
    report.update(gradients=len(g_on), conv_weights=len(conv),
                  gradients_differ=len(differ),
                  conv_weights_differ=len([n for n in differ if n in conv]),
                  running_stats=len(b_on), running_stats_differ=len(stats_differ))
    for remat in (True, False):
        key = "on" if remat else "off"
        cfg = train_config(["run.precision=bfloat16", f"run.id=remat_{key}",
                            f"mode.iterations={MODEL_STEPS}",
                            f"framework.remat={str(remat).lower()}"])
        torch.cuda.reset_peak_memory_stats()
        run = train(cfg, dataset=dataset, device=DEVICE)
        timed = [m["time/io_s"] + m["time/step_s"] for m in run.history[1:]]
        report[f"train_steps_per_s_{key}"] = len(timed) / sum(timed)
        report[f"train_peak_mem_gib_{key}"] = (torch.cuda.max_memory_allocated()
                                               / 2**30)
        require(all(m["overflow/dropped"] == 0 for m in run.history),
                f"remat {key}: dropped")
        del run
        torch.cuda.empty_cache()
    emit(report)
    print(json.dumps({"remat_steps_per_s_on": report["train_steps_per_s_on"],
                      "remat_steps_per_s_off": report["train_steps_per_s_off"],
                      "remat_peak_gib_on": report["train_peak_mem_gib_on"],
                      "remat_peak_gib_off": report["train_peak_mem_gib_off"]}),
          flush=True)
    require(len(conv) == 55 and not report["conv_weights_differ"]
            and not stats_differ,
            f"remat changes bits: gradients {differ[:10]}, statistics "
            f"{stats_differ[:10]}")
    require(report["launches_on"] == LAUNCHES_PER_TRAIN_STEP_HOST
            and report["launches_off"] == {
                **LAUNCHES_PER_TRAIN_STEP_NO_REMAT, "window_plan": 0},
            f"remat launches: on {report['launches_on']}, off "
            f"{report['launches_off']}")
    return {**report["launches_on"], **{k: 0 for k in OPS_KERNELS}}


class SlicedDataset:
    """A CachedDataset's events in batches of any size that divides BATCH
    (the train runs of the dense family take fewer events a step)."""

    def __init__(self, cached):
        self.cached = cached

    def __len__(self):
        return len(self.cached)

    def batch_grid(self):
        return self.cached.batch_grid()

    def batch(self, indices):
        first = indices[0] - indices[0] % BATCH
        rows = [i - first for i in indices]
        return {k: v[rows] for k, v in self.cached.batch([first]).items()}


class PlaneAxisDataset(SlicedDataset):
    """dune2d events as the dense family's input transform reads them: each
    pixel of [B, planes, N, 3] (x, y, value) becomes a voxel (plane, y, x,
    value) of the plane-axis grid (planes, H, W), the layout of the sparse
    2D transform; pixels outside the grid are dropped as there."""

    def batch(self, indices):
        import numpy as np

        out = super().batch(indices)
        image = out["image"]
        b, planes, n, _ = image.shape
        h, w = self.batch_grid()[1:]
        x, y, v = image[..., 0], image[..., 1], image[..., 2]
        valid = ((x != -999.0) & (y != -999.0) & (v != -999.0)
                 & (y >= 0) & (y < h) & (x >= 0) & (x < w))
        plane = np.broadcast_to(np.arange(planes)[None, :, None], (b, planes, n))
        voxels = np.stack([plane, y, x, v], axis=-1).astype(np.float32)
        voxels[~valid] = -999.0
        out["image"] = voxels.reshape(b, planes * n, 4)
        return out


def _card_against_cpu(phase, model, inputs, modes=("eval", "train"),
                      neighbours=False):
    """The logits of ``model`` (the card's weights) on the card and of its
    copy on the CPU from the same weights, in each of ``modes``, TF32 off
    -> the report row; rtol = atol = DENSE_COMPARE_TOL.  ``neighbours``
    (DGCNN): the CPU's pass takes each stage's neighbour lists from the
    card's pass, so the logits compare the arithmetic around the search;
    its own lists are searched beside them and their rows that differ are
    reported by stage, the first stage's (integer coordinates, exact
    distances) required equal.  Stages 1-3 search real-valued features in
    which the two devices' rounding flips near ties, as it did with the
    plain search on both sides."""
    import copy

    import torch

    from sparseeventid_tpu_torch.config.schema import OUTPUT_SHAPE
    from sparseeventid_tpu_torch.models import dgcnn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = copy.deepcopy(model).cpu()
    search = dgcnn.knn_indices
    lists, differ = [], []

    def card_search(x, mask, k):
        lists.append(search(x, mask, k))
        return lists[-1]

    def cpu_search(x, mask, k):
        idx = lists.pop(0).to(x.device)
        differ.append(int((search(x, mask, k) != idx).any(-1)[mask].sum()))
        return idx

    row = {}
    for mode in modes:
        outs = []
        differ.clear()
        for m, dev, spy in ((model, DEVICE, card_search),
                            (cpu, "cpu", cpu_search)):
            m.train(mode == "train")
            x = ([t.to(dev) for t in inputs] if isinstance(inputs, tuple)
                 else inputs.to(dev))
            if neighbours:
                dgcnn.knn_indices = spy
            try:
                with torch.no_grad():
                    lg, _ = m(tuple(x) if isinstance(inputs, tuple) else x)
            finally:
                dgcnn.knn_indices = search
            outs.append(torch.cat([lg[k] for k in OUTPUT_SHAPE], 1).cpu())
        card, ref = outs
        row[mode] = {"max_abs_diff": float((card - ref).abs().max()),
                     "max_abs": float(ref.abs().max()),
                     "within": torch.allclose(card, ref, rtol=DENSE_COMPARE_TOL,
                                              atol=DENSE_COMPARE_TOL)}
        if neighbours:
            row[mode].update(rows_differ_by_stage=list(differ),
                             within=row[mode]["within"] and not lists
                             and differ[0] == 0)
    emit({"phase": f"{phase}_card_vs_cpu", "tf32": False, **row})
    for mode, r in row.items():
        require(r["within"], f"{phase}: card against CPU ({mode}): {r}")


def phase_dense(dataset_2d):
    """framework.mode=dense, flax's fp32 rules, TF32 off as the family sets
    it: dune2d-grid inference (B=8) and training (DENSE_TRAIN_BATCH_2D)
    through validate and train on plane-axis images; 3D at DENSE_GRID_3D;
    the card against the CPU on small inputs -> launches (none)."""
    import torch

    from sparseeventid_tpu_torch.config import load_config
    from sparseeventid_tpu_torch.io import SyntheticDataset, SyntheticEventConfig
    from sparseeventid_tpu_torch.models import build_model, init_parameters

    dense = ["framework.mode=dense"]
    launches = train_and_validate(
        "dense2d", dense, PlaneAxisDataset(dataset_2d), GRID_2D, "dune2d",
        per_step=NO_LAUNCHES, per_forward=NO_LAUNCHES,
        train_batch=DENSE_TRAIN_BATCH_2D)
    require(not torch.backends.cudnn.allow_tf32, "dense: TF32 left on")
    ds3 = SyntheticDataset(
        BATCH * N_BATCHES,
        SyntheticEventConfig(image_size=DENSE_GRID_3D, max_voxels=MAX_VOXELS,
                             mean_tracks=20.0, steps_per_track=300),
        seed=SEED)
    cached = CachedDataset(DENSE_GRID_3D, {
        i: ds3.batch(list(range(i, i + BATCH)))
        for i in range(0, BATCH * N_BATCHES, BATCH)}, BATCH * N_BATCHES)
    train_and_validate("dense3d", dense, SlicedDataset(cached), DENSE_GRID_3D,
                       per_step=NO_LAUNCHES, per_forward=NO_LAUNCHES,
                       train_batch=DENSE_TRAIN_BATCH_3D)
    gen = torch.Generator().manual_seed(SEED)
    for recipe, shape in (("dune3d", (2, 16, 16, 16, 1)),
                          ("dune2d", (2, 3, 32, 32, 1))):
        cfg = load_config(recipe, [*dense, "head.dropout=0.0"])
        model, mode = build_model(cfg)
        require(mode == "dense", f"dense: build_model gave {mode}")
        init_parameters(model, SEED).to(DEVICE)
        x = torch.rand(shape, generator=gen) * (torch.rand(shape, generator=gen) < 0.2)
        # eval mode only: at depth 5 a small grid's last levels hold 1 to 8
        # cells an event, and train-mode statistics over so few values
        # turn float32 rounding into differences of the logits' own size
        _card_against_cpu(f"dense_{recipe}", model, x, modes=("eval",))
    return launches


def phase_points(dataset, encoder):
    """encoder=pointnet|dgcnn on dune3d batches (max_points 2048 a cloud):
    train and validate at bf16 (finite; no sparse-conv kernel launched;
    DGCNN launches csrc/knn.cu's kernel KNN_PER_DGCNN_FORWARD times a
    forward, on the bf16 points of its first stage too, PointNet never),
    the card against the CPU from the same weights on
    POINTS_COMPARE_EVENTS clouds of integer coordinates and values (DGCNN's
    CPU pass on the card's neighbour lists, its first stage's own lists
    equal to them); for DGCNN, knn_indices on the card equal to the CPU's
    there, ties included -> the train run's launches (knn_topk's among
    them)."""
    import numpy as np
    import torch

    from sparseeventid_tpu_torch.io import larcv_batch_to_pointcloud
    from sparseeventid_tpu_torch.models import build_model, init_parameters

    launches = train_and_validate(
        encoder, [f"encoder={encoder}"], dataset, GRID,
        per_step=NO_LAUNCHES, per_forward=NO_LAUNCHES,
        knn_per_forward=KNN_PER_DGCNN_FORWARD if encoder == "dgcnn" else 0)
    cfg = train_config([f"encoder={encoder}", "head.dropout=0.0"])
    model, mode = build_model(cfg)
    require(mode == "points", f"{encoder}: build_model gave {mode}")
    init_parameters(model, SEED).to(DEVICE)
    image = dataset.batch([0])["image"][:POINTS_COMPARE_EVENTS].copy()
    image[..., -1] = np.where(image[..., -1] == -999.0, -999.0,
                              np.round(image[..., -1] * 4.0))
    pts, mask = larcv_batch_to_pointcloud(image, cfg.encoder.max_points)
    x = (torch.from_numpy(pts), torch.from_numpy(mask))
    _card_against_cpu(encoder, model, x, neighbours=encoder == "dgcnn")
    if encoder == "dgcnn":
        from sparseeventid_tpu_torch.models.dgcnn import knn_indices

        k = cfg.encoder.k
        card = knn_indices(x[0].to(DEVICE), x[1].to(DEVICE), k).cpu()
        cpu = knn_indices(*x, k)
        d = ((pts[:, :, None, :] - pts[:, None, :, :]) ** 2).sum(-1)
        kth = np.sort(np.where(mask[:, None, :], d, 1e9), -1)[..., k - 1:k + 1]
        ties = int((kth[..., 0] == kth[..., 1])[mask].sum())
        emit({"phase": "dgcnn_knn", "points": int(mask.sum()), "k": k,
              "equal": bool(torch.equal(card, cpu)),
              "points_tied_at_k": ties})
        require(torch.equal(card, cpu), "dgcnn: knn_indices differ on the card")
        require(ties > 0, "dgcnn: no tie at the k-th neighbour to test")
    return launches


def _knn_clouds(f, integer):
    """KNN_B clouds [KNN_B, KNN_P, f] and their mask.  ``integer``: values
    in [-3, 3] (ties everywhere), cloud 1 with every third point padded,
    cloud 2 of 15 valid points, the padded rows junk; otherwise uniform
    real values (the first stage's scale at f = 4, unit normal beyond),
    all valid."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + f)
    shape = (KNN_B, KNN_P, f)
    mask = torch.ones(shape[:2], dtype=torch.bool, device=DEVICE)
    if integer:
        x = torch.randint(-3, 4, shape, generator=gen, device=DEVICE).float()
        mask[1, ::3] = False
        mask[2, 15:] = False
    elif f == 4:
        x = torch.rand(shape, generator=gen, device=DEVICE) * 1024.0
    else:
        x = torch.randn(shape, generator=gen, device=DEVICE)
    return x, mask


def _neighbour_distances(x, idx):
    """float64 squared distances [B, P, k] of each point to its ``idx``,
    sorted per row."""
    import torch

    x64 = x.double()
    b = torch.arange(x.shape[0], device=x.device)[:, None, None]
    d = ((x64[b, idx] - x64[:, :, None, :]) ** 2).sum(-1)
    return d.sort(dim=-1).values


def phase_knn_kernels():
    """csrc/knn.cu's knn_topk at KNN_B x KNN_P, k = KNN_K, F in
    KNN_FEATURES: on integer-valued clouds (ties, padding, a cloud of 15
    points) the plain version's indices bit for bit; on real-valued ones
    each row's float64 neighbour distances within KNN_REAL_TOL of the
    plain version's; ms, the bound (2 B P^2 F operations at the float32
    peak, B P (4F + 1 + 8k) bytes), the plain version's ms and the
    library's (torch.topk on the materialised distances) -> the rows."""
    import torch

    from sparseeventid_tpu_torch.ops import knn_kernels as KNN

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for f in KNN_FEATURES:
        x, mask = _knn_clouds(f, integer=True)
        got = KNN.knn_topk(x, mask, KNN_K)
        want = KNN.knn_topk_plain(x, mask, KNN_K)
        equal = bool(torch.equal(got, want))
        short = bool(torch.equal(
            got[2, :, 15:], torch.arange(15, KNN_K, device=DEVICE)
            .expand(KNN_P, KNN_K - 15)))
        del got, want
        xr, mr = _knn_clouds(f, integer=False)
        got = KNN.knn_topk(xr, mr, KNN_K)
        want = KNN.knn_topk_plain(xr, mr, KNN_K)
        rows_equal = float((got == want).all(-1).float().mean())
        dk, dp = _neighbour_distances(xr, got), _neighbour_distances(xr, want)
        gap = float((dk - dp).abs().max()) / float(dp.max())
        del got, want, dk, dp
        ms = timed_ms(lambda: KNN.knn_topk(xr, mr, KNN_K))
        plain_ms = timed_ms(lambda: KNN.knn_topk_plain(xr, mr, KNN_K),
                            iters=2, warmup=1, graph=False)
        sq = (xr * xr).sum(-1)
        dist = sq[..., :, None] - 2.0 * xr @ xr.transpose(1, 2) + sq[..., None, :]
        library_ms = timed_ms(
            lambda: torch.topk(dist, KNN_K, dim=-1, largest=False),
            iters=3, warmup=1, graph=False)
        del dist, sq
        b_ms, b_by = bound(KNN_B * KNN_P * (4 * f + 1 + 8 * KNN_K),
                           2.0 * KNN_B * KNN_P * KNN_P * f, torch.float32)
        row = dict(shape=f"B={KNN_B} P={KNN_P} k={KNN_K} F={f}",
                   features=f, integer_equal=equal, short_cloud_fill=short,
                   real_rows_equal=rows_equal, real_gap=gap,
                   real_tol=KNN_REAL_TOL, max_abs_err=0.0, ms=ms,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=library_ms)
        emit({"phase": "knn_kernel", **row})
        require(equal and short,
                f"knn_topk F={f}: integer clouds differ from the plain "
                f"version: {row}")
        require(gap <= KNN_REAL_TOL,
                f"knn_topk F={f}: real-valued neighbours beyond rounding: {row}")
        rows.append(row)
        del x, mask, xr, mr
        torch.cuda.empty_cache()
    return rows


def knn_kernel_row(knn_rows, model_launches) -> dict:
    """The neighbour search's entry of the kernels line: its headline the
    last stage's width, its launches those of the dgcnn train run."""
    head = knn_rows[-1]
    return dict(
        name="knn_topk", route="cuda",
        source="sparseeventid_tpu_torch/csrc/knn.cu",
        replaces="sparseeventid_tpu/models/dgcnn.py:26",
        launches=model_launches["dgcnn"]["knn_topk"], path="dgcnn",
        **{f"launches_{m}": counts.get("knn_topk", 0)
           for m, counts in model_launches.items()},
        max_abs_err=0.0, ms=head["ms"], plain_ms=head["plain_ms"],
        bound_ms=head["bound_ms"], bound_by=head["bound_by"],
        library_ms=head["library_ms"], shape=head["shape"], shapes=knn_rows)


SWEEP_TOL = 1e-4  # window output against the xla backend and cuDNN, of the scale


def _sweep_check(row, run) -> dict:
    """One row of the sweep with K > 1: no dropped pair, and the window
    backend's output at the live sites against the ``xla`` rulebook backend
    and against cuDNN's dense conv of the same sites with the same weights
    laid out as a dense kernel (fp32, TF32 off) -> the errors."""
    import torch
    import torch.nn.functional as F

    from sparseeventid_tpu_torch.ops import engine as E
    from sparseeventid_tpu_torch.ops import to_dense
    from sparseeventid_tpu_torch.scripts import sparse_efficiency as S

    dim, k = run.case.dim, run.kernel
    ksz = (k,) * dim
    label = f"sweep {dim}-D {_kname(ksz)} at {run.case.n} sites"
    require(row["dropped"] == 0, f"{label}: {row['dropped']} pairs dropped")
    live = run.st.row_mask()[0]
    got = run.out[0][live]
    rulebook = S.build_plan(run.st, ksz, E.XLA)
    ref = E.apply_submanifold(run.st, rulebook, run.w).feats[0][live]
    # the offsets in row-major order are the dense kernel's taps (cuDNN's
    # cross-correlation, no flip): weight[co, c, *tap] = w[k(tap), c, co]
    c, co = run.w.shape[1:]
    wd = run.w.reshape(*ksz, c, co).permute(dim + 1, dim, *range(dim))
    conv = F.conv2d if dim == 2 else F.conv3d
    dense = conv(to_dense(run.st).movedim(-1, 1).contiguous(),
                 wd.contiguous(), padding="same")
    at = dense[0].movedim(0, -1)[tuple(run.st.coords[0][live].long().T)]
    scale = float(ref.abs().max())
    errs = dict(scale=scale, err_xla=float((got - ref).abs().max()),
                err_dense=float((got - at).abs().max()))
    for what in ("xla", "dense"):
        require(errs[f"err_{what}"] <= SWEEP_TOL * scale,
                f"{label}: the window output differs from the {what} conv by "
                f"{errs[f'err_{what}']}, more than {SWEEP_TOL} of {scale}")
    return errs


def _sweep_kernel_rows(run) -> dict:
    """Kernels 1-3 at one sweep row's shapes (fp32, C = CO = 8): each
    bit-equal to its plain version on integer-valued fp32 data (the
    sidecar in bf16 too), window_plan also to the row's plan, the batched
    sidecar on the plan's list and on a hand-made list as wide as the
    plan's (rows of up to K entries); timed on the row's real data ->
    {kernel: [row]}."""
    import torch

    from sparseeventid_tpu_torch.ops import rulebook as rb
    from sparseeventid_tpu_torch.ops.window import kernels as K
    from sparseeventid_tpu_torch.ops.window import query as Q
    from sparseeventid_tpu_torch.ops.window.sidecar import overflow_apply_batched

    st, plan, w = run.st, run.plan, run.w
    dim, k = run.case.dim, run.kernel
    ksz = (k,) * dim
    label = f"sweep {dim}-D {_kname(ksz)} 8->8 fp32, {run.case.n} sites"
    dev = st.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    offs = rb.kernel_offsets(ksz, centered=True)
    keys = st.keys()
    qkeys = Q.compute_query_keys(st, offs)
    n_tab = n_q = int(st.n_active.sum())
    live_tiles = int(((st.n_active + Q.TILE_T - 1) // Q.TILE_T).sum())
    plan_row, start, _ = _plan_row(
        label, (Q._padded_table(keys), qkeys, st.n_active), plan.window_r,
        st.capacity, n_tab, n_q, keys, qkeys)
    require(torch.equal(start, plan.start),
            f"window_plan differs from the sweep's plan at {label}")
    full = rb.build_submanifold_rulebook(st, ksz)
    live = st.row_mask()[..., None]
    x_int = (_int_like(st.feats.shape, gen, dev, torch.float32) * live
             ).contiguous()
    w_int = _int_like(w.shape, gen, dev, torch.float32)
    conv_row, out_int = _conv_row(
        label, keys, plan, start, st.n_active, n_tab, n_q, live_tiles,
        full.neighbor_idx.long().reshape(1, -1), full.hit.reshape(1, -1, 1),
        int(full.hit.sum()) - int(plan.ov_valid.sum()), x_int, w_int,
        st.feats, w)
    width = plan.ov_valid.shape[1]
    lists = {
        "plan's list": (plan.ov_src, plan.ov_dst, plan.ov_k, plan.ov_valid,
                        K._ov_bound(plan.ov_valid)),
        "hand-made list": _handmade_lists([n_q], [n_tab], len(offs), width,
                                          SEED + 13),
    }
    base = K.window_conv_apply(keys, st.feats, plan.qmeta, start, w,
                               st.n_active, plan.dkeys, window_r=plan.window_r)
    side_rows = []
    for what, lst in lists.items():
        require(K.overflow_dst_ordered(lst[1], lst[4]),
                f"the {what}'s dst is out of order at {label}")
        side_rows.append(_sidecar_checks(
            label, overflow_apply_batched, {what: lst}, (out_int, x_int, w_int),
            (base, st.feats, w), st.capacity, st.capacity))
    require(side_rows[-1]["entries"] > 0, f"the hand-made list is empty at {label}")
    rows = {"window_plan": [plan_row], "window_conv_apply": [conv_row],
            "overflow_apply_batched": side_rows}
    emit({"phase": "sweep_kernels", "shape": label, "rows": rows})
    return rows


def phase_sparse_efficiency():
    """The port's sparse-vs-dense sweep (scripts/sparse_efficiency.py), its
    full default: 2-D and 3-D grids of 256 a side, K = 1, 3, 5, six
    sparsities, uniform random sites at a capacity of 65536, fp32 at 8 -> 8
    channels, through ``sparse_efficiency.sweep`` on the card.  Every row
    with K > 1: 0 dropped, the window output against the xla backend and
    cuDNN (``_sweep_check``).  The launches of the run are required (a plan
    a row of K > 1; a conv and a batched sidecar a timed call and its
    warm-up; no plain version).  Then kernels 1-3 at the densest 2-D K = 25
    and 3-D K = 125 rows against their plain versions, timed ->
    (launches of every kernel, {kernel: rows})."""
    from sparseeventid_tpu_torch.scripts import sparse_efficiency as S

    t0 = time.perf_counter()
    densest = {}

    def on_row(row, run):
        extra = {}
        if run.kernel > 1:
            extra = {**_sweep_check(row, run), **S.list_occupancy(run.plan)}
            if run.kernel == 5:  # a later row of a dim is at least as dense
                densest[run.case.dim] = run
        emit({"phase": "sparse_efficiency", **row, **extra})

    rows, launches, plain_calls, ops = _counted_dp(
        lambda: S.sweep(on_row=on_row))
    launches.update(ops)
    require(len(rows) == 36, f"the sweep gave {len(rows)} rows, not 36")
    require(all(r["dropped"] == 0 for r in rows), "the sweep dropped pairs")
    require(not any(plain_calls.values()),
            f"the sweep called plain versions: {plain_calls}")
    n_plans = sum(r["kernel"] > 1 for r in rows)
    want = {name: 0 for name in (*REPLACES, *NORM_WRAPPERS)}
    want.update(window_plan=n_plans,
                window_conv_apply=n_plans * (S.ITERS + 1),
                overflow_apply_batched=n_plans * (S.ITERS + 1))
    require(launches == want,
            f"sweep launches {launches}, expected {want}")
    sweep_s = time.perf_counter() - t0
    kernel_rows = {}
    for dim in sorted(densest):
        for name, per in _sweep_kernel_rows(densest[dim]).items():
            kernel_rows.setdefault(name, []).extend(per)
    emit({"phase": "sparse_efficiency_total", "rows": len(rows),
          "sweep_seconds": sweep_s, "seconds": time.perf_counter() - t0,
          "launches": launches})
    return launches, kernel_rows


# the bench phase's reduced counts (the drivers' defaults: bench 24 warm-up
# steps, blocks of 10, 5 + 3 blocks; bench_e2e 128 events, 3 warm epochs;
# bench_extra 6 warm-up steps, 3 blocks of 10)
BENCH_ARGS = ["--warmup", "3", "--iters", "3", "--blocks", "2",
              "--extra-blocks", "1"]
BENCH_E2E_ARGS = ["--events", "32", "--warm-epochs", "1"]
BENCH_EXTRA_ARGS = ["--warmup", "2", "--iters", "3", "--blocks", "2"]


def phase_bench():
    """The port's three benchmark drivers (scripts/bench.py, bench_e2e.py,
    bench_extra.py) in this process, through their ``main`` at their
    default widths and reduced counts: both regimes of bench, bench_e2e's
    cold, warm and device-only loops on 32 events, all seven configs of
    bench_extra.  Every line: 0 dropped, rates above 0; bench's
    ``mfu_useful`` in (0, 1]; the data route "memory" where h5py does not
    import.  Host plans everywhere: no window_plan launch, every other
    kernel of the train step launched, no plain version called ->
    launches by kernel."""
    from sparseeventid_tpu_torch.scripts import bench, bench_e2e, bench_extra

    t0 = time.perf_counter()
    route = bench.data_route()

    def run_all():
        lines = [bench.main(BENCH_ARGS)]
        lines.append(bench_e2e.main(
            BENCH_E2E_ARGS + ["--out", str(RUN_DIR / "bench_e2e.json")]))
        lines.extend(bench_extra.main(BENCH_EXTRA_ARGS))
        return lines

    lines, launches, plain_calls, ops = _counted_dp(run_all)
    launches.update(ops)
    head = lines[0]
    require(0 < head["mfu_useful"] <= 1,
            f"bench: mfu_useful {head['mfu_useful']} outside (0, 1]")
    require(head["peak_tflops"] == bench.PEAK_BF16_TFLOPS.get(head["device"]),
            f"bench: peak {head['peak_tflops']} is not the card's own")
    rows = [head, head["regime_36k"], *lines[1:]]
    for row in rows:
        require(row["overflow_dropped"] == 0, f"bench: dropped pairs {row}")
        rates = [row["value"], *row.get("blocks", []),
                 *row.get("warm_epoch_blocks", []),
                 *row.get("device_only_blocks", [])]
        require(min(rates) > 0, f"bench: a rate is not above 0: {row}")
    for row in lines[1:]:
        require(row["data"] == route,
                f"bench: data {row['data']}, expected {route}")
    require(len(lines) == 2 + len(bench_extra.CONFIGS),
            f"bench: {len(lines)} lines")
    require(not any(plain_calls.values()),
            f"bench called plain versions: {plain_calls}")
    require(launches["window_plan"] == 0,
            f"bench: window_plan launched on host plans: {launches}")
    require(all(launches[k] > 0 for k in LAUNCHES_PER_TRAIN_STEP
                if k != "window_plan"),
            f"bench: a kernel of the train step never launched: {launches}")
    emit({"phase": "bench_total", "seconds": time.perf_counter() - t0,
          "data": route, "launches": launches})
    return launches


# the accuracy phase's reduced counts (the script's defaults: 1500 window
# steps, 300 xla steps and 300 matched window steps, resume 120 -> 240)
ACCURACY_ARGS = ["--steps", "100", "--xla-steps", "50"]
ACCURACY_RESUME = (20, 40)
ACCURACY_STEP0_DLOSS = 0.01  # window against xla at step 0: float order only
# the small preset's model (depth 3, 2 blocks a level, filters 16 -> 64,
# remat off): 11 plans (1 initial + 4 series + 3 x 2 strided), 20 convs
# (1 + 4 x 2 x 2 + 3), 19 with C > 1; 19 batch norms (4 x 2 x 2 + 3)
LAUNCHES_PER_SMALL_FORWARD = {
    "window_plan": 0, "window_conv_apply": 20, "overflow_apply_batched": 19,
    "overflow_apply": 1, "window_bwd_strided": 0, "window_dw": 0,
    "overflow_dw_batched": 0, "overflow_dw": 0,
    **norm_launches(19, 0, stats=0),
}
LAUNCHES_PER_SMALL_STEP = {
    **LAUNCHES_PER_SMALL_FORWARD, "overflow_apply_batched": 38,
    "window_bwd_strided": 19, "window_dw": 1, "overflow_dw_batched": 19,
    "overflow_dw": 1, **norm_launches(19, 19),
}
# the small preset's kernel rows: 64^3 events of at most 6144 voxels, the
# widths 16 -> 64 (the one- and three-slab tensor-core routes, C = 16, 48
# and 64 sidecars: the plans' lists of levels 2 and 3 are empty, so their
# forward, dX and dW sidecars run on hand-made lists); labels "small ..."
GEOMETRY_SMALL = dict(grid=(64, 64, 64), rows=6144, min_capacity=512,
                      widths=(16, 32, 48, 64), stride=(2, 2, 2),
                      to_sparse="larcv_batch_to_sparse_3d", prefix="small ",
                      initial=(5, 5, 5), series=(3, 3, 3),
                      series_levels=((0, ("apply", "dx", "dw")),
                                     (2, ("apply", "dx", "dw")),
                                     (3, ("apply", "dw"))),
                      downsample_levels=(0, 1, 2),
                      cases=("initial", "L0 series", "L2 series",
                             "L3 series", "L0 downsample", "L1->L2",
                             "L2->L3"))


def make_dataset_small():
    """Batch 0 of the small preset's train split (the accuracy run's
    synthetic events, seeded as the run seeds them)."""
    from sparseeventid_tpu_torch.scripts import accuracy_run as acc
    from sparseeventid_tpu_torch.train.evaluate import build_dataset

    ctx = acc.Context("small", None, RUN_DIR)
    ds = build_dataset(acc.preset_config(ctx, "window", "kernels", 1), "train")
    return CachedDataset(GEOMETRY_SMALL["grid"],
                         {0: ds.batch(list(range(BATCH)))}, BATCH)


def phase_accuracy():
    """The convergence run (scripts/accuracy_run.py) through its ``main``
    in this process at the small preset and reduced counts
    (ACCURACY_ARGS, resume ACCURACY_RESUME): 0 dropped pairs at every
    step of every run, finite losses, the resume pair, the window and xla
    runs' step-0 losses within ACCURACY_STEP0_DLOSS (the same weights and
    batch), each window run's launches exactly its steps' and validation
    batches' (LAUNCHES_PER_SMALL_STEP, _FORWARD) and no plain version, no
    conv kernel in the xla run (its norms run the norm kernels, as many) ->
    the long window run's launches."""
    import math

    from sparseeventid_tpu_torch.scripts import accuracy_run as acc

    t0 = time.perf_counter()
    counted = {}
    real = acc.run_training

    def run_training(ctx, backend, run_id, steps, params=None):
        curves, launches, plain, ops = _counted_dp(
            lambda: real(ctx, backend, run_id, steps, params))
        counted[run_id] = (curves, launches, plain, ops)
        return curves

    acc.run_training = run_training
    resume = acc.RESUME["small"]
    acc.RESUME["small"] = ACCURACY_RESUME
    out = RUN_DIR / "accuracy" / "ACCURACY_smoke.md"
    out.parent.mkdir(parents=True, exist_ok=True)
    try:
        doc = acc.main(ACCURACY_ARGS + [
            "--out", str(out), "--output-dir", str(RUN_DIR / "accuracy")])
    finally:
        acc.run_training = real
        acc.RESUME["small"] = resume
    require(doc["resume"] == {"resumed_at": ACCURACY_RESUME[0],
                              "final_step": ACCURACY_RESUME[1]},
            f"accuracy: resume {doc['resume']}")
    for run_id, summary in doc["runs"].items():
        require(summary["dropped"] == 0,
                f"accuracy: {run_id} dropped {summary['dropped']}")
    points = (doc["window_train"] + doc["window_val"] + doc["xla_train"]
              + doc["window_short_train"])
    require(all(math.isfinite(m["loss/loss"]) for m in points)
            and math.isfinite(doc["window_final"]["loss/loss"]),
            "accuracy: a loss is not finite")
    dloss = abs(doc["window_short_train"][0]["loss/loss"]
                - doc["xla_train"][0]["loss/loss"])
    require(dloss <= ACCURACY_STEP0_DLOSS,
            f"accuracy: step-0 |window - xla| loss {dloss}")
    per_step = {}
    for run_id in ("acc_window", "acc_window_short"):
        curves, launches, plain, ops = counted[run_id]
        want = {k: curves.steps * LAUNCHES_PER_SMALL_STEP[k]
                + curves.eval_batches * LAUNCHES_PER_SMALL_FORWARD[k]
                for k in LAUNCHES_PER_SMALL_STEP}
        require(launches == want,
                f"accuracy: {run_id} launched {launches}, expected {want}")
        require(not any(plain.values()) and not any(ops.values()),
                f"accuracy: {run_id} called plain versions {plain} or "
                f"ops-path kernels {ops}")
        per_step[run_id] = {k: v / curves.steps for k, v in launches.items()}
    # the plain conv backend launches no conv kernel; its batch norms run
    # the norm kernels, as on every route of the card
    curves, launches, plain, ops = counted["acc_xla"]
    norms = {k: launches.pop(k) for k in NORM_WRAPPERS}
    want = {k: curves.steps * LAUNCHES_PER_SMALL_STEP[k]
            + curves.eval_batches * LAUNCHES_PER_SMALL_FORWARD[k]
            for k in NORM_WRAPPERS}
    require(not any(launches.values()) and not any(ops.values())
            and norms == want,
            f"accuracy: the xla run launched port kernels {launches} {ops}, "
            f"norm kernels {norms} (expected {want})")
    final = doc["window_final"]
    emit({"phase": "accuracy", "seconds": time.perf_counter() - t0,
          "args": ACCURACY_ARGS, "resume": doc["resume"],
          "step0_dloss": dloss, "runs": doc["runs"],
          "final": {k: final[k] for k in sorted(final)},
          "n_val_events": doc["n_val_events"],
          "launches_per_step": per_step})
    return {**counted["acc_window"][1], **counted["acc_window"][3]}


def main(argv) -> int:
    global PARENT
    if argv and (argv[0] not in ("--parent", "--dp-rank") or len(argv) != 2):
        print("usage: chip_smoke.py [--parent DIR]", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (HERE / "sparseeventid_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, str(HERE))
    if argv[:1] == ["--dp-rank"]:  # a rank of dp_two_ranks
        try:
            return dp_rank_main(Path(argv[1]))
        except Failure as e:
            print(f"chip_smoke rank: FAILED: {e}", file=sys.stderr)
            return 1
    out_dir = HERE / "output" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    global RUN_DIR
    runs = tempfile.TemporaryDirectory(prefix="chip_smoke_runs_")
    RUN_DIR = Path(runs.name)
    try:
        name, _ = phase_device()
        phase_build()
        if argv:
            PARENT = ParentKernels(argv[1])
        dataset = make_dataset()
        rows = phase_kernels(dataset)
        phase_norm_kernels(dataset)
        for kname, row in zip(("window_plan", "window_conv_apply"),
                              phase_dense_tile()):
            rows[kname].append(row)
        phase_grad_check(dataset)
        phase_host_plans(dataset)
        launches = phase_main(dataset, out_dir)
        device_launches = phase_main(dataset, out_dir, phase="main_device",
                                     host=False)
        train_launches = phase_train(dataset)
        device_train_launches = phase_train(dataset, phase="train_device",
                                            host=False)
        phase_fp32(dataset)
        phase_fp32_grad(dataset)
        for kname, per_shape in phase_gather_kernels(dataset).items():
            rows.setdefault(kname, []).extend(per_shape)
        ops_launches = phase_engine_ops(dataset)
        phase_campaign(dataset)
        task_launches = {"simclr": phase_simclr(dataset)}
        for kname, per_shape in phase_simclr_kernels(dataset).items():
            rows[kname].extend(per_shape)
        task_launches["yolo"] = phase_yolo(dataset)
        task_launches["unsupervised"] = phase_unsupervised(dataset)
        phase_optimizers(dataset)
        phase_profile(dataset)
        phase_fp32_tasks(dataset)
        phase_visualize()
        dp_launches = phase_dp_world1(dataset)
        dp_two_rank_launches = phase_dp_two_ranks()
        knn_rows = phase_knn_kernels()
        t_models = time.perf_counter()
        model_launches = {"groupnorm": phase_groupnorm(dataset),
                          "remat": phase_remat(dataset)}
        for encoder in ("pointnet", "dgcnn"):
            model_launches[encoder] = phase_points(dataset, encoder)
        models_s = time.perf_counter() - t_models
        del dataset
        dataset_2d = make_dataset_2d()
        rows_2d = phase_kernels(dataset_2d, GEOMETRY_2D)
        phase_norm_kernels(dataset_2d, GRID_2D, "dune2d")
        phase_host_plans(dataset_2d, "dune2d", GRID_2D, "host_plans_2d")
        launches_2d = phase_main(dataset_2d, out_dir, "dune2d", GRID_2D,
                                 "main2d")
        phase_main(dataset_2d, out_dir, "dune2d", GRID_2D, "main2d_device",
                   host=False)
        train_launches_2d = phase_train(dataset_2d, "dune2d", GRID_2D,
                                        "train2d")
        phase_train(dataset_2d, "dune2d", GRID_2D, "train2d_device", host=False)
        t_models = time.perf_counter()
        model_launches["per_label"] = phase_per_label(dataset_2d)
        model_launches["dense"] = phase_dense(dataset_2d)
        models_s += time.perf_counter() - t_models
        emit({"phase": "models_total", "seconds": models_s})
        del dataset_2d
        bench_launches = phase_bench()
        rows_small = phase_kernels(make_dataset_small(), GEOMETRY_SMALL)
        accuracy_launches = phase_accuracy()
        # last: the sweep turns TF32 off for the process, as the dense
        # family does
        sweep_launches, sweep_rows = phase_sparse_efficiency()
        kernels = []
        for kname, per_shape in rows.items():
            require(per_shape, f"no measurement of {kname}")
            if kname in OPS_KERNELS:
                head = per_shape[0]
                kernels.append(dict(
                    name=kname, route="cuda", source=SOURCES[kname],
                    replaces=REPLACES[kname], launches=ops_launches[kname],
                    launches_dp=dp_launches[kname],
                    launches_dp_two_ranks=dp_two_rank_launches[kname],
                    **{f"launches_{m}": counts[kname]
                       for m, counts in model_launches.items()},
                    launches_sparse_efficiency=sweep_launches[kname],
                    launches_bench=bench_launches[kname],
                    launches_accuracy=accuracy_launches[kname],
                    path="ops_path (ConvolutionUpsample backward; "
                    "gather_submanifold_conv forward and backward)",
                    max_abs_err=max(r["max_abs_err"] for r in per_shape),
                    ms=head["ms"], plain_ms=head["plain_ms"],
                    bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                    library_ms=head["library_ms"], shape=head["shape"],
                    parent_ms=head.get("parent_ms"), shapes=per_shape,
                ))
                continue
            per_shape = (per_shape + rows_2d[kname] + rows_small[kname]
                         + sweep_rows.get(kname, []))
            # headline: the busiest conv level (level 0) where measured
            head = next(
                (r for r in per_shape if r["shape"].startswith("L0 series")),
                per_shape[0],
            )
            kernels.append(dict(
                name=kname, route="cuda", source=SOURCES[kname],
                replaces=REPLACES[kname],
                # the count of the path that is the kernel's own: the
                # inference run for the forward kernels, the train run for
                # the backward ones; window_plan's is the device-plan
                # inference run, since host plans launch it no time
                launches=(device_launches[kname] if kname == "window_plan"
                          else launches[kname] if kname in FORWARD_KERNELS
                          else train_launches[kname]),
                path=("main_device, train_device (SEID_HOST_PLANS=0)"
                      if kname == "window_plan" else
                      "main, train, main2d, train2d"
                      if kname in FORWARD_KERNELS else "train, train2d"),
                launches_main=launches[kname],
                launches_main_device=device_launches[kname],
                launches_train_device=device_train_launches[kname],
                launches_train=train_launches[kname],
                launches_main2d=launches_2d[kname],
                launches_train2d=train_launches_2d[kname],
                launches_ops_path=ops_launches[kname],
                launches_dp=dp_launches[kname],
                launches_dp_two_ranks=dp_two_rank_launches[kname],
                **{f"launches_{task}": counts[kname]
                   for task, counts in task_launches.items()},
                **{f"launches_{m}": counts[kname]
                   for m, counts in model_launches.items()},
                launches_sparse_efficiency=sweep_launches[kname],
                launches_bench=bench_launches[kname],
                launches_accuracy=accuracy_launches[kname],
                max_abs_err=max(r["max_abs_err"] for r in per_shape),
                ms=head["ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                library_ms=head["library_ms"], shape=head["shape"],
                parent_ms=head.get("parent_ms"), shapes=per_shape,
            ))
        kernels.append(knn_kernel_row(knn_rows, model_launches))
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        runs.cleanup()
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    emit({"norm_kernels": NORM_ROWS})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
