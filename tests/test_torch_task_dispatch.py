"""All four tasks through the port's command line on the CPU, as
tests/test_task_dispatch.py drives the JAX package's: supervised_eventID,
simclr, yolo and unsupervised_eventID train three steps; yolo inference
writes its per-event outputs; an unknown task is refused; visualize writes
event displays; run.profile leaves a trace; and a SimCLR run's encoder
carries into a supervised run."""

import json

import numpy as np
import pytest
import torch

from sparseeventid_tpu_torch.__main__ import main
from sparseeventid_tpu_torch.config import load_config
from sparseeventid_tpu_torch.train.evaluate import build_dataset, run_dir
from sparseeventid_tpu_torch.train.tasks import build_task

TINY = [
    "encoder.depth=2",
    "encoder.blocks_per_layer=1",
    "encoder.n_initial_filters=8",
    "encoder.n_output_filters=16",
    "framework.min_capacity=64",
    "run.minibatch_size=2",
    "run.compute_mode=CPU",
    "mode.iterations=3",
    "mode.checkpoint_iteration=100",
    "data.max_voxels=256",
    "data.synthetic_events=8",
    # the main path: window kernels (their plain versions on the CPU) on
    # plans built on the host
    "framework.sparse_backend=window",
]
SIMCLR = ("data.transform1=true", "data.transform2=true")


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(tmp_path, name, extra=()):
    return main(["--config-name", "synthetic", f"name={name}",
                 f"output_dir={tmp_path}", *TINY, *extra])


@pytest.mark.parametrize("task,extra,keys", [
    ("supervised_eventID", (), ("acc/labelneutID",)),
    ("simclr", SIMCLR, ("acc/top1", "acc/top5")),
    ("yolo", (), ("loss/objectness", "loss/offset", "loss/event",
                  "vertex/frac_10cm")),
    ("unsupervised_eventID", (), ("acc/weak_label",)),
])
def test_task_trains_via_cli_dispatch(tmp_path, capsys, one_torch_thread,
                                      task, extra, keys):
    metrics = _run(tmp_path, task, extra)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == metrics
    assert np.isfinite(metrics["loss/loss"]) and metrics["overflow/dropped"] == 0
    for k in keys:
        assert np.isfinite(metrics[k]), k
    index = (tmp_path / "synthetic" / "debug" / "checkpoints" / "checkpoint")
    assert index.read_text().splitlines()[0] == "latest: step_3.pt"


def test_yolo_inference_writes_val_outputs(tmp_path, one_torch_thread):
    """Vertex inference writes one .npz of per-event arrays under
    <run dir>/validation_output (vertex_finding.py:154-178)."""
    metrics = _run(tmp_path, "yolo", ("mode=inference",))
    assert np.isfinite(metrics["loss/loss"]) and metrics["overflow/dropped"] == 0
    files = list(tmp_path.glob("**/validation_output/val_rank_0.npz"))
    assert len(files) == 1
    out = np.load(files[0])
    assert set(out.files) == {"label", "vertex_true", "anchor", "vertex",
                              "pred_label"}
    n = 8  # four batches of 2
    assert out["vertex"].shape == out["vertex_true"].shape == (n, 3)
    assert out["anchor"].shape == (n, 16, 16, 16)  # 64^3 / 2^2
    assert out["label"].shape == out["pred_label"].shape == (n,)
    assert np.isfinite(out["vertex"]).all()
    assert ((out["anchor"] >= 0) & (out["anchor"] <= 1)).all()


def test_tasks_need_cuda_unless_asked(tmp_path, monkeypatch):
    """Every task's train and inference run on the card unless the CPU is
    asked for: without one they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for task in ("simclr", "yolo", "unsupervised_eventID"):
        for mode in ("mode=train", "mode=inference"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                main(["--config-name", "synthetic", f"name={task}", mode,
                      f"output_dir={tmp_path}"])


def test_unknown_task_rejected(tmp_path):
    for mode in ("mode=train", "mode=inference"):
        with pytest.raises(ValueError, match="unknown task name"):
            _run(tmp_path, "not_a_task", (mode,))


def test_simclr_views_differ(tmp_path, one_torch_thread):
    """The two SimCLR views are two augmentations, cut to the views' voxel
    budget at the views' capacities."""
    cfg = load_config("synthetic", [*TINY, "name=simclr", *SIMCLR,
                                    "data.aug_max_voxels=200",
                                    f"output_dir={tmp_path}"])
    ds = build_dataset(cfg, "train")
    task = build_task(cfg, ds, ds.batch_grid(), 4, None, torch.device("cpu"))
    assert task.state.model.encoder.capacities == (512, 512, 512)
    v1, v2, host = task.prepare(ds.batch([0, 1]))
    assert v1.capacity == 512 and len(host) == 2
    assert int(v1.n_active.max()) <= 200
    assert not torch.equal(v1.coords, v2.coords)


@pytest.mark.parametrize("dimension", [3, 2])
def test_visualize_mode_writes_event_displays(tmp_path, dimension):
    """mode=visualize renders per-event projection PNGs (3D: three
    projections; 2D multiplane: a panel a plane)."""
    pytest.importorskip("matplotlib")
    extra = ["data.dimension=2"] if dimension == 2 else []
    shown = main(["--config-name", "synthetic", "mode=visualize",
                  "mode.events=3", "run.minibatch_size=2",
                  "data.max_voxels=256", "data.synthetic_events=8",
                  f"output_dir={tmp_path}", *extra])
    written = shown["written"]
    assert len(written) == 3
    for p in written:
        assert p.endswith(".png")
        assert (tmp_path / p).stat().st_size > 1000


def test_profile_writes_a_trace(tmp_path, one_torch_thread):
    """run.profile=true runs the loop under torch.profiler and leaves a
    Chrome trace under <run dir>/profile/."""
    _run(tmp_path, "yolo", ("run.profile=true", "mode.iterations=2"))
    trace = tmp_path / "synthetic" / "debug" / "profile" / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("conv3d" in str(e.get("name", "")) for e in events)


def test_simclr_encoder_transfers_into_a_supervised_run(tmp_path,
                                                        one_torch_thread):
    """Pre-train with SimCLR, fine-tune supervised from its checkpoint's
    encoder (mode.restore_encoder_only): the encoder is the SimCLR one and
    stays frozen, the heads train."""
    _run(tmp_path, "simclr", SIMCLR + ("run.id=pretrain",))
    ckpt = tmp_path / "synthetic" / "pretrain" / "checkpoints" / "step_3.pt"
    source = torch.load(ckpt, weights_only=True)["model"]
    assert any(k.startswith("projector.") for k in source)
    from sparseeventid_tpu_torch.train.trainer import train

    cfg = load_config("synthetic", [*TINY, "run.id=finetune",
                                    f"output_dir={tmp_path}",
                                    f"mode.weights_location={ckpt}",
                                    "mode.restore_encoder_only=true"])
    run = train(cfg)
    assert run.state.step == 3 and np.isfinite(run.history[-1]["loss/loss"])
    for name, p in run.state.model.named_parameters():
        if name.startswith("encoder."):
            assert torch.equal(p.detach(), source[name]), name
            assert not p.requires_grad
    heads = [p for n, p in run.state.model.named_parameters()
             if n.startswith("head.")]
    assert heads and all(p.requires_grad for p in heads)
    assert run_dir(cfg).name == "finetune"
