"""The dynamic graph CNN at its published widths (``models/dgcnn.py``)
against the benchmark's plain reference of it (``benchmark/models/
dgcnn.py``, loaded by path), the neighbour search without autograd, the
tracer's spans and the truncation counter of a train step, and on the card
the search kernel (``csrc/knn.cu``) against its plain version:

    python -m pytest tests/test_torch_dgcnn.py -m card --noconftest

(``--noconftest``: the card's host has no JAX, which ``conftest.py``
imports).  This file imports no JAX.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sparseeventid_tpu_torch.config.schema import OUTPUT_SHAPE
from sparseeventid_tpu_torch.models.build import PointCloudWrapper
from sparseeventid_tpu_torch.models.dgcnn import (
    DGCNNClassifier,
    EdgeConv,
    knn_indices,
)
from sparseeventid_tpu_torch.ops import knn_kernels as KK
from sparseeventid_tpu_torch.train.losses import multi_head_loss
from sparseeventid_tpu_torch.utils import telemetry

BENCH = Path(__file__).resolve().parents[1] / "benchmark"


@pytest.fixture(scope="module")
def family():
    """The benchmark's ``dgcnn`` family and its configuration."""
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    spec = importlib.util.spec_from_file_location(
        "bench_model_dgcnn", BENCH / "models" / "dgcnn.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    cfg = json.loads((BENCH / "configs" / "dgcnn3d.json").read_text())
    return module, cfg


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(b, p, valid, seed=0):
    """Real-valued points [b, p, 4] (no two distances tie), the padded rows
    zero, and the mask."""
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((b, p, 4)).astype(np.float32)
    pts[..., :3] *= 20.0
    mask = np.zeros((b, p), bool)
    for i, n in enumerate(valid):
        mask[i, :n] = True
    pts[~mask] = 0.0
    return torch.from_numpy(pts), torch.from_numpy(mask)


def test_port_matches_the_plain_reference(family, one_torch_thread):
    """Published widths (64, 64, 128, 256; k = 20; 1024; heads 512, 256),
    B = 2 clouds of 96 points (one of them 70 valid), train mode, the same
    dropout draws.  Tolerances: float32 on the CPU in other orders of
    summation (the port's norm takes the variance as E[x^2] - mean^2, the
    reference in two passes; the matrix products split their sums
    otherwise), through four norms and a 1024-wide embedding: logits within
    1e-4, the loss within 1e-5 relative, each gradient within 1e-3 of its
    own largest entry."""
    module, cfg = family
    cfg = json.loads(json.dumps(cfg))
    cfg["arch"]["max_points"] = 96
    weights = module.make_weights(cfg, 7, "cpu")
    inner = DGCNNClassifier(OUTPUT_SHAPE, 4, 1, k=20, emb_dims=1024,
                            head_hidden=256, dropout=0.5)
    model = PointCloudWrapper(inner)
    model.load_state_dict(weights)
    model.train()
    pts, mask = _cloud(2, 96, (96, 70))
    labels = {k: torch.tensor([0, n - 1]) for k, n in OUTPUT_SHAPE.items()}
    logits, _ = model((pts, mask), torch.Generator().manual_seed(3))
    loss, _ = multi_head_loss(logits, labels)
    loss.backward()

    params = {n: w.clone().requires_grad_(True) for n, w in weights.items()
              if n in dict(module.param_shapes(cfg))}
    ref = module.forward(params, (pts, mask), 2, cfg,
                         torch.Generator().manual_seed(3), lambda x: x)
    ref_loss = sum(module.reference.focal_loss(ref[k], labels[k], 2.0,
                                               1e-7).mean() for k in ref)
    ref_loss.backward()
    assert list(ref) == list(logits)
    for key in ref:
        torch.testing.assert_close(logits[key], ref[key], rtol=0, atol=1e-4)
    assert float(loss.detach()) == pytest.approx(float(ref_loss.detach()),
                                                 rel=1e-5)
    got = dict(model.named_parameters())
    assert set(got) == set(params)
    for name, p in params.items():
        scale = float(p.grad.abs().max())
        assert scale > 0, name
        torch.testing.assert_close(got[name].grad, p.grad, rtol=0,
                                   atol=1e-3 * scale, msg=name)


@pytest.mark.parametrize("f,k", [(3, 5), (4, 20)])
def test_search_rule_on_the_cpu(f, k):
    """Ascending (distance, index) with the padded candidates at 1e9: ties
    keep the lower index, a cloud of fewer than k valid points fills with
    the lowest padded indices, a padded query still searches."""
    rng = np.random.default_rng(f)
    x = torch.from_numpy(rng.integers(-2, 3, size=(2, 30, f))
                         .astype(np.float32))
    mask = torch.ones((2, 30), dtype=torch.bool)
    mask[0, ::4] = False
    mask[1, 3:] = False
    got = knn_indices(x, mask, k)
    for b in range(2):
        for i in range(30):
            d = [(float(((x[b, i] - x[b, j]) ** 2).sum())
                  if mask[b, j] else 1e9, j) for j in range(30)]
            assert got[b, i].tolist() == [j for _, j in sorted(d)[:k]]


def test_narrow_points_are_searched_in_float32():
    """bf16 and float16 points (the first stage's input under
    ``run.precision=bfloat16``) are widened exactly and searched in
    float32: the indices of their float32 copy, ties kept by index."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(-160, 161, size=(2, 48, 4))
                         .astype(np.float32) * 8.0)
    mask = torch.ones((2, 48), dtype=torch.bool)
    mask[1, 30:] = False
    want = knn_indices(x, mask, 20)
    for dtype in (torch.bfloat16, torch.float16):
        narrow = x.to(dtype)
        assert torch.equal(narrow.float(), x)
        assert torch.equal(knn_indices(narrow, mask, 20), want)


def test_search_keeps_no_pairwise_tensor_for_the_backward():
    """An EdgeConv's forward saves no tensor with a [P, P] tail (the
    distances or their sort's indices) for the backward."""
    p = 40
    conv = EdgeConv(4, 16, 20).train()
    pts, mask = _cloud(2, p, (40, 30))
    x = pts.requires_grad_(True)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = conv(x, mask)
    out.sum().backward()
    assert saved and not [s for s in saved if s[-2:] == (p, p)]
    assert x.grad is not None and float(x.grad.abs().sum()) > 0
    idx = knn_indices(x, mask, 20)
    assert not idx.requires_grad and idx.shape == (2, p, 20)


def test_traced_train_step_records_the_search_and_truncation(
        tmp_path, monkeypatch, one_torch_thread):
    """A DGCNN train step under the tracer: four ``dgcnn.knn`` and four
    ``dgcnn.edge_conv`` spans inside ``step.forward``, and the valid voxels
    past the cloud's 48 points counted as ``points_truncated``."""
    from sparseeventid_tpu_torch.config import load_config
    from sparseeventid_tpu_torch.train import evaluate
    from sparseeventid_tpu_torch.train.evaluate import build_dataset
    from sparseeventid_tpu_torch.train.trainer import train_session

    images = []
    to_cloud = evaluate.larcv_batch_to_pointcloud

    def seen(image, points, *a):
        images.append((image.copy(), points))
        return to_cloud(image, points, *a)

    monkeypatch.setattr(evaluate, "larcv_batch_to_pointcloud", seen)
    cfg = load_config("synthetic", [
        "run.compute_mode=CPU", "encoder=dgcnn", "encoder.max_points=48",
        "run.precision=float32", "data.max_voxels=256",
        "data.synthetic_events=8", "run.minibatch_size=2",
        "data.active=[train]", f"output_dir={tmp_path}"])
    with train_session(cfg, build_dataset(cfg, "train"), "cpu") as session:
        with telemetry.tracing() as tracer:
            session.step(session.next_args(), 0)
    names = [s.name for s in tracer.spans]
    forward = names.index("step.forward")
    for name in ("dgcnn.knn", "dgcnn.edge_conv"):
        spans = [s for s in tracer.spans if s.name == name]
        assert len(spans) == 4, name
        assert all(s.parent == forward for s in spans)
    (image, points), = images
    valid = np.all(image[..., :-1] != -999.0, axis=-1).sum(axis=-1)
    want = int(np.maximum(valid - points, 0).sum())
    assert points == 48 and want > 0
    counts = {c.name: c.n for c in tracer.counts}
    assert counts["points_truncated"] == want
    assert names[[c.span for c in tracer.counts
                  if c.name == "points_truncated"][0]] == "prepare.input"


# ---- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _integer_clouds(f, p=8192, seed=0):
    """Three integer-valued clouds [3, p, f] in [-3, 3] (ties everywhere):
    one all valid, one with every third point padded (its padded rows hold
    junk, which a padded query still reads), one of 15 valid points."""
    rng = np.random.default_rng(seed + f)
    x = rng.integers(-3, 4, size=(3, p, f)).astype(np.float32)
    mask = np.ones((3, p), bool)
    mask[1, ::3] = False
    mask[2, 15:] = False
    return torch.from_numpy(x), torch.from_numpy(mask)


@pytest.mark.card
@pytest.mark.parametrize("f", [4, 64, 128])
def test_kernel_equals_the_plain_search(card, f):
    """P = 8192, k = 20: the kernel's indices are the plain version's, bit
    for bit, ties, padding and the short cloud included."""
    x, mask = (t.to(card) for t in _integer_clouds(f))
    before = KK.knn_topk.launches
    got = KK.knn_topk(x, mask, 20)
    want = KK.knn_topk_plain(x, mask, 20)
    torch.cuda.synchronize()
    assert KK.knn_topk.launches == before + 1
    assert got.dtype == torch.int64 and got.shape == (3, 8192, 20)
    assert torch.equal(got, want)
    assert torch.equal(got[2, :, 15:].cpu(),
                       torch.arange(15, 20).expand(8192, 5))
    again = KK.knn_topk(x, mask, 20)
    assert torch.equal(got, again)


@pytest.mark.card
def test_model_searches_with_the_kernel(card):
    """A DGCNN forward on the card launches the kernel once a stage and
    never the plain version."""
    model = DGCNNClassifier(OUTPUT_SHAPE, 4, 1).to(card).train()
    pts, mask = _cloud(2, 256, (256, 100))
    launches, calls = KK.knn_topk.launches, KK.knn_topk_plain.calls
    model(pts.to(card), mask.to(card))
    torch.cuda.synchronize()
    assert KK.knn_topk.launches == launches + 4
    assert KK.knn_topk_plain.calls == calls


@pytest.mark.card
def test_model_searches_bf16_points_with_the_kernel(card):
    """bf16 points, as ``run.precision=bfloat16`` gives the first stage:
    a train forward and backward on the card launch the kernel once a
    stage, the first stage's neighbours are the float32 search's of the
    same points, and the gradients are finite."""
    model = DGCNNClassifier(OUTPUT_SHAPE, 4, 1).to(card).train()
    x, mask = (t.to(card) for t in _integer_clouds(4, p=2048))
    pts = (x * 64.0).to(torch.bfloat16)
    assert torch.equal(pts.float(), x * 64.0)
    launches, calls = KK.knn_topk.launches, KK.knn_topk_plain.calls
    logits = model(pts, mask)
    sum(v.float().sum() for v in logits.values()).backward()
    torch.cuda.synchronize()
    assert KK.knn_topk.launches == launches + 4
    assert KK.knn_topk_plain.calls == calls
    assert torch.equal(knn_indices(pts, mask, 20),
                       KK.knn_topk_plain(x * 64.0, mask, 20))
    assert all(torch.isfinite(p.grad).all() for p in model.parameters()
               if p.grad is not None)
