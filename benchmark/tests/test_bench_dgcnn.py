"""The ``dgcnn`` model family (``models/dgcnn.py``) through a tiny cell on
the CPU: the program reads correct against the reference, and a program
broken underneath reads not correct (half of the batch, an altered charge,
one stage's neighbour list shifted by one slot).  ``window_work`` equals
the operations and bytes counted by hand."""

from __future__ import annotations

import copy
import json

import numpy as np
import pytest
import torch

from tiny import ROOT

from seidbench import generator, harness, reference

P = 48  # points a cloud: the tiny events hold 150-300 voxels
# float32 programs read gaps under 1e-5 here; the faults below read loss
# gaps of 0.03 and more, and the altered charge an input gap of 0.3 and more
LIMITS = {"input_mismatch": 0, "input_gap": 1e-3, "loss_gap": 1e-3,
          "grad_gap": 1e-2, "conv_grad_gap": 1e-3, "update_gap": 0.3,
          "dropped": 0, "failed_steps": 0}


def tiny_dgcnn_spec(tmp_path) -> dict:
    """``configs/dgcnn3d.json`` at its published widths on a 64^3 grid,
    clouds of ``P`` points."""
    cfg = copy.deepcopy(json.loads((ROOT / "configs" / "dgcnn3d.json")
                                   .read_text()))
    cfg["overrides"] = [o.replace("8192", str(P)) for o in cfg["overrides"]]
    cfg["grid"] = cfg["larcv_grid"] = [64, 64, 64]
    cfg["max_voxels"] = 1024
    cfg["arch"]["max_points"] = P
    cfg["generator"] = {"image_size": [64, 64, 64], "mean_tracks": 3.0,
                        "steps_per_track": 100, "max_voxels": 1024,
                        "planes": False}
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    return {
        "name": "tiny_dgcnn",
        "chips": 1,
        "config": cfg,
        "model": harness.load_model(ROOT / "models" / "dgcnn.py"),
        "traffic": {"batch": 2, "pool": 8, "split": 32,
                    "access": "serial_access", "run_length": 1,
                    "warmup_steps": 4},
        "limits": LIMITS,
        "end_to_end": bench["end_to_end"],
        "per_layer": bench["per_layer"],
        "families": {"sparse_conv": [], "knn": []},
        "peaks": {},
        "metrics_dir": ROOT / "metrics",
        "work_dir": tmp_path,
    }


def _run(tmp_path, seed=31):
    return harness.run_cell(tiny_dgcnn_spec(tmp_path), seed, 0.2, False,
                            torch.device("cpu"), 0.0, log=lambda s: None)


@pytest.mark.parametrize("seed", [31, 2900000011])
def test_sound_run_is_correct(tmp_path, few_threads, seed):
    result = _run(tmp_path, seed)
    assert result["correct"], result["checks"]
    assert result["checks"]["loss_gap"]["value"] < 1e-5


def test_half_of_the_batch_left_out(tmp_path, few_threads, monkeypatch):
    from sparseeventid_tpu_torch.train import supervised

    loss = supervised.multi_head_loss

    def half(logits, labels, *a, **kw):
        n = next(iter(labels.values())).shape[0] // 2
        return loss({k: v[:n] for k, v in logits.items()},
                    {k: v[:n] for k, v in labels.items()}, *a, **kw)

    monkeypatch.setattr(supervised, "multi_head_loss", half)
    result = _run(tmp_path)
    assert not result["correct"]
    assert result["checks"]["loss_gap"]["value"] > 1e-3


def test_charge_altered_where_prepared(tmp_path, few_threads, monkeypatch):
    from sparseeventid_tpu_torch.train import tasks

    prepare = tasks.prepare_batch

    def altered(batch, *a, **kw):
        (pts, mask), labels = prepare(batch, *a, **kw)
        pts = pts.clone()
        pts[0, 0, 3] = pts[0, 0, 3] * 2.0
        return (pts, mask), labels

    monkeypatch.setattr(tasks, "prepare_batch", altered)
    result = _run(tmp_path)
    assert not result["correct"]
    assert result["checks"]["input_gap"]["value"] > 1e-3


def test_one_stage_neighbours_shifted_by_one_slot(tmp_path, few_threads,
                                                 monkeypatch):
    """The second stage takes neighbours 2..k+1 in place of 1..k: the point
    itself drops out and the (k+1)-th comes in."""
    from sparseeventid_tpu_torch.models import dgcnn

    search = dgcnn.knn_indices
    calls = []

    def shifted(x, mask, k):
        calls.append(k)
        if len(calls) % 4 == 2:
            return search(x, mask, k + 1)[..., 1:]
        return search(x, mask, k)

    monkeypatch.setattr(dgcnn, "knn_indices", shifted)
    result = _run(tmp_path)
    assert not result["correct"]
    assert result["checks"]["loss_gap"]["value"] > 1e-3
    assert result["checks"]["input_gap"]["ok"]


def _batches():
    spec = tiny_dgcnn_spec(None)
    events, _ = generator.make_pool(8, 5, spec["config"]["generator"])
    return spec, events, [np.array([0, 1]), np.array([2, 5])]


def test_window_work_equals_the_hand_count(monkeypatch):
    """Per step, with n_e the points of event e (at most P): each EdgeConv
    Dense 2 n k 2Cin Cout x3, the search 2 n_e^2 Cin, the embedding
    2 n 512 1024 x3, the heads 2 (2048 512 + 512 256 + 256 c) x3 a head and
    event; the search's bound by stage the larger of its operations at the
    float32 peak and its bytes n_e (4 Cin + 1 + 8 k) at the bandwidth."""
    spec, events, batches = _batches()
    cfg = spec["config"]
    peak = {"bf16_flops": 989.4e12, "hbm_bytes_per_s": 3.35e12}
    fp32 = spec["model"].FP32_FLOPS["NVIDIA H100 80GB HBM3"]
    assert fp32["fp32_flops"] == 66.9e12
    monkeypatch.setitem(spec["model"].FP32_FLOPS, "cpu", fp32)
    work = spec["model"].window_work(cfg, events, batches, peak, "cpu")
    n = [min(len(reference.event_sites(e, cfg)[0]), P) for e in events]
    assert all(k == P for k in n[:3]) and n[5] == P
    flop, knn_s = 0.0, 0.0
    for rows in batches:
        pts = [n[i] for i in rows]
        for cin, cout in ((4, 64), (64, 64), (64, 128), (128, 256)):
            flop += 3 * 2 * sum(pts) * 20 * 2 * cin * cout
            search = 2 * sum(p * p for p in pts) * cin
            flop += search
            knn_s += max(search / 66.9e12,
                         sum(p * (4 * cin + 1 + 8 * 20) for p in pts)
                         / 3.35e12)
        flop += 3 * 2 * sum(pts) * 512 * 1024
        flop += 3 * 2 * len(pts) * sum(2048 * 512 + 512 * 256 + 256 * c
                                       for c in (3, 3, 2, 2))
    assert work["useful_flop"] == pytest.approx(flop, rel=1e-12)
    assert flop == 2 * 1405028352  # two steps of two 48-point events
    assert work["knn_roofline_s"] == pytest.approx(knn_s, rel=1e-12)
    assert work["useful_fp32_s"] == pytest.approx(flop / 66.9e12, rel=1e-12)
    # a card whose float32 peak is not known adds nothing
    monkeypatch.delitem(spec["model"].FP32_FLOPS, "cpu")
    assert spec["model"].window_work(cfg, events, batches, peak, "cpu") == {}


def test_program_input_reads_the_masked_points_in_key_order():
    spec, events, _ = _batches()
    model = spec["model"]
    (pts, mask), reading = model.reference_batch(
        [events[0], events[1]], spec["config"], "cpu", lambda x: x)
    got = model.program_input([(pts, mask)])
    assert all(torch.equal(a, b) for a, b in zip(got, reading))
    mask = mask.clone()
    mask[1, 40:] = False
    b, c, _ = model.program_input([(pts, mask)])
    assert len(b) == P + 40 and int((b == 1).sum()) == 40
    key = ((b * 4096 + c[:, 0]) * 4096 + c[:, 1]) * 4096 + c[:, 2]
    assert bool((key[1:] > key[:-1]).all())
