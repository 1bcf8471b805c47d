"""A run with the timed path broken underneath comes out not correct:
a step that leaves its state unchanged, a loss over half of the batch,
a batch altered where the program prepares it, one conv's gradient
scaled, and plans of cache hits that lose their sidecar pairs.  The
card's look is skipped: the tiny cell runs on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tiny import CACHED, tiny_spec

from seidbench import harness


def _run(tmp_path, traffic=None):
    return harness.run_cell(tiny_spec(tmp_path, traffic=traffic), 31, 0.2,
                            False, torch.device("cpu"), 0.0,
                            log=lambda s: None)


def test_sound_run_is_correct(tmp_path, few_threads):
    assert _run(tmp_path)["correct"]


def test_state_left_unchanged(tmp_path, few_threads, monkeypatch):
    from sparseeventid_tpu_torch.train import state

    def unchanged(self, every=1):
        self.step += 1
        self.optimizer.zero_grad(set_to_none=True)

    monkeypatch.setattr(state.TrainState, "apply_gradients", unchanged)
    result = _run(tmp_path)
    assert not result["correct"]
    assert result["checks"]["update_gap"]["value"] == pytest.approx(1.0)


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


def test_batch_altered_where_prepared(tmp_path, few_threads, monkeypatch):
    from sparseeventid_tpu_torch.train import tasks

    prepare = tasks.prepare_batch

    def altered(batch, *a, **kw):
        x, labels = prepare(batch, *a, **kw)
        feats = x.feats.clone()
        feats[0, 0, 0] = feats[0, 0, 0] * 2.0
        return x.with_feats(feats), labels

    monkeypatch.setattr(tasks, "prepare_batch", altered)
    result = _run(tmp_path)
    assert not result["correct"]
    assert result["checks"]["input_gap"]["value"] > 1e-3


def test_one_conv_gradient_scaled(tmp_path, few_threads, monkeypatch):
    """A backward fault confined to one conv's dW moves no median leaf, and
    AdamW's change hides its scale: the worst conv weight sees it."""
    from sparseeventid_tpu_torch.train import state

    apply = state.TrainState.apply_gradients

    def scaled(self, every=1):
        params = dict(self.model.named_parameters())
        params["encoder.series_0.block_0.conv1.w"].grad.mul_(2.0)
        apply(self, every)

    monkeypatch.setattr(state.TrainState, "apply_gradients", scaled)
    result = _run(tmp_path)
    assert not result["correct"]
    assert result["checks"]["conv_grad_gap"]["value"] > 0.5
    assert result["checks"]["grad_gap"]["ok"]


def test_cached_run_takes_checked_plans_from_cache(tmp_path, few_threads):
    result = _run(tmp_path, CACHED)
    assert result["correct"], result["checks"]
    assert result["window"]["checked_plan_misses"] == 0
    assert result["window"]["checked_plan_hits"] >= 3 * CACHED["batch"]


def test_cache_hit_loses_its_sidecar(tmp_path, few_threads, monkeypatch):
    """Plans assembled from cache hits whose overflow lists come back
    invalid, as a pad that overwrote them would leave them."""
    from sparseeventid_tpu_torch.io import plan_cache

    plans_for = plan_cache.PlanCache.plans_for

    def corrupted(self, split, coords, indices):
        misses = self.misses
        out = plans_for(self, split, coords, indices)
        if self.misses != misses:
            return out
        return {k: np.zeros_like(v) if k.endswith("/ov_valid") else v
                for k, v in out.items()}

    monkeypatch.setattr(plan_cache.PlanCache, "plans_for", corrupted)
    result = _run(tmp_path, CACHED)
    assert result["window"]["checked_plan_misses"] == 0
    assert not result["correct"]
