"""The port's per-event plan cache (io/plan_cache.py) over its own builder:
a cached batch is exactly the batch built whole, since the builder works
event by event along the leading axis (the cases of
tests/test_plan_cache.py)."""

import numpy as np

from sparseeventid_tpu_torch.io import BatchLoader
from sparseeventid_tpu_torch.io.hostio import build_window_plans
from sparseeventid_tpu_torch.io.plan_cache import PlanCache

GRID, CAP, DEPTH = (32, 64, 64), 512, 2


def _coords(seed, b):
    rng = np.random.default_rng(seed)
    coords = np.full((b, CAP, 3), -1, np.int32)
    for i in range(b):
        c = np.stack([rng.integers(0, g, 300) for g in GRID], axis=-1)
        c = np.unique(c.astype(np.int32), axis=0)
        coords[i, :len(c)] = c
    return coords


def _build(c):
    return build_window_plans(
        c, GRID, [CAP, CAP // 2, CAP // 4], initial_kernel=(5, 5, 5),
        series_kernel=(3, 3, 3), stride=(2, 2, 2), window_r=176,
        ov_caps=[256] * (DEPTH + 1), ov_cap_initial=256,
        ov_caps_down=[256] * DEPTH, window_r_down=320,
    )


def test_cache_assembly_is_identity():
    coords = _coords(0, 6)
    direct = _build(coords)
    cache = PlanCache(_build, max_bytes=1 << 30)
    # warm with an overlapping sub-batch in another order
    cache.plans_for("train", coords[[3, 1, 4]], [3, 1, 4])
    out = cache.plans_for("train", coords, list(range(6)))
    assert set(out) == set(direct)
    for k in direct:
        np.testing.assert_array_equal(out[k], direct[k], err_msg=k)
    assert cache.hits == 3 and cache.misses == 6
    # a second epoch: no build, still exact
    out2 = cache.plans_for("train", coords, list(range(6)))
    assert cache.misses == 6
    for k in direct:
        np.testing.assert_array_equal(out2[k], direct[k], err_msg=k)
    assert "6 events" in cache.stats_line() and "hit rate 60.0% (9/15)" in cache.stats_line()
    cache.clear()
    assert len(cache) == 0 and cache.nbytes == 0 and cache.hits == 0


def test_budget_exhausted_still_exact():
    coords = _coords(1, 4)
    direct = _build(coords)
    cache = PlanCache(_build, max_bytes=1)  # nothing fits
    out = cache.plans_for("train", coords, [0, 1, 2, 3])
    assert len(cache) == 0 and cache.nbytes == 0
    for k in direct:
        np.testing.assert_array_equal(out[k], direct[k], err_msg=k)


def test_split_keys_do_not_collide():
    a, b = _coords(2, 2), _coords(3, 2)
    cache = PlanCache(_build, max_bytes=1 << 30)
    cache.plans_for("train", a, [0, 1])
    out_b = cache.plans_for("val", b, [0, 1])  # same indices, another split
    direct_b = _build(b)
    for k in direct_b:
        np.testing.assert_array_equal(out_b[k], direct_b[k], err_msg=k)
    assert cache.misses == 4


def test_train_loader_routes_batches_through_cache():
    """The train loader's transform (train/plans.py) hits the cache in the
    second epoch: dataset indices flow through batch['index']."""
    from sparseeventid_tpu_torch.config import load_config
    from sparseeventid_tpu_torch.models import build_sparse_classifier
    from sparseeventid_tpu_torch.train.evaluate import build_dataset
    from sparseeventid_tpu_torch.train.plans import planner_for

    cfg = load_config("synthetic", [
        "framework.sparse_backend=window", "run.minibatch_size=4",
        "data.synthetic_events=8", "encoder.depth=2", "data.max_voxels=256",
    ])
    ds = build_dataset(cfg, "train")
    planner = planner_for(cfg, build_sparse_classifier(cfg).encoder,
                          ds.batch_grid(), cache=True)
    assert planner is not None and planner.cache is not None
    assert planner.cache.max_bytes == cfg.framework.plan_cache_mb << 20
    loader = BatchLoader(ds, 4, transform=planner.transform("train"))
    try:
        seen = set()
        for _ in range(4):  # two epochs of 8 events at batch 4
            batch = next(loader)
            assert "host_plans" in batch and "index" in batch
            seen.update(int(i) for i in batch["index"])
        assert seen == set(range(8))
        assert planner.cache.hits >= 8
    finally:
        loader.stop()


def test_lists_of_two_widths_pad_to_the_widest():
    """Events cached from a build with narrow lists and from one with wide
    lists (a planner widens a batch's lists rather than drop pairs) assemble
    into exactly the wide build."""
    coords = _coords(4, 4)
    widths = iter([256, 512])

    def build(c):
        w = next(widths)
        return build_window_plans(
            c, GRID, [CAP, CAP // 2, CAP // 4], initial_kernel=(5, 5, 5),
            series_kernel=(3, 3, 3), stride=(2, 2, 2), window_r=64,
            ov_caps=[w] * (DEPTH + 1), ov_cap_initial=w,
            ov_caps_down=[w] * DEPTH, window_r_down=64)

    cache = PlanCache(build, max_bytes=1 << 30)
    cache.plans_for("train", coords[:2], [0, 1])
    out = cache.plans_for("train", coords, [0, 1, 2, 3])
    wide = build_window_plans(
        coords, GRID, [CAP, CAP // 2, CAP // 4], initial_kernel=(5, 5, 5),
        series_kernel=(3, 3, 3), stride=(2, 2, 2), window_r=64,
        ov_caps=[512] * (DEPTH + 1), ov_cap_initial=512,
        ov_caps_down=[512] * DEPTH, window_r_down=64)
    assert not any(out[k].any() for k in out if k.endswith("ov_dropped"))
    assert sum(int(out[k].sum()) for k in out if k.endswith("ov_valid")) > 100
    for k in wide:
        np.testing.assert_array_equal(out[k], wide[k], err_msg=k)
