"""The port's BatchLoader and augment against the JAX package's: the same
index sequence in every access mode and under a 2-way shard, the same
augmented views for the same generator state; plus the prefetch thread's
contract (transform, errors, stop)."""

import threading

import numpy as np
import pytest

from sparseeventid_tpu.config.schema import AccessMode as JMode
from sparseeventid_tpu.io.augment import augment_larcv_batch as jaugment
from sparseeventid_tpu.io.dataset import BatchLoader as JLoader
from sparseeventid_tpu_torch.config.schema import AccessMode
from sparseeventid_tpu_torch.io import BatchLoader, SyntheticDataset, SyntheticEventConfig
from sparseeventid_tpu_torch.io.augment import augment_larcv_batch


class Indices:
    """A dataset whose batch is its indices."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def batch(self, indices):
        return {"index": np.asarray(indices, np.int64)}


def _draw(loader, n):
    try:
        return [next(loader)["index"].tolist() for _ in range(n)]
    finally:
        loader.stop()


@pytest.mark.parametrize("mode", ["serial_access", "random_events", "random_blocks"])
@pytest.mark.parametrize("shard", [(0, 1), (0, 2), (1, 2)])
def test_index_sequence_matches_jax(mode, shard):
    """13 events, batches of 4 (random_events batches straddle epochs): 9
    batches of each loader, same seed, same shard."""
    index, count = shard
    kw = dict(seed=5, process_index=index, process_count=count)
    want = _draw(JLoader(Indices(13), 4, access_mode=JMode[mode], **kw), 9)
    got = _draw(BatchLoader(Indices(13), 4, access_mode=AccessMode[mode], **kw), 9)
    assert got == want
    shard_events = set(np.array_split(np.arange(13), count)[index].tolist())
    assert set(sum(got, [])) <= shard_events
    if mode == "random_events":  # every event of the shard once an epoch
        flat = sum(got, [])
        assert sorted(flat[:len(shard_events)]) == sorted(shard_events)


def test_shards_are_disjoint_and_cover():
    seen = []
    for rank in range(3):
        loader = BatchLoader(Indices(12), 2, access_mode=AccessMode.serial_access,
                             process_index=rank, process_count=3)
        seen.append(set(loader.indices.tolist()))
        assert len(loader) == 2
        loader.stop()
    assert seen[0] | seen[1] | seen[2] == set(range(12))
    assert not (seen[0] & seen[1]) and not (seen[1] & seen[2])


def test_transform_runs_in_the_worker():
    main = threading.get_ident()
    seen = []

    def transform(batch):
        seen.append(threading.get_ident())
        return {**batch, "twice": batch["index"] * 2}

    loader = BatchLoader(Indices(8), 4, access_mode=AccessMode.serial_access,
                         transform=transform)
    b = next(loader)
    loader.stop()
    assert b["twice"].tolist() == [0, 2, 4, 6]
    assert seen and main not in seen


def test_worker_error_is_raised_by_next():
    class Broken(Indices):
        def batch(self, indices):
            raise ValueError("no such event")

    loader = BatchLoader(Broken(8), 4)
    with pytest.raises(RuntimeError, match="worker failed") as info:
        next(loader)
    assert isinstance(info.value.__cause__, ValueError)
    loader.stop()


def test_stop_ends_the_worker_with_a_full_queue():
    loader = BatchLoader(Indices(8), 2, prefetch=2)
    next(loader)
    loader.stop()
    assert not loader._thread.is_alive()


def test_synthetic_batches_through_the_loader():
    ds = SyntheticDataset(8, SyntheticEventConfig(image_size=(16, 16, 16)), seed=2)
    loader = BatchLoader(ds, 4, access_mode=AccessMode.serial_access)
    got = [next(loader) for _ in range(2)]
    loader.stop()
    for i, b in enumerate(got):
        want = ds.batch(list(range(4 * i, 4 * i + 4)))
        assert set(b) == set(want)
        for k in want:
            np.testing.assert_array_equal(b[k], want[k])


@pytest.mark.parametrize("image_size,translate", [
    ((32, 32, 32), None), ((32, 32, 32), [3, 2, 5]), ((40, 24), [4, 4]),
])
def test_augment_matches_jax(image_size, translate):
    """Numpy in both packages: the same view, bit for bit, and the
    generators left in the same state."""
    d = len(image_size)
    ds = SyntheticDataset(3, SyntheticEventConfig(image_size=image_size,
                                                  max_voxels=300), seed=4)
    image = ds.batch([0, 1, 2])["image"]
    image[1] = -999.0  # an empty event
    r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
    got = augment_larcv_batch(image, image_size, r1, translate=translate)
    want = jaugment(image, image_size, r2, translate=translate)
    np.testing.assert_array_equal(got, want)
    assert r1.random() == r2.random()
    live = got[..., :d][np.all(got[..., :d] != -999.0, axis=-1)]
    assert live.min() >= 0 and np.all(live.max(axis=0) < np.asarray(image_size))
    assert np.all(got[1] == -999.0)
    assert not np.array_equal(got, image)
