"""The frozen event generator gives the program's events today."""

from __future__ import annotations

import json

import numpy as np
import pytest

from tiny import ROOT

from seidbench import generator

CONFIGS = ["dune3d", "dune2d"]


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("seed", [0, 3000000001])
def test_events_equal_the_programs(config, seed):
    from sparseeventid_tpu_torch.io.larcv import synthetic_larcv_event

    gen = json.loads((ROOT / "configs" / f"{config}.json").read_text())[
        "generator"]
    for i in (0, 5):
        ours, labels, aux = generator.larcv_event(i, seed, gen)
        theirs, t_labels, t_aux = synthetic_larcv_event(
            i, gen["image_size"], seed, gen["mean_tracks"],
            gen["steps_per_track"], gen["max_voxels"], gen["planes"])
        assert labels == t_labels
        assert len(ours) == len(theirs)
        for (a_ids, a_v), (b_ids, b_v) in zip(ours, theirs):
            np.testing.assert_array_equal(a_ids, b_ids)
            np.testing.assert_array_equal(a_v, b_v)
        np.testing.assert_array_equal(aux["vertex"], t_aux["vertex"])


def test_pool_labels_follow_the_events():
    gen = {"image_size": [32, 32, 32], "mean_tracks": 3.0,
           "steps_per_track": 50, "max_voxels": 512, "planes": False}
    events, labels = generator.make_pool(4, 7, gen)
    for i in range(4):
        _, labs, _ = generator.larcv_event(i, 7, gen)
        for k, v in labs.items():
            assert labels[k][i] == v
