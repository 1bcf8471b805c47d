"""``python -m sparseeventid_tpu_torch ... mode=inference`` on the CPU, run
in-process: finite metrics on stdout and the softmax written to .npz; the
softmax comes from the forward that gives the metrics."""

import json

import numpy as np

from sparseeventid_tpu_torch.__main__ import main
from sparseeventid_tpu_torch.config.schema import OUTPUT_SHAPE


def test_cli_inference_on_cpu(tmp_path, capsys):
    out = tmp_path / "softmax.npz"
    metrics = main([
        "--config-name", "synthetic", "mode=inference",
        "run.compute_mode=CPU", "framework.sparse_backend=window",
        "data.synthetic_events=8", "run.minibatch_size=4",
        f"mode.output_file={out}", f"output_dir={tmp_path}",
    ])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == metrics
    assert np.isfinite(metrics["loss/loss"])
    assert metrics["overflow/dropped"] == 0
    for k in OUTPUT_SHAPE:
        assert 0.0 <= metrics[f"acc/{k}"] <= 1.0
    soft = np.load(out)
    for k, n in OUTPUT_SHAPE.items():
        assert soft[k].shape == (8, n)
        assert np.all(np.isfinite(soft[k]))
        np.testing.assert_allclose(soft[k].sum(axis=1), 1.0, rtol=1e-5)


def test_validate_scores_each_batch_in_one_forward(tmp_path, monkeypatch):
    """Supervised ``validate`` with ``mode.output_file``: one model forward
    a batch, and the softmax it writes is, bit for bit, what
    ``make_predict_step`` gives on the same weights and batches."""
    import torch

    from sparseeventid_tpu_torch.config import load_config
    from sparseeventid_tpu_torch.models import build_model, init_parameters
    from sparseeventid_tpu_torch.train import make_predict_step
    from sparseeventid_tpu_torch.train.evaluate import (
        build_dataset,
        feature_dtype,
        prepare_batch,
        validate,
    )
    from sparseeventid_tpu_torch.train.plans import run_planner

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = tmp_path / "softmax.npz"
        cfg = load_config("synthetic", [
            "mode=inference", "run.compute_mode=CPU",
            "framework.sparse_backend=window", "encoder.depth=2",
            "encoder.blocks_per_layer=1", "encoder.n_initial_filters=8",
            "data.max_voxels=256", "head.hidden=32", "data.synthetic_events=8",
            "run.minibatch_size=4", f"mode.output_file={out}",
            f"output_dir={tmp_path}"])
        model, mode = build_model(cfg)
        init_parameters(model, cfg.run.seed).eval()
        ds = build_dataset(cfg, "val")
        forwards = []
        forward = type(model).forward

        def counted(self, *args, **kwargs):
            forwards.append(1)
            return forward(self, *args, **kwargs)

        monkeypatch.setattr(type(model), "forward", counted)
        validate(cfg, ds, model.state_dict(), "cpu")
        assert len(forwards) == 2  # 8 events in batches of 4
        grid = tuple(ds.batch_grid())
        planner = run_planner(cfg, grid)
        assert planner is not None
        predict = make_predict_step(model, planner.plans)
        want = {}
        for first in (0, 4):
            batch = ds.batch(list(range(first, first + 4)))
            x, _ = prepare_batch(batch, grid, model.encoder.capacities[0],
                                 feature_dtype(cfg), torch.device("cpu"), mode)
            host = planner.to_device(planner.build(batch["image"]), "cpu")
            for k, v in predict(x, host).items():
                want.setdefault(k, []).append(v.numpy())
    finally:
        torch.set_num_threads(threads)
    soft = np.load(out)
    assert sorted(soft.files) == sorted(OUTPUT_SHAPE)
    for k in OUTPUT_SHAPE:
        np.testing.assert_array_equal(soft[k], np.concatenate(want[k]))
