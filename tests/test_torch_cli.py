"""``python -m sparseeventid_tpu_torch ... mode=inference`` on the CPU, run
in-process: finite metrics on stdout and the softmax written to .npz."""

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
