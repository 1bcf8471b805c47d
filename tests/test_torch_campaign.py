"""The slice as a whole on the CPU at a small size: a training campaign
through ``python -m sparseeventid_tpu_torch`` (train with a validation
batch and checkpoints, restore, auto-resume, inference from the newest
checkpoint, encoder-only transfer), and a larcv file run through the port's
inference and the JAX ``Trainer.validate`` with the same weights."""

import json

import flax
import h5py
import jax
import numpy as np
import pytest
import torch

from sparseeventid_tpu.config import load_config as jload
from sparseeventid_tpu.config.schema import OUTPUT_SHAPE
from sparseeventid_tpu.train.trainer import Trainer
from sparseeventid_tpu_torch.__main__ import main
from sparseeventid_tpu_torch.config import load_config
from sparseeventid_tpu_torch.convert import params_from_jax
from sparseeventid_tpu_torch.io.larcv import write_synthetic_larcv_file
from sparseeventid_tpu_torch.models import build_sparse_classifier, init_parameters
from sparseeventid_tpu_torch.train import trainer
from sparseeventid_tpu_torch.train.evaluate import build_dataset, prepare_batch, validate
from sparseeventid_tpu_torch.train.supervised import make_train_step
from sparseeventid_tpu_torch.train.trainer import build_training, step_generator
from sparseeventid_tpu_torch.utils.checkpoint import CheckpointManager, load_checkpoint

SMALL = ["run.compute_mode=CPU", "framework.sparse_backend=window",
         "encoder.depth=2", "encoder.blocks_per_layer=1",
         "encoder.n_initial_filters=8", "encoder.n_output_filters=16",
         "head.hidden=32", "data.max_voxels=1024", "run.minibatch_size=2",
         "data.mode=serial_access"]


@pytest.fixture(scope="module")
def campaign(tmp_path_factory):
    """Steps 2-6 of chip_smoke.py's campaign phase, through main()."""
    out = tmp_path_factory.mktemp("campaign")
    base = ["--config-name", "synthetic", *SMALL, "data.synthetic_events=4",
            f"output_dir={out}"]
    runs, res = [], {"base": base, "dir": out / "synthetic" / "debug" / "checkpoints"}
    train = trainer.train

    def keep(*args, **kwargs):
        runs.append(train(*args, **kwargs))
        return runs[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer, "train", keep)
        main(base + ["mode=train", "mode.iterations=4", "mode.checkpoint_iteration=2"])
        res["train"] = runs[-1]
        res["index4"] = (res["dir"] / "checkpoint").read_text()
        main(base + ["mode=train", "mode.iterations=6"])
        res["resume"] = runs[-1]
        res["inference"] = main(base + ["mode=inference"])
        main(base + ["mode=train", "mode.iterations=2", "run.id=transfer",
                     f"mode.weights_location={res['dir'] / 'step_4.pt'}",
                     "mode.restore_encoder_only=true"])
        res["transfer"] = runs[-1]
    return res


def test_train_saves_checkpoints_and_validates(campaign):
    run = campaign["train"]
    assert campaign["index4"].splitlines() == [
        "latest: step_4.pt", "step: step_2.pt", "step: step_4.pt"]
    assert run.first_step == 0 and run.state.step == 4 and len(run.history) == 4
    assert list(run.validation) == [0]
    for m in [*run.history, run.validation[0]]:
        assert np.isfinite(m["loss/loss"]) and m["overflow/dropped"] == 0
    assert all(m["time/io_s"] >= 0 and m["time/step_s"] > 0 for m in run.history)
    log = (campaign["dir"].parent / "process.log").read_text()
    assert "val step 0" in log and "Saved checkpoint" in log


def test_restore_is_bit_equal_and_repeats_a_step(campaign):
    """Step 4's file restores the trained state's parameters, statistics,
    AdamW moments, schedule and step bit for bit, and one more step on the
    same batch from each gives the same parameters."""
    cfg = load_config("synthetic", campaign["base"][2:] + ["mode=train"])
    trained = campaign["train"].state
    fresh, fresh_step, _ = build_training(cfg, 2, None, torch.device("cpu"))
    CheckpointManager(campaign["dir"]).restore(fresh, "cpu", step=4)
    assert fresh.step == trained.step == 4
    want = trained.model.state_dict()
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    a, b = fresh.optimizer.state_dict(), trained.optimizer.state_dict()
    assert a["param_groups"] == b["param_groups"]
    assert all(torch.equal(a["state"][i][k], v)
               for i, s in b["state"].items() for k, v in s.items())
    assert fresh.scheduler.state_dict() == trained.scheduler.state_dict()
    batch = build_dataset(cfg, "train").batch(list(range(2)))
    st, labels = prepare_batch(batch, (64, 64, 64), fresh.model.encoder.capacities[0],
                               torch.float32, torch.device("cpu"))
    trained_step = make_train_step(trained, cfg.mode.optimizer.loss_balance_scheme)
    for stp in (fresh_step, trained_step):
        stp(st, labels, step_generator(cfg.run.seed, 4, "cpu"))
    after = dict(trained.model.named_parameters())
    assert all(torch.equal(p, after[n]) for n, p in fresh.model.named_parameters())


def test_auto_resume_continues_from_step_4(campaign):
    run = campaign["resume"]
    assert run.first_step == 4 and len(run.history) == 2 and run.state.step == 6
    assert list(run.validation) == []  # steps 4, 5: no validation interval
    index = (campaign["dir"] / "checkpoint").read_text().splitlines()
    assert index[0] == "latest: step_6.pt" and index[-1] == "step: step_6.pt"


def test_resumed_run_equals_an_uninterrupted_one(campaign, tmp_path):
    """Two steps, then a resume to four, give step 4's bits: AdamW's state,
    the schedule and the step come back, and each step's dropout (on in
    this recipe) depends on the step alone.  (Four events in batches of two
    make the restarted data stream the same batches.)"""
    base = campaign["base"][:-1] + [f"output_dir={tmp_path}"]
    main(base + ["mode=train", "mode.iterations=2"])
    main(base + ["mode=train", "mode.iterations=4"])
    got = load_checkpoint(tmp_path / "synthetic" / "debug" / "checkpoints" / "step_4.pt", "cpu")
    want = load_checkpoint(campaign["dir"] / "step_4.pt", "cpu")
    assert load_config("synthetic", base[2:]).head.dropout > 0
    assert got["step"] == want["step"] == 4
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    assert got["scheduler"] == want["scheduler"]


def test_inference_restores_the_newest_checkpoint(campaign):
    cfg = load_config("synthetic", campaign["base"][2:] + ["mode=inference"])
    sd6 = load_checkpoint(campaign["dir"] / "step_6.pt", "cpu")["model"]
    assert campaign["inference"] == validate(cfg, params=sd6)
    fresh = validate(cfg, params=init_parameters(build_sparse_classifier(cfg), 0).state_dict())
    assert fresh != campaign["inference"]


def test_transfer_freezes_the_encoder(campaign):
    run = campaign["transfer"]
    assert run.first_step == 0 and run.state.step == 2
    step4 = load_checkpoint(campaign["dir"] / "step_4.pt", "cpu")["model"]
    cfg = load_config("synthetic", campaign["base"][2:] + ["mode=train"])
    start = init_parameters(build_sparse_classifier(cfg), cfg.run.seed).state_dict()
    final = run.state.model.state_dict()
    buffers = {n for n, _ in run.state.model.named_buffers()}
    for n, p in run.state.model.named_parameters():
        if n.startswith("encoder."):
            assert not p.requires_grad and torch.equal(final[n], step4[n]), n
        else:
            assert p.requires_grad and not torch.equal(final[n], start[n]), n
    enc_stats = [n for n in buffers if n.startswith("encoder.")]
    assert enc_stats and all(not torch.equal(final[n], start[n]) for n in enc_stats)
    assert all(not torch.equal(final[n], step4[n]) for n in enc_stats)


# ---- larcv: the port's inference against the JAX trainer's

class RecordingTrainer(Trainer):
    """The JAX trainer, keeping the state its run restored."""

    def _restore(self, state):
        self.restored = super()._restore(state)
        return self.restored


def test_larcv_inference_matches_jax_trainer(tmp_path, capsys):
    """A larcv file written by the port, through the JAX Trainer.validate
    (its plain xla backend) and the port's mode=inference (window backend)
    with the JAX weights carried by convert.params_from_jax: mean loss,
    accuracies and softmax within test_torch_model.py's eval tolerance
    (rtol 1e-5, atol 1e-6)."""
    path = write_synthetic_larcv_file(tmp_path / "val.h5", 8, image_size=(32, 32, 32),
                                      seed=11)
    common = ["mode=inference", "encoder.depth=2", "encoder.blocks_per_layer=1",
              "run.minibatch_size=4", f"data.train={path}", f"data.val={path}"]
    cfg_j = jload("synthetic", common + [
        "framework.sparse_backend=xla", f"output_dir={tmp_path / 'jax'}",
        f"mode.output_file={tmp_path / 'jax.h5'}"])
    jt = RecordingTrainer(cfg_j)
    want = jt.validate()
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))
    weights = tmp_path / "jax_weights.pt"
    torch.save({"model": params_from_jax(to_np(jt.restored.params),
                                         to_np(jt.restored.batch_stats)), "step": 0},
               weights)
    got = main(["--config-name", "synthetic", *common, "run.compute_mode=CPU",
                "framework.sparse_backend=window", f"output_dir={tmp_path / 'port'}",
                f"mode.weights_location={weights}",
                f"mode.output_file={tmp_path / 'port.h5'}"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    assert got["overflow/dropped"] == 0
    for k in ["loss/loss", *(f"acc/{h}" for h in OUTPUT_SHAPE)]:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    with h5py.File(tmp_path / "jax.h5", "r") as fj, h5py.File(tmp_path / "port.h5", "r") as ft:
        assert sorted(fj["Data"]) == sorted(ft["Data"])
        for k, n in OUTPUT_SHAPE.items():
            a = ft[f"Data/softmax_{k}_group/scores"][:]
            assert a.shape == (8, n)
            np.testing.assert_allclose(a, fj[f"Data/softmax_{k}_group/scores"][:],
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_iotest_mode(tmp_path, capsys):
    path = write_synthetic_larcv_file(tmp_path / "t.h5", 8, image_size=(32, 32, 32),
                                      seed=2)
    for data in ([f"data.train={path}", f"data.val={path}"], []):
        got = main(["--config-name", "synthetic", "mode=iotest", "mode.iterations=3",
                    "run.minibatch_size=4", f"output_dir={tmp_path}", *data])
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
        assert set(got) == {"train", "val"}
        for split in got.values():
            assert split["mean_ms"] > 0 and split["img_per_s"] > 0
