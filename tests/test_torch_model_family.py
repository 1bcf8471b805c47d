"""The port's model families (``models.build.build_model``, as JAX's picks
them): ``framework.mode=sparse`` and ``graph`` build the sparse classifier,
``dense`` the dense classifier, ``encoder=pointnet|dgcnn`` the point-cloud
models.  The supervised task trains and runs inference in every family
through the entry points; the SimCLR, vertex and weak-label tasks, whose
models are built on the sparse encoder alone, raise a clear error for a
dense or point-cloud config.

(The test names are those of the refusals these tests replaced: dense
mode and the point-cloud encoders raised until the families were
ported.)"""

import numpy as np
import pytest
import torch

from sparseeventid_tpu_torch.config import load_config
from sparseeventid_tpu_torch.models import (
    PointCloudWrapper,
    SparseEventClassifier,
    build_model,
    build_sparse_classifier,
)
from sparseeventid_tpu_torch.models.build import model_family
from sparseeventid_tpu_torch.models.dense import DenseEventClassifier
from sparseeventid_tpu_torch.models.dgcnn import DGCNNClassifier
from sparseeventid_tpu_torch.models.pointnet import PointNetClassifier
from sparseeventid_tpu_torch.train.evaluate import build_dataset, validate
from sparseeventid_tpu_torch.train.tasks import TASKS, build_task
from sparseeventid_tpu_torch.train.trainer import train

SMALL = ["run.compute_mode=CPU", "encoder.depth=2", "encoder.blocks_per_layer=1",
         "encoder.n_initial_filters=8", "data.max_voxels=256",
         "data.synthetic_events=4", "run.minibatch_size=2"]
POINTS = {"pointnet": ["encoder.max_points=64"],
          "dgcnn": ["encoder.max_points=64", "encoder.k=4", "encoder.emb_dims=64"]}


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(tmp_path, *extra):
    return load_config("synthetic", SMALL + [f"output_dir={tmp_path}", *extra])


def _train_then_validate(tmp_path, *family):
    """Two supervised steps through ``train``, then ``validate`` from the
    run's checkpoint: finite metrics, 0 dropped."""
    run = train(_cfg(tmp_path, "mode=train", "mode.iterations=2", *family))
    assert len(run.history) == 2
    for m in run.history:
        assert np.isfinite(m["loss/loss"]) and m["overflow/dropped"] == 0
    val = validate(_cfg(tmp_path, "mode=inference", *family))
    assert np.isfinite(val["loss/loss"]) and val["overflow/dropped"] == 0
    return run, val


@pytest.mark.parametrize("entry", ["train", "validate", *TASKS])
def test_dense_mode_raises_naming_the_roadmap(entry, tmp_path, one_torch_thread):
    """``framework.mode=dense``: train and validate run the dense
    classifier (its checkpoint restored for inference); the supervised
    task builds it and steps; simclr, yolo and unsupervised_eventID raise,
    naming the sparse family they need."""
    dense = ["framework.mode=dense", "data.transform1=true", "data.transform2=true"]
    if entry in ("train", "validate"):
        run, val = _train_then_validate(tmp_path, *dense)
        assert isinstance(run.state.model, DenseEventClassifier)
        if entry == "validate":  # inference from the trained checkpoint
            fresh = validate(_cfg(tmp_path / "fresh", "mode=inference", *dense))
            assert fresh["loss/loss"] != val["loss/loss"]
        return
    cfg = _cfg(tmp_path, "mode=train", f"name={entry}", *dense)
    dataset = build_dataset(cfg, "train")
    if entry != "supervised_eventID":
        with pytest.raises(ValueError, match=rf"{entry} task needs the sparse "
                           "model family.*dense family"):
            build_task(cfg, dataset, dataset.batch_grid(), 2, None, "cpu")
        with pytest.raises(ValueError, match="sparse model family"):
            train(cfg)
        return
    task = build_task(cfg, dataset, dataset.batch_grid(), 2, None,
                      torch.device("cpu"))
    assert isinstance(task.state.model, DenseEventClassifier)
    args = task.prepare(dataset.batch([0, 1]))
    assert args[0].shape == (2, *dataset.batch_grid(), 1) and args[2] is None
    metrics = task.train_step(args, torch.Generator().manual_seed(0))
    assert np.isfinite(float(metrics["loss/loss"])) and task.state.step == 1


@pytest.mark.parametrize("mode", ["sparse", "graph"])
def test_sparse_and_graph_build_the_sparse_classifier(mode, tmp_path):
    cfg = _cfg(tmp_path, f"framework.mode={mode}")
    assert model_family(cfg) == "sparse"
    assert isinstance(build_sparse_classifier(cfg), SparseEventClassifier)
    model, input_mode = build_model(cfg)
    assert isinstance(model, SparseEventClassifier) and input_mode == "sparse"


@pytest.mark.parametrize("encoder", ["pointnet", "dgcnn"])
def test_point_cloud_encoders_raise_naming_the_roadmap(encoder, tmp_path,
                                                       one_torch_thread):
    """``encoder=pointnet|dgcnn``: ``build_model`` gives the point-cloud
    model under ``PointCloudWrapper`` (input mode "points"), which train
    and validate run on ``encoder.max_points`` points an event; the sparse
    classifier and the other tasks refuse the config."""
    extra = [f"encoder={encoder}", *POINTS[encoder]]
    cfg = _cfg(tmp_path, *extra)
    model, input_mode = build_model(cfg)
    assert isinstance(model, PointCloudWrapper) and input_mode == "points"
    inner = PointNetClassifier if encoder == "pointnet" else DGCNNClassifier
    assert isinstance(model.inner, inner)
    with pytest.raises(ValueError, match="sparse model family"):
        build_sparse_classifier(cfg)
    with pytest.raises(ValueError, match="simclr task needs the sparse"):
        train(_cfg(tmp_path, "name=simclr", *extra))
    run, _ = _train_then_validate(tmp_path, *extra)
    assert isinstance(run.state.model, PointCloudWrapper)
