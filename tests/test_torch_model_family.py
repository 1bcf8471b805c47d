"""The port's model families (``models.build.model_family``, the part of
JAX's ``build_model`` that picks one): ``framework.mode=sparse`` and
``graph`` build the sparse classifier; ``dense`` is not ported and raises
from every entry point that builds a model, as do the point-cloud
encoders, each naming the roadmap item."""

import pytest

from sparseeventid_tpu_torch.config import load_config
from sparseeventid_tpu_torch.models import SparseEventClassifier, build_sparse_classifier
from sparseeventid_tpu_torch.models.build import model_family
from sparseeventid_tpu_torch.train.evaluate import build_dataset, validate
from sparseeventid_tpu_torch.train.tasks import TASKS, build_task
from sparseeventid_tpu_torch.train.trainer import train

SMALL = ["run.compute_mode=CPU", "encoder.depth=2", "encoder.blocks_per_layer=1",
         "encoder.n_initial_filters=8", "data.max_voxels=256",
         "data.synthetic_events=4", "run.minibatch_size=2"]


def _cfg(tmp_path, *extra):
    return load_config("synthetic", SMALL + [f"output_dir={tmp_path}", *extra])


@pytest.mark.parametrize("entry", ["train", "validate", *TASKS])
def test_dense_mode_raises_naming_the_roadmap(entry, tmp_path):
    dense = ["framework.mode=dense", "data.transform1=true", "data.transform2=true"]
    match = r"framework.mode=dense.*ROADMAP.md Queue 1: dense mode"
    if entry == "train":
        with pytest.raises(NotImplementedError, match=match):
            train(_cfg(tmp_path, "mode=train", *dense))
    elif entry == "validate":
        with pytest.raises(NotImplementedError, match=match):
            validate(_cfg(tmp_path, "mode=inference", *dense))
    else:
        cfg = _cfg(tmp_path, "mode=train", f"name={entry}", *dense)
        dataset = build_dataset(cfg, "train")
        with pytest.raises(NotImplementedError, match=match):
            build_task(cfg, dataset, dataset.batch_grid(), 2, None, "cpu")


@pytest.mark.parametrize("mode", ["sparse", "graph"])
def test_sparse_and_graph_build_the_sparse_classifier(mode, tmp_path):
    cfg = _cfg(tmp_path, f"framework.mode={mode}")
    assert model_family(cfg) == "sparse"
    assert isinstance(build_sparse_classifier(cfg), SparseEventClassifier)


@pytest.mark.parametrize("encoder", ["pointnet", "dgcnn"])
def test_point_cloud_encoders_raise_naming_the_roadmap(encoder, tmp_path):
    with pytest.raises(TypeError, match="ROADMAP.md Queue 1: point-cloud models"):
        build_sparse_classifier(_cfg(tmp_path, f"encoder={encoder}"))
