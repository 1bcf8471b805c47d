"""The port stands alone: no module of it, nor its scripts chip_smoke.py,
prefetch_ab.py and fence_ab.py, imports JAX,
flax, optax, the JAX package or the repository's bin/ and scripts/; and its entry points refuse to fall back to
the CPU unless asked."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "sparseeventid_tpu_torch").rglob("*.py")
) + ["chip_smoke.py", "prefetch_ab.py", "fence_ab.py"]
# the JAX stack, the JAX package and the repository's own tool folders (the
# port's tools are its own copies, sparseeventid_tpu_torch/scripts/)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sparseeventid_tpu", "scripts",
             "bin")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "")
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_has_modules():
    assert len(PORT_FILES) > 20


@pytest.mark.parametrize("rel", PORT_FILES)
def test_no_jax_imports(rel):
    for mod in _imported_modules(ROOT / rel):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{rel} imports {mod}"


def test_validate_needs_cuda_unless_asked(monkeypatch):
    from sparseeventid_tpu_torch.config import load_config
    from sparseeventid_tpu_torch.train.evaluate import resolve_device, validate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config("synthetic", ["mode=inference"])
    assert cfg.run.compute_mode.name == "CUDA"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        validate(cfg)
    for mode in ("TPU", "CUDA"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(load_config("synthetic", [f"run.compute_mode={mode}"]))
    assert resolve_device(load_config("synthetic", ["run.compute_mode=CPU"])).type == "cpu"
    assert resolve_device(cfg, device="cpu").type == "cpu"


@pytest.fixture
def one_torch_thread():
    """Small CPU tensors run fastest on one thread, and far faster beside
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cli_needs_cuda_unless_asked(monkeypatch, tmp_path, one_torch_thread):
    from sparseeventid_tpu_torch.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--config-name", "synthetic", "mode=inference"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--config-name", "synthetic", "mode=train"])
    # a small model: the run on the CPU is what is checked, not the width
    metrics = main(["--config-name", "synthetic", "mode=train",
                    "run.compute_mode=CPU", "mode.iterations=2",
                    "framework.sparse_backend=window", "encoder.depth=2",
                    "encoder.blocks_per_layer=1", "encoder.n_initial_filters=8",
                    "data.max_voxels=256", "head.hidden=32",
                    f"output_dir={tmp_path}"])
    assert metrics["overflow/dropped"] == 0 and metrics["loss/loss"] > 0
    assert metrics["opt/lr"] > 1e-5  # the second step of the warm-up
    # visualize is host work: it needs no card, only matplotlib (without
    # it, the import error names it)
    show = ["--config-name", "synthetic", "mode=visualize", "mode.events=1",
            "data.max_voxels=256", "data.synthetic_events=4",
            f"output_dir={tmp_path}"]
    try:
        import matplotlib  # noqa: F401
    except ModuleNotFoundError:
        with pytest.raises(ModuleNotFoundError, match="matplotlib"):
            main(show)
    else:
        assert [p.endswith(".png") for p in main(show)["written"]] == [True]


def test_unported_inputs_raise_naming_the_roadmap(tmp_path):
    from sparseeventid_tpu_torch.config import load_config
    from sparseeventid_tpu_torch.train.evaluate import validate
    from sparseeventid_tpu_torch.train.trainer import train

    out = f"output_dir={tmp_path}"
    # dense mode, per-label series and group / layer norm are ported; what
    # stays refused is what the JAX trainer cannot run either: the SimCLR,
    # vertex and weak-label tasks on a dense or point-cloud model (their
    # models are built on the sparse encoder alone)
    for ov in (["framework.mode=dense", "name=simclr"],
               ["framework.mode=dense", "name=yolo"],
               ["encoder=pointnet", "name=unsupervised_eventID"],
               ["encoder=dgcnn", "name=simclr"]):
        for mode in ("mode=train", "mode=inference"):
            cfg = load_config("synthetic", [mode, "run.compute_mode=CPU", out] + ov)
            with pytest.raises(ValueError, match="needs the sparse model family"):
                (train if mode == "mode=train" else validate)(cfg)
    # a real detector's data must be named: a larcv file, or "synthetic"
    for ov in (["data=dune3d"], ["data=dune2d"]):
        cfg = load_config("synthetic", ["mode=train", "run.compute_mode=CPU", out] + ov)
        with pytest.raises(ValueError, match="data.train"):
            train(cfg)
    for recipe in ("dune3d", "dune2d"):
        cfg = load_config(recipe, ["mode=inference", "run.compute_mode=CPU", out])
        with pytest.raises(ValueError, match="data.val"):
            validate(cfg)
    # checkpoints are restored now: a missing one is a missing file
    for mode in ("mode=train", "mode=inference"):
        cfg = load_config("synthetic", [mode, "run.compute_mode=CPU", out,
                                        f"mode.weights_location={tmp_path}/none.pt"])
        with pytest.raises(FileNotFoundError):
            (train if mode == "mode=train" else validate)(cfg)


def test_new_entry_points_need_cuda_unless_asked(monkeypatch):
    """The 2D path goes through the same entry points: the card unless the
    caller asks for the CPU."""
    from sparseeventid_tpu_torch.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    two_d = ["--config-name", "synthetic", "data.dimension=2", "data.images=3"]
    for mode in ("mode=inference", "mode=train"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(two_d + [mode])


def test_kernel_wrappers_refuse_other_devices():
    from sparseeventid_tpu_torch.ops.window import kernels

    x = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no window kernel"):
        kernels.window_plan(x, torch.zeros((1, 4, 1), dtype=torch.int32,
                                           device="meta"),
                            torch.zeros((1,), dtype=torch.int32, device="meta"),
                            window_r=160)


def test_benchmark_drivers_stand_alone_and_need_cuda_unless_asked(monkeypatch):
    """The three benchmark drivers and the in-memory events are port
    modules (so test_no_jax_imports covers them); each driver raises on a
    host without a card unless given --device cpu."""
    from sparseeventid_tpu_torch.scripts import bench, bench_e2e, bench_extra

    for rel in ("scripts/bench.py", "scripts/bench_e2e.py",
                "scripts/bench_extra.py", "io/memory.py"):
        assert f"sparseeventid_tpu_torch/{rel}" in PORT_FILES
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: bench.main([]), lambda: bench_e2e.main([]),
                lambda: bench_extra.main(["pointnet"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()
