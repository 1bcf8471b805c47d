"""Command line: ``python -m sparseeventid_tpu_torch --config-name <recipe>
mode=train|inference|iotest|visualize [name=<task>] [overrides]``.

``name`` picks the task: supervised_eventID (the default), simclr, yolo or
unsupervised_eventID.  Train and inference run on the card unless
``run.compute_mode=CPU`` is given; iotest and visualize read batches on the
host only.  Each prints one JSON line: inference the mean metrics, train
the metrics of its last step, iotest the mean fetch ms and images/s of
each split, visualize the PNG files it wrote (matplotlib needed).

With ``run.distributed=true`` train and inference are data parallel, one
process a device, started by torchrun:

    torchrun --nproc_per_node=N -m sparseeventid_tpu_torch \
        --config-name dune3d mode=train run.distributed=true

The process group is joined before the mode runs (unless the caller has
joined one) and left on exit.  Two ranks may share one card with
``framework.oversubscribe=2`` (gloo); on the CPU add
``run.compute_mode=CPU`` (gloo).
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

from .config import load_config
from .config.schema import ModeKind
from .parallel import mesh


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config-name", default="synthetic",
                        help="recipe name under recipes/")
    parser.add_argument("--recipes-dir", default=None,
                        help="override the recipes directory")
    parser.add_argument("overrides", nargs="*",
                        help="hydra-style dotted overrides key=value")
    args = parser.parse_args(argv)
    cfg = load_config(
        args.config_name, args.overrides,
        recipes_dir=Path(args.recipes_dir) if args.recipes_dir else None,
    )
    joins = cfg.run.distributed and not mesh.is_initialized()
    if joins:
        mesh.initialize_distributed(cfg)
    try:
        metrics = _run_mode(cfg)
    finally:
        if joins:
            mesh.destroy()
    print(json.dumps(metrics, sort_keys=True))
    return metrics


def _run_mode(cfg) -> dict:
    if cfg.mode.name == ModeKind.train:
        from .train.trainer import train

        history = train(cfg).history
        return history[-1] if history else {}
    if cfg.mode.name == ModeKind.inference:
        from .train.evaluate import validate

        return validate(cfg)
    if cfg.mode.name == ModeKind.iotest:
        from .train.trainer import iotest

        return iotest(cfg)
    from .train.trainer import visualize

    return {"written": [str(p) for p in visualize(cfg)]}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main()
