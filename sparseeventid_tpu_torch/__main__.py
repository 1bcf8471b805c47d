"""Command line: ``python -m sparseeventid_tpu_torch --config-name <recipe>
mode=train|inference|iotest|visualize [name=<task>] [overrides]``.

``name`` picks the task: supervised_eventID (the default), simclr, yolo or
unsupervised_eventID.  Train and inference run on the card unless
``run.compute_mode=CPU`` is given; iotest and visualize read batches on the
host only.  Each prints one JSON line: inference the mean metrics, train
the metrics of its last step, iotest the mean fetch ms and images/s of
each split, visualize the PNG files it wrote (matplotlib needed).
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

from .config import load_config
from .config.schema import ModeKind


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
    if cfg.mode.name == ModeKind.train:
        from .train.trainer import train

        history = train(cfg).history
        metrics = history[-1] if history else {}
    elif cfg.mode.name == ModeKind.inference:
        from .train.evaluate import validate

        metrics = validate(cfg)
    elif cfg.mode.name == ModeKind.iotest:
        from .train.trainer import iotest

        metrics = iotest(cfg)
    else:
        from .train.trainer import visualize

        metrics = {"written": [str(p) for p in visualize(cfg)]}
    print(json.dumps(metrics, sort_keys=True))
    return metrics


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main()
