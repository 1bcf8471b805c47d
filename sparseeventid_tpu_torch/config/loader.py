"""Recipe loading + dotted overrides (a minimal hydra replacement).

Reads the same ``recipes/`` directory at the repository root as the JAX
package: a recipe is a defaults list of group names plus leaf overrides, and
command-line overrides use hydra's ``a.b.c=value`` syntax.
"""

from __future__ import annotations

import dataclasses
import enum
from pathlib import Path
from typing import Any, Mapping, Sequence

import yaml

from .schema import (
    ENCODER_GROUP,
    LR_SCHEDULE_GROUP,
    MODE_GROUP,
    SparseEventIDConfig,
    data_group,
)


def _coerce(value: Any, current: Any) -> Any:
    """Coerce a YAML/CLI value onto the type of an existing field."""
    if isinstance(current, enum.Enum):
        etype = type(current)
        if isinstance(value, str):
            try:
                return etype[value]
            except KeyError:
                return etype(int(value))
        if isinstance(value, int):
            return etype(value)
        return value
    if isinstance(current, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(current, int) and not isinstance(value, bool):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, tuple):
        if isinstance(value, str):
            value = yaml.safe_load(value)
        return tuple(value)
    if isinstance(current, str):
        return str(value)
    return value


def _set_dotted(cfg: Any, path: str, value: Any) -> Any:
    """Immutable dotted set: returns a new dataclass tree."""
    head, _, rest = path.partition(".")
    if not dataclasses.is_dataclass(cfg):
        raise KeyError(f"cannot descend into non-dataclass at {head!r}")
    names = {f.name for f in dataclasses.fields(cfg)}
    if head not in names:
        raise KeyError(
            f"unknown config key {head!r} on {type(cfg).__name__} "
            f"(valid: {sorted(names)})"
        )
    current = getattr(cfg, head)
    if rest:
        new_val = _set_dotted(current, rest, value)
    elif dataclasses.is_dataclass(current) and isinstance(value, str):
        new_val = _group_swap(head, value)
    else:
        new_val = _coerce(value, current)
    return dataclasses.replace(cfg, **{head: new_val})


def _group_swap(group: str, name: str) -> Any:
    if group == "mode":
        return MODE_GROUP[name]()
    if group == "encoder":
        return ENCODER_GROUP[name]()
    if group == "data":
        return data_group(name)
    if group == "lr_schedule":
        return LR_SCHEDULE_GROUP[name]()
    raise KeyError(f"{group!r} is not a swappable config group")


def _apply_mapping(cfg: Any, mapping: Mapping[str, Any], prefix: str = "") -> Any:
    for key, val in mapping.items():
        path = f"{prefix}.{key}" if prefix else key
        if isinstance(val, Mapping):
            cfg = _apply_mapping(cfg, val, path)
        else:
            cfg = _set_dotted(cfg, path, val)
    return cfg


def default_recipes_dir() -> Path:
    return Path(__file__).resolve().parents[2] / "recipes"


def load_config(
    config_name: str | None = None,
    overrides: Sequence[str] = (),
    recipes_dir: Path | None = None,
) -> SparseEventIDConfig:
    """Compose: schema defaults -> recipe YAML -> dotted overrides."""
    cfg = SparseEventIDConfig()
    if config_name:
        rdir = recipes_dir or default_recipes_dir()
        doc = yaml.safe_load((rdir / f"{config_name}.yaml").read_text()) or {}
        for entry in doc.pop("defaults", []) or []:
            if isinstance(entry, Mapping):
                for group, name in entry.items():
                    cfg = _set_dotted(cfg, str(group), str(name))
        cfg = _apply_mapping(cfg, doc)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must be key=value")
        key, _, val = ov.partition("=")
        parsed = yaml.safe_load(val) if val != "" else ""
        cfg = _set_dotted(cfg, key, parsed)
    return cfg


def config_to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {
            f.name: config_to_dict(getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)
        }
    if isinstance(cfg, enum.Enum):
        return cfg.name
    if isinstance(cfg, tuple):
        return list(cfg)
    return cfg


def format_config(cfg: SparseEventIDConfig) -> str:
    return yaml.safe_dump(config_to_dict(cfg), sort_keys=False)
