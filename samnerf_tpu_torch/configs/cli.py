"""Dataclass CLI: dotted ``--a.b.c value`` overrides over a method preset.

The port's copy of ``samnerf_tpu/configs/cli.py``, same syntax:
``python -m samnerf_tpu_torch.train samnerf_distill --data /path
--trainer.max-num-iterations 100``.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, List, Sequence


def _coerce(value: str, current: Any):
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int) and not isinstance(current, bool):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, Path):
        return Path(value)
    if isinstance(current, tuple):
        parts = [p for p in value.replace("(", "").replace(")", "").split(",") if p]
        elem = current[0] if current else 0
        return tuple(_coerce(p.strip(), elem) for p in parts)
    return value


def _set_dotted(obj: Any, path: List[str], value: str):
    head = path[0].replace("-", "_")
    if len(path) == 1:
        if not hasattr(obj, head):
            raise SystemExit(f"unknown config field: {head} on {type(obj).__name__}")
        cur = getattr(obj, head)
        coerced = _coerce(value, cur)
        try:
            setattr(obj, head, coerced)
        except dataclasses.FrozenInstanceError:
            raise SystemExit(
                f"{type(obj).__name__}.{head} is frozen; override at build time")
        return
    child = getattr(obj, head, None)
    if child is None:
        raise SystemExit(f"unknown config group: {head}")
    if dataclasses.is_dataclass(child) and getattr(child, "__dataclass_params__").frozen:
        # rebuild frozen dataclasses (model config) with replace
        leaf_path = [p.replace("-", "_") for p in path[1:]]
        new_child = _replace_frozen(child, leaf_path, value)
        setattr(obj, head, new_child)
    else:
        _set_dotted(child, path[1:], value)


def _replace_frozen(obj: Any, path: List[str], value: str):
    head = path[0]
    if len(path) == 1:
        cur = getattr(obj, head)
        return dataclasses.replace(obj, **{head: _coerce(value, cur)})
    child = getattr(obj, head)
    return dataclasses.replace(obj, **{head: _replace_frozen(child, path[1:], value)})


def apply_overrides(config: Any, argv: Sequence[str]) -> Any:
    """Apply ``--dotted.path value`` pairs to a (mutable) config tree."""
    i = 0
    args = list(argv)
    while i < len(args):
        arg = args[i]
        if not arg.startswith("--"):
            raise SystemExit(f"expected --option, got {arg!r}")
        key = arg[2:]
        if "=" in key:
            key, value = key.split("=", 1)
            i += 1
        else:
            if i + 1 >= len(args):
                raise SystemExit(f"missing value for --{key}")
            value = args[i + 1]
            i += 2
        # --data rewires the dataparser
        if key == "data":
            config.datamanager.dataparser.data = Path(value)
            continue
        _set_dotted(config, key.split("."), value)
    return config
