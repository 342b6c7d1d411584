"""Training entry point of the port.

Counterpart of ``samnerf_tpu/train.py`` for the ``samnerf_distill`` and
``samnerf_no_distill`` presets on one NVIDIA GPU::

    python -m samnerf_tpu_torch.train samnerf_distill --data /path/to/scene \\
        [--trainer.max-num-iterations N] [--model.hash-fn reference] ...

Writes ``config.json`` and ``samnerf_tpu_torch_ckpts/step-*.pt`` under
``<output_dir>/<scene>/<method>/<timestamp>/``.  The viewer, the event
writers and the model zoo wait.
"""
from __future__ import annotations

import dataclasses
import json
import random
import sys
import time
from pathlib import Path
from typing import List

import numpy as np
import torch

from samnerf_tpu_torch.configs.cli import apply_overrides
from samnerf_tpu_torch.configs.methods import MethodConfig, method_configs


def parse(argv: List[str]) -> MethodConfig:
    """``<method> [--dotted.option value ...]`` -> the preset with its
    overrides applied.  Help exits 0, an unknown method 2."""
    registry = method_configs()
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("methods:", ", ".join(registry))
        raise SystemExit(0)
    if argv[0] not in registry:
        print(f"unknown method {argv[0]!r}; available: {', '.join(registry)}")
        raise SystemExit(2)
    return apply_overrides(registry[argv[0]], argv[1:])


def save_config(config: MethodConfig) -> None:
    out = Path(config.trainer.output_dir)
    out.mkdir(parents=True, exist_ok=True)

    def enc(o):
        if dataclasses.is_dataclass(o):
            return {f.name: enc(getattr(o, f.name)) for f in dataclasses.fields(o)}
        if isinstance(o, dict):
            return {k: enc(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return [enc(v) for v in o]
        if o is None or isinstance(o, (bool, int, float, str)):
            return o
        return str(o)

    (out / "config.json").write_text(json.dumps(enc(config), indent=2))


def train_loop(config: MethodConfig, device="cuda"):
    """Seed, build the data and the trainer, train."""
    from samnerf_tpu_torch.data.datamanager import DataManager
    from samnerf_tpu_torch.engine.trainer import Trainer

    seed = config.trainer.seed
    random.seed(seed)
    np.random.seed(seed)
    dm = DataManager(config.datamanager)
    trainer = Trainer(config.model, config.trainer, config.optimizers, dm,
                      device=device)
    trainer.train()
    return trainer


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    config = parse(argv)
    if not torch.cuda.is_available():
        print("samnerf_tpu_torch.train: no CUDA device", file=sys.stderr)
        return 1
    config.trainer.output_dir = (Path(config.trainer.output_dir)
                                 / Path(config.datamanager.dataparser.data).name
                                 / config.method_name / time.strftime("%Y-%m-%d_%H%M%S"))
    save_config(config)
    train_loop(config)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
