"""Event-buffer metrics writer.

Counterpart of ``samnerf_tpu/utils/writer.py``, same event names and
rows: producers call :func:`put_scalar`, :func:`put_dict`,
:func:`put_image` and :func:`put_time`; windowed running averages live in
``GLOBAL_BUFFER``; :func:`write_out_storage` flushes the queued events to
the registered writers once per step (terminal, TensorBoard, wandb,
JSON).  TensorBoard (``torch.utils.tensorboard``) and wandb are imported
only when their writer is made, and each raises ``ImportError`` when its
package is absent.
"""
from __future__ import annotations

import enum
import json
from collections import deque
from pathlib import Path
from typing import Any, Dict, List

import numpy as np


class EventName(enum.Enum):
    ITER_TRAIN_TIME = "Train Iter (time)"
    TOTAL_TRAIN_TIME = "Train Total (time)"
    RAYS_PER_SEC = "Rays / Sec"
    CURR_TEST_PSNR = "Test PSNR"
    VIS_RAYS_PER_SEC = "Vis Rays / Sec"
    TEST_RAYS_PER_SEC = "Test Rays / Sec"


GLOBAL_BUFFER: Dict[str, Any] = {"events": {}, "max_buffer_size": 20, "step": 0}

_EVENTS: List[Dict[str, Any]] = []


def _name(name) -> str:
    return name.value if isinstance(name, EventName) else name


def put_scalar(name, scalar, step: int):
    _EVENTS.append({"name": _name(name), "write_type": "scalar",
                    "event": float(scalar), "step": step})


def put_dict(name: str, d: Dict[str, float], step: int):
    _EVENTS.append({"name": name, "write_type": "dict", "event": d, "step": step})


def put_image(name, image, step: int):
    _EVENTS.append({"name": _name(name), "write_type": "image", "event": image,
                    "step": step})


def put_time(name, duration: float, step: int, avg_over_steps: bool = True):
    """A duration, and its running average over the last
    ``max_buffer_size`` steps in ``GLOBAL_BUFFER``."""
    name = _name(name)
    put_scalar(name, duration, step)
    if avg_over_steps:
        GLOBAL_BUFFER["step"] = step
        curr = GLOBAL_BUFFER["events"].get(
            name, {"buffer": deque(maxlen=GLOBAL_BUFFER["max_buffer_size"]), "avg": 0.0})
        curr["buffer"].append(duration)
        curr["avg"] = sum(curr["buffer"]) / len(curr["buffer"])
        GLOBAL_BUFFER["events"][name] = curr


class Writer:
    def write_scalar(self, name: str, value: float, step: int):
        raise NotImplementedError

    def write_image(self, name: str, image, step: int):
        pass


class LocalWriter(Writer):
    """The latest value of each scalar, printed every ``log_every`` steps."""

    def __init__(self, log_every: int = 100):
        self.log_every = log_every
        self._latest: Dict[str, float] = {}

    def write_scalar(self, name, value, step):
        self._latest[name] = value
        if step % self.log_every == 0:
            stats = " ".join(f"{k}={v:.4g}" for k, v in sorted(self._latest.items()))
            print(f"[step {step}] {stats}")


class JsonWriter(Writer):
    """Scalar rows ``{"name", "value", "step"}``, written by :meth:`flush`."""

    def __init__(self, path: Path):
        self.path = Path(path)
        self.rows: List[dict] = []

    def write_scalar(self, name, value, step):
        self.rows.append({"name": name, "value": value, "step": step})

    def flush(self):
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(json.dumps(self.rows))


class TensorboardWriter(Writer):
    def __init__(self, log_dir: Path):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            raise ImportError("`vis tensorboard` requires the tensorboard package") from e
        self.tb = SummaryWriter(log_dir=str(log_dir))

    def write_scalar(self, name, value, step):
        self.tb.add_scalar(name, value, step)

    def write_image(self, name, image, step):
        self.tb.add_image(name, np.asarray(image), step, dataformats="HWC")

    def flush(self):
        self.tb.flush()


class WandbWriter(Writer):
    """Weights & Biases; construction raises ImportError without the
    ``wandb`` package."""

    def __init__(self, log_dir: Path, experiment_name: str = "samnerf_tpu_torch"):
        try:
            import wandb
        except ImportError as e:
            raise ImportError("`vis wandb` requires the wandb package "
                              "(pip install wandb)") from e
        self._wandb = wandb
        wandb.init(project=experiment_name, dir=str(log_dir), reinit=True)

    def write_scalar(self, name, value, step):
        self._wandb.log({name: value}, step=step)

    def write_image(self, name, image, step):
        self._wandb.log({name: self._wandb.Image(np.asarray(image))}, step=step)


_WRITERS: List[Writer] = []


def setup_local_writer(log_every: int = 100):
    _WRITERS.append(LocalWriter(log_every=log_every))


def setup_event_writer(kind: str, log_dir: Path):
    if kind == "tensorboard":
        _WRITERS.append(TensorboardWriter(log_dir))
    elif kind == "wandb":
        _WRITERS.append(WandbWriter(log_dir))
    elif kind == "json":
        _WRITERS.append(JsonWriter(Path(log_dir) / "metrics.json"))


def finalize():
    """Flush the writers that buffer (the end of training)."""
    for w in _WRITERS:
        if hasattr(w, "flush"):
            w.flush()


def reset():
    """Flush and drop every registered writer (a new run in the same
    process must not write into the previous run's sinks)."""
    finalize()
    _WRITERS.clear()


def write_out_storage():
    """Hand the queued events to every writer, then drop them."""
    global _EVENTS
    for ev in _EVENTS:
        for w in _WRITERS:
            if ev["write_type"] == "scalar":
                w.write_scalar(ev["name"], ev["event"], ev["step"])
            elif ev["write_type"] == "dict":
                for k, v in ev["event"].items():
                    w.write_scalar(f"{ev['name']}/{k}", float(v), ev["step"])
            elif ev["write_type"] == "image":
                w.write_image(ev["name"], ev["event"], ev["step"])
    _EVENTS = []
