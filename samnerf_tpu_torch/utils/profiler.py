"""A wall-clock function profiler and device traces.

Counterpart of ``samnerf_tpu/utils/profiler.py``: ``@time_function``
keeps each function's running mean time while the profiler is enabled,
and :func:`flush_profiler` prints them, slowest first.  JAX's
``jax.profiler`` traces (``jax_trace``, ``DeviceTrace``) become one
``torch.profiler`` context over the CPU and, where there is one, the
card: :class:`DeviceTrace` writes a Chrome trace, ``trace.json``, into
its ``log_dir``.
"""
from __future__ import annotations

import functools
import time
from pathlib import Path
from typing import Dict

import torch

PROFILER_ENABLED = False
_STATS: Dict[str, list] = {}


def enable_profiler(enabled: bool = True):
    global PROFILER_ENABLED
    PROFILER_ENABLED = enabled


def time_function(fn):
    """Time each call of ``fn`` while the profiler is enabled."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not PROFILER_ENABLED:
            return fn(*args, **kwargs)
        t0 = time.time()
        out = fn(*args, **kwargs)
        dt = time.time() - t0
        name = fn.__qualname__
        mean, count = _STATS.get(name, (0.0, 0))
        _STATS[name] = [(mean * count + dt) / (count + 1), count + 1]
        return out

    return wrapper


def flush_profiler():
    """Print the mean seconds per call of every timed function, slowest
    first (nothing when none was timed)."""
    if not _STATS:
        return
    print("Profiler (mean seconds per call):")
    for name, (mean, count) in sorted(_STATS.items(), key=lambda kv: -kv[1][0]):
        print(f"  {name:60s} {mean:10.4f}s  x{count}")


class DeviceTrace:
    """``torch.profiler`` over the CPU and, where available, CUDA;
    on exit the Chrome trace goes to ``log_dir/trace.json``::

        with DeviceTrace("traces") as trace:
            trainer.train_iteration(step)
        trace.profile.key_averages()
    """

    def __init__(self, log_dir):
        self.log_dir = Path(log_dir)
        self.profile = None

    @property
    def path(self) -> Path:
        return self.log_dir / "trace.json"

    def __enter__(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.profile = torch.profiler.profile(activities=activities)
        self.profile.__enter__()
        return self

    def __exit__(self, *exc):
        self.profile.__exit__(*exc)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.profile.export_chrome_trace(str(self.path))
        return False
