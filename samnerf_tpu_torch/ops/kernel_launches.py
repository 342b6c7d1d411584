"""The hand-written kernels' launch counters, in one place.

Each wrapper of a hand-written kernel counts, in an attribute of its own,
the launches it makes for CUDA tensors, where it makes them and nowhere
else, and registers that counter here under the kernel's label, with the
names of the ``__global__`` functions it launches.  Scripts reset and
read every counter through :func:`reset` and :func:`counts`.

A CUDA graph's capture runs the wrappers, so a captured launch is
counted once, at the capture; a replay runs the captured kernels again
without Python and counts nothing.  What ran on the card, replays
included, is read from a profiler trace instead: :func:`trace_counts`
counts each label's kernels by name among a trace's device events.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

COUNTERS: Dict[str, Tuple[Callable, str, "re.Pattern"]] = {}
"""label -> (wrapper, counter attribute, pattern of its kernels' names)."""


def register(label: str, wrapper: Callable, kernels: Sequence[str],
             attr: str = "launches") -> None:
    """Start ``wrapper.<attr>`` at 0 and register it as ``label``'s
    counter; ``kernels``: the names of the ``__global__`` functions a
    counted launch runs."""
    setattr(wrapper, attr, 0)
    names = "|".join(re.escape(k) for k in kernels)
    COUNTERS[label] = (wrapper, attr, re.compile(rf"(?<!\w)(?:{names})(?!\w)"))


def _labels(labels: Optional[Iterable[str]]) -> Iterable[str]:
    return COUNTERS if labels is None else labels


def reset(labels: Optional[Iterable[str]] = None) -> None:
    """Set the counters of ``labels`` (default: all) to 0."""
    for label in _labels(labels):
        wrapper, attr, _ = COUNTERS[label]
        setattr(wrapper, attr, 0)


def counts(labels: Optional[Iterable[str]] = None) -> Dict[str, int]:
    """The counters of ``labels`` (default: all), by label."""
    out = {}
    for label in _labels(labels):
        wrapper, attr, _ = COUNTERS[label]
        out[label] = getattr(wrapper, attr)
    return out


def trace_counts(kernel_names: Iterable[str],
                 labels: Optional[Iterable[str]] = None) -> Dict[str, int]:
    """How many of ``kernel_names`` (the names of a trace's device kernels,
    one per run) are each label's kernels."""
    names = list(kernel_names)
    return {label: sum(1 for n in names if COUNTERS[label][2].search(n))
            for label in _labels(labels)}
