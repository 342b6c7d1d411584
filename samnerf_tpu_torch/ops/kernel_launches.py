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
counts each label's kernels by name among a trace's device events,
:class:`CardTrace` takes such a trace, and :func:`traced` takes it again
while it comes back short.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Tuple

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


class CardTrace:
    """The registered kernels of ``labels`` (default: all) that ran on the
    card between ``start()`` and ``stop()``, by name, from a profiler
    trace: CUDA graph replays included, which the counters do not see.
    Also a context manager.  The tracer comes up after the profiler
    starts (a zoo chunk replayed at once came back without its first
    step's three F32-ENC records) and has lost records at the end, so a
    trace begins and ends with a few no-op kernels and a sync; ``counts``
    is what it found, ``records`` the number of device records it kept."""

    def __init__(self, labels: Optional[Iterable[str]] = None):
        self.labels = None if labels is None else tuple(labels)
        self.counts: Optional[Dict[str, int]] = None
        self.records: Optional[int] = None
        self.tries = 1
        self._prof = None

    def start(self) -> "CardTrace":
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self._pad()
        return self

    @staticmethod
    def _pad() -> None:
        import torch

        pad = torch.zeros(1, device=torch.cuda.current_device())
        for _ in range(4):
            pad.add_(1)
        torch.cuda.synchronize()

    def stop(self) -> Dict[str, int]:
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        self._pad()
        self._prof.stop()
        names = [e.name() for e in self._prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA]
        self.counts = trace_counts(names, self.labels)
        self.records = len(names)
        self._prof = None
        return self.counts

    @property
    def running(self) -> bool:
        return self._prof is not None

    def __enter__(self) -> "CardTrace":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


TRACE_TRIES = 3
"""Traces per :func:`traced` call: the profiler drops a device record now
and then (a replayed bf16 frame's trace once came back one Q-ENC short,
an eager int8 frame's 41 of its 42), while a graph replays a fixed kernel
list, so a short trace is taken again."""


def traced(fn: Callable[[], Any], labels: Optional[Iterable[str]] = None,
           whole: Optional[Callable[[Any, Dict[str, int]], bool]] = None
           ) -> Tuple[Any, CardTrace]:
    """``fn()`` under a :class:`CardTrace` of ``labels``: its result and the
    trace.  ``whole(out, counts)`` says whether the trace holds what ``fn``
    ran; while it says no, ``fn`` (then idempotent: a replay) runs again
    under a new trace, at most ``TRACE_TRIES`` times in all, and the caller
    holds the last trace exactly; its ``tries`` says how many ran."""
    for tries in range(1, TRACE_TRIES + 1):
        with CardTrace(labels) as trace:
            out = fn()
        trace.tries = tries
        if whole is None or whole(out, trace.counts):
            break
    return out, trace
