"""One dispatch for a block of training steps or a serve frame: CUDA
graphs.

The JAX package runs ``steps_per_dispatch`` training steps as one
``lax.scan`` dispatch and a serve frame as one ``jax.jit`` dispatch; the
port captures the same work once as a CUDA graph and replays it.  A graph
holds its kernels' arguments, so what changes from one replay to the next
(the per-step schedule values, a frame's camera and click) lives in
static device tensors that the caller refills before each replay, and a
``torch.Generator`` the work draws from is registered with the graph, so
that each replay draws what the eager run would draw next.

The kernel wrappers' launch counters (:mod:`samnerf_tpu_torch.ops.kernel_launches`)
count a captured launch once, at the capture, and a replay not at all: a
replay's kernels are read from a profiler trace of it.

A failed capture raises; nothing falls back to the eager path.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch


class CapturedGraph:
    """A captured graph and the outputs of the captured function (tensors
    in the graph's memory, overwritten by every replay)."""

    def __init__(self, graph: torch.cuda.CUDAGraph, outputs):
        self.graph = graph
        self.outputs = outputs

    def replay(self):
        """Replay on the current stream; returns the outputs."""
        self.graph.replay()
        return self.outputs


def capture(fn: Callable[[], Any], stream: torch.cuda.Stream,
            generators: Sequence[torch.Generator] = ()) -> CapturedGraph:
    """Capture ``fn()`` on ``stream``, where it has run eagerly at least once
    (cuBLAS, cuDNN and the autograd engine set up per stream on first use,
    which a capture cannot).  ``fn`` reads its inputs from static tensors
    and changes no host state.  ``generators``: device generators ``fn``
    draws from (the default one is registered by torch).  Capture errors
    only for this thread's unsafe calls (a host sync in ``fn`` raises);
    another thread may use the device meanwhile, as a viewer does."""
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
        outputs = fn()
    return CapturedGraph(graph, outputs)
