"""One dispatch for a block of training steps, a serve frame, a SAM
encode or decode, or a zoo chunk: CUDA graphs.

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

import contextlib
import gc
from typing import Any, Callable, Dict, Hashable, Sequence

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
            generators: Sequence[torch.Generator] = (), pool=None) -> CapturedGraph:
    """Capture ``fn()`` on ``stream``, where it has run eagerly at least once
    (cuBLAS, cuDNN and the autograd engine set up per stream on first use,
    which a capture cannot).  ``fn`` reads its inputs from static tensors
    and changes no host state.  ``generators``: device generators ``fn``
    draws from (the default one is registered by torch).  Capture errors
    only for this thread's unsafe calls (a host sync in ``fn`` raises);
    another thread may use the device meanwhile, as a viewer does.  The
    cyclic garbage collector runs before the capture and not during it:
    a graph that it destroyed inside a capture (one held by an unreachable
    cycle) would invalidate the capture.  ``pool``: a memory pool shared
    with other graphs (``torch.cuda.graph_pool_handle()``), else the graph's
    own."""
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            outputs = fn()
    finally:
        if enabled:
            gc.enable()
    return CapturedGraph(graph, outputs)


class KeyedGraphs:
    """Graphs by key, as ``jax.jit`` keeps a trace per static signature:
    a key's first call runs ``fn`` eagerly and captures it, later calls
    replay it.  A key's graph is captured anew, in place of the old one,
    when ``held`` (the addresses and shapes of the tensors the work reads
    and writes in place) differs from the capture's.  Calls run on a side
    stream of the device (:meth:`on_stream`), which a capture needs.
    ``share_pool``: the graphs capture into one memory pool, so that many
    keys reserve about what the largest graph needs, as they never run at
    once; a replay may then overwrite the memory of any graph's outputs,
    so a caller copies what it keeps before the next :meth:`run`.  Else
    each graph has a pool of its own."""

    def __init__(self, device, share_pool: bool = False):
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle() if share_pool else None
        self.graphs: Dict[Hashable, tuple] = {}     # key -> (held, CapturedGraph)

    @contextlib.contextmanager
    def on_stream(self):
        """Run the block on the side stream, ordered after and before the
        current stream's work."""
        current = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            yield
        current.wait_stream(self.stream)

    def run(self, key: Hashable, fn: Callable[[], Any], held: Callable[[], tuple],
            generators: Sequence[torch.Generator] = ()):
        """Inside :meth:`on_stream`: ``(outputs, how)``, ``how`` "replayed"
        (the outputs are the graph's, overwritten by its next replay, or
        with ``share_pool`` by the next replay of any graph) or "captured"
        (``fn`` ran eagerly and its outputs are returned; the capture ran
        nothing).  ``held()`` is read before a replay and after the eager
        run (which may make tensors, as Adam's first update makes its
        moments)."""
        entry = self.graphs.get(key)
        if entry is not None and entry[0] == held():
            return entry[1].replay(), "replayed"
        self.graphs.pop(key, None)      # frees the old graph (and its pool) first
        outputs = fn()
        self.graphs[key] = (held(), capture(fn, self.stream, generators, self.pool))
        return outputs, "captured"
