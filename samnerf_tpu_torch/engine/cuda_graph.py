"""One dispatch for a block of training steps, a serve frame, a SAM
encode or decode, or a zoo chunk: CUDA graphs.

The JAX package runs ``steps_per_dispatch`` training steps as one
``lax.scan`` dispatch and a serve frame as one ``jax.jit`` dispatch; the
port captures the same work once as a CUDA graph and replays it.  A graph
holds its kernels' arguments, so what changes from one replay to the next
(the per-step schedule values, a frame's camera and click) lives in
static device tensors refilled before each replay (a frame's through
:meth:`KeyedGraphs.call`), and a
``torch.Generator`` the work draws from is registered with the graph, so
that each replay draws what the eager run would draw next.

The kernel wrappers' launch counters (:mod:`samnerf_tpu_torch.ops.kernel_launches`)
count a captured launch once, at the capture, and a replay not at all: a
replay's kernels are read from a profiler trace of it.

A failed capture raises; nothing falls back to the eager path.
"""
from __future__ import annotations

import contextlib
import dataclasses
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
        self.statics: Dict[Hashable, tuple] = {}    # key -> :meth:`call`'s inputs

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

    def call(self, key: Hashable, fn: Callable[..., Any], held: Callable[[], tuple],
             *inputs):
        """``fn(*inputs)`` through :meth:`run`, on the graph's own copies of
        ``inputs`` (tensors, dataclasses of tensors such as cameras, ints as
        0-d int64 tensors), made at a key's first call and refilled from
        ``inputs`` before each: ``(outputs, how)``, the outputs (a dict or a
        sequence of tensors) copied out of the graph's memory and ordered on
        the current stream."""
        device = self.stream.device
        current = torch.cuda.current_stream(device)
        with self.on_stream():
            if key not in self.statics:
                self.statics[key] = tuple(_static_copy(x, device) for x in inputs)
            static = self.statics[key]
            for dst, src in zip(static, inputs):
                _refill(dst, src)
            out, how = self.run(key, lambda: fn(*static), held)
            out = ({k: v.clone() for k, v in out.items()} if isinstance(out, dict)
                   else tuple(v.clone() for v in out))
        for v in (out.values() if isinstance(out, dict) else out):
            v.record_stream(current)
        return out, how


def _static_copy(x, device):
    if isinstance(x, int):
        return torch.tensor(x, dtype=torch.int64, device=device)
    if isinstance(x, torch.Tensor):
        return x.to(device, copy=True)
    return dataclasses.replace(x, **{
        f.name: getattr(x, f.name).clone() for f in dataclasses.fields(x)
        if isinstance(getattr(x, f.name), torch.Tensor)})


def _refill(dst, src) -> None:
    if isinstance(src, int):
        dst.fill_(src)
    elif isinstance(src, torch.Tensor):
        dst.copy_(src)
    else:
        for f in dataclasses.fields(src):
            if isinstance(getattr(src, f.name), torch.Tensor):
                getattr(dst, f.name).copy_(getattr(src, f.name))
