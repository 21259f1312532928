"""A stage of the scan step replayed as one captured CUDA graph.

``StageGraph(fn, counts, ineligible)`` calls ``fn``, a function of
tensors (nested tuples of tensors and None in, the same out), and runs it
as the replay of one ``torch.cuda.CUDAGraph`` where the call allows it:
the same hand-written kernels and glue, one graph launch in place of
hundreds of kernel launches.

* The call is captured where its tensors lie on a CUDA device and
  ``ineligible()`` gives no reason (a path whose collectives or host reads
  cannot be captured names itself there); otherwise ``fn`` runs eagerly.
* A graph is keyed on what the call shows: the device and every input's
  shape and dtype.  A new key runs ``WARMUP`` eager calls on a side stream
  (lazy per-device constants, kernel attributes and the side stream's
  cuBLAS workspace come into being there), then captures on that stream;
  from then on a call copies its inputs into the graph's static buffers
  (``copy_``), replays on the current stream and returns fresh copies of
  the outputs, so no buffer the graph writes leaves the call.
* The kernel wrappers' launch counters (``dispatch.counters``) count a
  replay's kernels as launches, and not the capture's.  The captured
  ``cudaGraph_t`` is kept (``captured``), so its nodes can be read.
* ``counts`` (``utils/telemetry.GraphCounts``) records captures, replays
  and eager calls by reason.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils import _pytree as pytree

from fast_limo_tpu_torch.ops import dispatch


def _tensors(flat):
    return [t for t in flat if isinstance(t, torch.Tensor)]


def _clone(tree):
    return pytree.tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: list          # static input buffers, in leaf order (None kept)
    out: object           # the captured outputs (the graph writes them)
    launched: list        # (wrapper, counter, launches a replay)


class StageGraph:
    """``fn`` replayed as a captured CUDA graph where the call allows it
    (module docstring); ``WARMUP`` eager calls a key before its capture."""

    WARMUP = 2

    def __init__(self, fn, counts, ineligible):
        self.fn, self.counts, self.ineligible = fn, counts, ineligible
        self._graphs, self._warm, self._side = {}, {}, {}

    def __call__(self, *args):
        flat, spec = pytree.tree_flatten(args)
        leaves = _tensors(flat)
        why = self.ineligible() or (None if leaves[0].is_cuda else "cpu")
        if why is not None:
            self.counts.eager_call(why)
            return self.fn(*args)
        dev = leaves[0].device
        key = (dev, tuple((t.shape, t.dtype) for t in leaves))
        g = self._graphs.get(key)
        if g is None:
            n = self._warm.get(key, 0)
            if n < self.WARMUP:
                self._warm[key] = n + 1
                self.counts.eager_call("warm-up")
                return self._on_side(dev, args)
            g = self._graphs[key] = self._capture(dev, flat, spec)
            self.counts.captures += 1
        else:
            for s, t in zip(_tensors(g.inputs), leaves):
                s.copy_(t)
        g.graph.replay()
        for f, name, n in g.launched:
            setattr(f, name, getattr(f, name) + n)
        self.counts.replays += 1
        return _clone(g.out)

    def captured(self):
        """The captured graphs (``torch.cuda.CUDAGraph``, its
        ``raw_cuda_graph()`` kept), one a key."""
        return [g.graph for g in self._graphs.values()]

    def _stream(self, dev):
        s = self._side.get(dev)
        if s is None:
            s = self._side[dev] = torch.cuda.Stream(dev)
        return s

    def _on_side(self, dev, args):
        """An eager call on the side stream, ordered after the current
        stream's work and before whatever it enqueues next."""
        cur, side = torch.cuda.current_stream(dev), self._stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self.fn(*args)
        cur.wait_stream(side)
        return out

    def _capture(self, dev, flat, spec) -> _Graph:
        # the static inputs, made before the capture
        inputs = [t.clone() if isinstance(t, torch.Tensor) else t for t in flat]
        cur, side = torch.cuda.current_stream(dev), self._stream(dev)
        side.wait_stream(cur)
        before = {(f, name): getattr(f, name) for f, name in dispatch.counters()}
        graph = torch.cuda.CUDAGraph(keep_graph=True)   # instantiated at its first replay
        # capture_begin/end, not torch.cuda.graph: that one synchronizes and
        # empties the allocator's cache, which the steady state then refills
        # with cudaMalloc calls
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = self.fn(*pytree.tree_unflatten(inputs, spec))
            finally:
                graph.capture_end()
        launched = []
        for f, name in dispatch.counters():   # the capture's launches taken back
            n0 = before.get((f, name), 0)
            if getattr(f, name) != n0:
                launched.append((f, name, getattr(f, name) - n0))
                setattr(f, name, n0)
        cur.wait_stream(side)
        return _Graph(graph, inputs, out, launched)
