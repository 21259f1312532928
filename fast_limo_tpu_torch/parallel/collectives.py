"""The collectives of the multi-device layer, behind one interface.

The JAX package takes its collectives from ``jax.lax`` inside
``shard_map``; the port's models call the handle of their rank instead
(``Comm``), which offers exactly the operations that code uses:

* ``axis_index(axis)`` — this rank's coordinate on a mesh axis;
* ``all_gather(x, axis)`` — the tensors of the axis' ranks stacked on a
  new leading axis, in rank order;
* ``psum(x, axis)`` / ``pmax(x, axis)`` — the sum (added in rank order,
  so the result does not depend on arrival order) / maximum over the axis;
* ``barrier()``.

A mesh is a row-major layout of ``size`` ranks over named axes
(``{"map": 2, "data": 2}``: rank = map_index·2 + data_index); a
collective over one axis runs among the ranks that share every other
coordinate.  Every rank must issue every collective in the same order,
as under ``shard_map``: the models keep their collective sequence free of
data-dependent branches (each ``lax.cond`` branch is computed and
selected with ``torch.where``).

Two backends:

* ``InProcessGroup`` — the ``size`` ranks run in one process, one thread a
  rank, on one device and one CUDA stream.  A collective is a host
  rendezvous (a ``threading.Barrier`` and a slot a rank) around
  ``torch.stack`` / a rank-order sum or maximum over the ranks' tensors;
  nothing is read from the device.  One rank runs Python at a time (a
  lock, released while a rank waits at a collective), so the port's host
  state (launch counters, caches) needs no lock of its own and every
  rank's launches are enqueued whole between two collectives.  A rank
  that raises breaks the barrier: every rank stops and ``run`` re-raises
  the first error in the caller.
* ``DistComm`` — one rank a process over ``torch.distributed`` (gloo, CPU
  tensors; see parallel/distributed.py), on a mesh of one axis.  ``psum``
  and ``pmax`` are an all-gather followed by the same rank-order
  reduction, so both backends give the same bits.

Each handle counts the bytes its rank receives, by tag (``received``),
with the ring accounting of ``sharded.comm_volume`` (the JAX package's
``fast_limo_tpu/parallel/sharded.py:88-90``): an all-gather receives
(D−1)/D of its output, an all-reduce (psum, pmax) moves 2(D−1)/D of its
operand; an axis of one rank moves nothing.
"""

from __future__ import annotations

import contextlib
import math
import threading
import time
from typing import Callable, Dict, List

import torch


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class Comm:
    """One rank's handle on a mesh of named axes (row-major rank layout)."""

    def __init__(self, axes: Dict[str, int], rank: int):
        self.axes = dict(axes)
        self.size = math.prod(self.axes.values())
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size} ranks")
        self.rank = rank
        self.received: Dict[str, float] = {}

    # ------------------------------------------------------------ layout
    def coords(self, rank: int = None) -> Dict[str, int]:
        """The mesh coordinates of ``rank`` (default: this rank)."""
        r = self.rank if rank is None else rank
        out = {}
        for name in reversed(list(self.axes)):
            out[name] = r % self.axes[name]
            r //= self.axes[name]
        return {name: out[name] for name in self.axes}

    def rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for name, n in self.axes.items():
            r = r * n + coords[name]
        return r

    def axis_size(self, axis: str) -> int:
        return self.axes[axis]

    def axis_index(self, axis: str) -> int:
        return self.coords()[axis]

    def group(self, axis: str, rank: int = None) -> List[int]:
        """The ranks of ``axis`` through ``rank`` (default: this rank), in
        axis order."""
        c = self.coords(rank)
        return [self.rank_of({**c, axis: i}) for i in range(self.axes[axis])]

    # ------------------------------------------------------- collectives
    def _count(self, tag: str, nbytes: float) -> None:
        self.received[tag] = self.received.get(tag, 0.0) + nbytes

    def all_gather(self, x: torch.Tensor, axis: str, tag: str = "other") -> torch.Tensor:
        """(D, *x.shape): the axis' tensors in rank order."""
        D = self.axes[axis]
        self._count(tag, (D - 1) * _nbytes(x))
        return self._exchange("all_gather", x, axis)

    def psum(self, x: torch.Tensor, axis: str, tag: str = "other") -> torch.Tensor:
        D = self.axes[axis]
        self._count(tag, 2.0 * (D - 1) / D * _nbytes(x))
        return self._exchange("psum", x, axis)

    def pmax(self, x: torch.Tensor, axis: str, tag: str = "other") -> torch.Tensor:
        D = self.axes[axis]
        self._count(tag, 2.0 * (D - 1) / D * _nbytes(x))
        return self._exchange("pmax", x, axis)

    def barrier(self) -> None:
        raise NotImplementedError

    def _exchange(self, kind: str, x: torch.Tensor, axis: str) -> torch.Tensor:
        raise NotImplementedError


def _reduce(kind: str, xs: List[torch.Tensor]) -> torch.Tensor:
    """The collective's result from the axis' tensors, in rank order."""
    if kind == "all_gather":
        return torch.stack(xs)
    out = xs[0]
    for x in xs[1:]:
        out = out + x if kind == "psum" else torch.maximum(out, x)
    return out


class _InProcessComm(Comm):
    def __init__(self, group: "InProcessGroup", rank: int):
        super().__init__(group.axes, rank)
        self._g = group

    def _exchange(self, kind, x, axis):
        return self._g._exchange(self.rank, (kind, axis, x))

    def barrier(self) -> None:
        self._g._exchange(self.rank, ("barrier", None, None))


class InProcessGroup:
    """``size`` ranks in this process, one thread a rank (see the module
    docstring).  ``comms[r]`` is rank r's handle; ``run(fn)`` calls
    ``fn(comms[r])`` on every rank at once and returns the results in rank
    order.  ``timeout`` (seconds) bounds each wait at a collective; past
    it the collective breaks and the call raises."""

    def __init__(self, axes: Dict[str, int], timeout: float = 600.0):
        self.axes = dict(axes)
        self.size = math.prod(self.axes.values())
        self.timeout = float(timeout)
        self.comms = [_InProcessComm(self, r) for r in range(self.size)]
        self._lock = threading.Lock()      # one rank runs Python at a time
        self._barrier = None
        self._slots = [None] * self.size
        self._out = [None] * self.size

    def _combine(self) -> None:
        """The barrier's action (one thread, every rank waiting): each
        rank's result from its axis group's slots."""
        kinds = {(s[0], s[1]) for s in self._slots}
        if len(kinds) != 1:
            raise RuntimeError(f"the ranks issued different collectives: {sorted(map(str, kinds))}")
        kind, axis = kinds.pop()
        if kind == "barrier":
            self._out = [None] * self.size
            return
        c0 = self.comms[0]
        out = [None] * self.size
        for r in range(self.size):
            if out[r] is None:
                members = c0.group(axis, r)
                xs = [self._slots[m][2] for m in members]
                if len({(tuple(x.shape), x.dtype, x.device) for x in xs}) != 1:
                    raise RuntimeError(f"{kind} over {axis!r}: the ranks' tensors differ in "
                                       f"shape, dtype or device")
                res = _reduce(kind, xs)
                for i, m in enumerate(members):   # a tensor of its own a rank
                    out[m] = res if i == 0 else res.clone()
        self._out = out

    def _exchange(self, rank: int, slot):
        self._slots[rank] = slot
        self._lock.release()
        try:
            self._barrier.wait()
        finally:
            self._lock.acquire()
        return self._out[rank]

    def run(self, fn: Callable[[Comm], object]) -> list:
        """``[fn(comms[0]), …, fn(comms[size−1])]``, the ranks in threads."""
        D = self.size
        self._barrier = threading.Barrier(D, action=self._combine, timeout=self.timeout)
        self._slots = [None] * D
        results, errors = [None] * D, [None] * D
        stream = torch.cuda.current_stream() if torch.cuda.is_initialized() else None

        def body(r):
            with self._lock:
                try:
                    ctx = torch.cuda.stream(stream) if stream is not None \
                        else contextlib.nullcontext()
                    with ctx:
                        results[r] = fn(self.comms[r])
                except BaseException as e:     # noqa: B902 (re-raised by run)
                    errors[r] = e
                    self._barrier.abort()

        threads = [threading.Thread(target=body, args=(r,), name=f"rank{r}", daemon=True)
                   for r in range(D)]
        for t in threads:
            t.start()
        # every wait at a collective is bounded; once the barrier is broken
        # (a rank raised or timed out), a rank still running after another
        # timeout is stuck outside any collective
        broken_at = None
        while any(t.is_alive() for t in threads):
            for t in threads:
                t.join(0.05)
            if self._barrier.broken:
                broken_at = broken_at or time.monotonic()
                if time.monotonic() - broken_at > self.timeout:
                    raise TimeoutError(f"an in-process rank still runs {self.timeout} s "
                                       f"after the collective broke")
        first = [e for e in errors if e is not None
                 and not isinstance(e, threading.BrokenBarrierError)]
        if first:
            raise first[0]
        if any(e is not None for e in errors):
            raise next(e for e in errors if e is not None)
        return results


class DistComm(Comm):
    """This process's rank over ``torch.distributed`` (initialised by the
    caller, world size = the mesh's size) on a mesh of one axis: the
    collectives run over the world group."""

    def __init__(self, axes: Dict[str, int]):
        import torch.distributed as dist

        if len(axes) != 1:
            raise ValueError(f"a process-spanning mesh has one axis, got {list(axes)}")
        super().__init__(axes, dist.get_rank())
        if dist.get_world_size() != self.size:
            raise ValueError(f"a mesh of {self.size} ranks over a world of "
                             f"{dist.get_world_size()} processes")

    def _exchange(self, kind, x, axis):
        import torch.distributed as dist

        xs = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(xs, x.contiguous())
        return _reduce(kind, xs)

    def barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier()
