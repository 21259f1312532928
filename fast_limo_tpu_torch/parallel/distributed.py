"""Process-spanning runtime of the sharded step (port of
fast_limo_tpu/parallel/distributed.py) on ``torch.distributed``.

The sharded scan step (parallel/sharded.py) runs unchanged over a mesh
whose ranks are processes (backend ``"gloo"``: one rank a process, CPU
tensors, the collectives of parallel/collectives.DistComm).  What it
needs around it, this module provides:

* ``initialize`` — ``torch.distributed.init_process_group`` with an
  explicit address, world size and rank (nothing here reads a cluster's
  environment);
* ``fetch`` — the global host (numpy) value of a mesh state on every
  process: the map shards all-gathered over the 'map' axis;
* ``save_checkpoint`` / ``load_checkpoint`` — one checkpoint written from
  rank 0 in the single-card format of utils/checkpoint.py (a checkpoint
  from either topology, and from either package, restores on the other);
  on load each process keeps only its own shard of the map.

The same calls take an in-process mesh (the state is already global
there) or ``mesh=None`` (a single-card state).  The gloo backend has run
on CPU processes only (tests/test_torch_distributed.py); no NCCL run of
it has been made.
"""

from __future__ import annotations

import numpy as np
import torch

from fast_limo_tpu_torch.parallel import sharded
from fast_limo_tpu_torch.utils import checkpoint as ckpt


def initialize(coordinator_address: str, num_processes: int, process_id: int, **kw) -> None:
    """Join the gloo process group at ``coordinator_address`` ("host:port")."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, **kw)


def _process_spanning(mesh) -> bool:
    return mesh is not None and mesh.backend != "inprocess"


def _axis_of(tree) -> dict:
    """{leaf path: the mesh axis its rows are sharded over, or None}
    (``sharded._state_specs``: the map's table rows)."""
    flat = ckpt._flatten_with_paths(sharded._state_specs())
    return {k: flat.get(k) for k in ckpt._flatten_with_paths(tree)}


def fetch(tree, mesh=None):
    """Host numpy value of a state (or any NamedTuple tree) on EVERY
    process: over a process-spanning mesh the sharded leaves (the map's
    table rows) are all-gathered over their axis and concatenated in rank
    order."""
    if not _process_spanning(mesh):
        return ckpt._rebuild(tree, lambda _k, a: ckpt._to_numpy(a))
    comm = mesh.comms[0]
    axis_of = _axis_of(tree)

    def one(key, a):
        axis = axis_of.get(key)
        if axis is None:
            return ckpt._to_numpy(a)
        g = comm.all_gather(a, axis, "checkpoint_allgather_bytes")
        return ckpt._to_numpy(g.reshape((-1,) + tuple(a.shape[1:])))

    return ckpt._rebuild(tree, one)


def barrier(mesh=None) -> None:
    """Cross-process sync point (e.g. after rank 0 wrote a checkpoint); a
    no-op without a process-spanning mesh."""
    if _process_spanning(mesh):
        mesh.comms[0].barrier()


def save_checkpoint(path: str, state, mesh=None, extra: dict = None) -> None:
    """Write a mesh state's global value once, from rank 0, in the
    single-card format; returns after a barrier, so the file is complete
    on return for every process."""
    host = fetch(state, mesh)
    if not _process_spanning(mesh) or mesh.rank == 0:
        ckpt.save_state(path, host, extra=extra or {})
    barrier(mesh)


def load_checkpoint(path: str, template, mesh=None):
    """Restore a checkpoint of the GLOBAL layout (``template``: e.g.
    ``sharded.init_global_state(cfg, n)``, whose leaves give the dtypes,
    shapes and device) onto a mesh: in-process (or ``mesh=None``) the
    global state; over a process-spanning mesh this process's state, the
    sharded leaves cut to its rows."""
    host = ckpt.load_host_arrays(path, template)
    devices = {k: v.device for k, v in ckpt._flatten_with_paths(template).items()}
    if not _process_spanning(mesh):
        return ckpt._rebuild(host, lambda k, a: torch.tensor(a, device=devices[k]))
    comm = mesh.comms[0]
    axis_of = _axis_of(template)

    def one(key, a):
        axis = axis_of.get(key)
        if axis is not None:
            n = comm.axis_size(axis)
            rows = a.shape[0] // n
            i = comm.axis_index(axis)
            a = np.ascontiguousarray(a[i * rows:(i + 1) * rows])
        return torch.tensor(a, device=devices[key])

    return ckpt._rebuild(host, one)
