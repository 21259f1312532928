"""LIOState ⇄ numpy dict: the state interchange between the two packages.

The dict holds the ``LIOState`` leaves as numpy arrays — ``x`` as its 26
flat values (state.as_vector order), ``P``, ``map.table``, ``map.ptable``,
``map.num_points``, ``map.last_time`` and the carry vectors — under the JAX
package's field names.  The map layout is identical
(``mapper.layout_version``), so the same arrays mean the same map: with
this, both packages compute the same step from the same state.  A caller
holding a JAX state builds the dict with ``np.asarray`` on its own side.
A JAX sharded state is no different: its global arrays (``np.asarray``
gathers the shards) are the port's global sharded state leaf for leaf, the
shards' table rows in rank order (parallel/sharded.py).

The SLAM layer's state crosses the same way: a ``PoseGraph`` as the dict of
its fields (``posegraph_to_numpy`` on this side, ``{f: np.asarray(getattr(g,
f)) for f in g._fields}`` on the other), a keyframe as the dict of its
dataclass fields (all numpy and Python scalars in both packages), so a
keyframe list of either package becomes the other's with
``keyframes_from_dicts``.  Session files need no conversion at all: both
packages read and write the same ``.state.npz`` / ``.keyframes.npz`` pair.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fast_limo_tpu_torch.models import mapper
from fast_limo_tpu_torch.models import pipeline as pl
from fast_limo_tpu_torch.models import posegraph
from fast_limo_tpu_torch.models import state as st
from fast_limo_tpu_torch.ops import dispatch

CARRIES = ("prev_scan_stamp", "last_prop_time", "last_w_raw_bl", "last_w",
           "last_a", "bias_gyro_corr", "bias_accel_corr", "pinned_grav")
MAP_FIELDS = ("table", "ptable", "num_points", "last_time")


def lio_state_from_numpy(d: dict, device="cuda") -> pl.LIOState:
    device = dispatch.resolve_device(device)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device).clone()

    m = mapper.VoxelHashMap(table=t(d["map.table"]), ptable=t(d["map.ptable"]),
                            num_points=t(d["map.num_points"], torch.int32),
                            last_time=t(d["map.last_time"]))
    return pl.LIOState(x=st.from_vector(t(d["x"])), P=t(d["P"]), map=m,
                       **{k: t(d[k]) for k in CARRIES})


def lio_state_to_numpy(s: pl.LIOState) -> dict:
    def n(a):
        return a.detach().cpu().numpy()

    out = {"x": n(st.as_vector(s.x)), "P": n(s.P)}
    out.update({f"map.{k}": n(getattr(s.map, k)) for k in MAP_FIELDS})
    out.update({k: n(getattr(s, k)) for k in CARRIES})
    return out


def posegraph_from_numpy(d: dict, device="cuda") -> posegraph.PoseGraph:
    """A ``PoseGraph`` from the dict of its fields (either package's)."""
    device = dispatch.resolve_device(device)
    template = posegraph.create(1, 1, 1, device=device)
    return posegraph.PoseGraph(*(
        torch.tensor(np.array(d[f]), dtype=getattr(template, f).dtype, device=device)
        for f in posegraph.PoseGraph._fields))


def posegraph_to_numpy(g: posegraph.PoseGraph) -> dict:
    return {f: getattr(g, f).detach().cpu().numpy() for f in g._fields}


def keyframes_to_dicts(keyframes) -> list:
    """Keyframes (of either package: the dataclasses have the same fields)
    as plain dicts of numpy arrays and Python scalars."""
    return [{f.name: getattr(kf, f.name) for f in dataclasses.fields(kf)} for kf in keyframes]


def keyframes_from_dicts(dicts) -> list:
    """The port's ``Keyframe`` list from ``keyframes_to_dicts`` output."""
    from fast_limo_tpu_torch.models.slam import Keyframe

    return [Keyframe(**{k: np.array(v) if isinstance(v, np.ndarray) else v for k, v in d.items()})
            for d in dicts]
