"""LIOState ⇄ numpy dict: the state interchange between the two packages.

The dict holds the ``LIOState`` leaves as numpy arrays — ``x`` as its 26
flat values (state.as_vector order), ``P``, ``map.table``, ``map.ptable``,
``map.num_points``, ``map.last_time`` and the carry vectors — under the JAX
package's field names.  The map layout is identical
(``mapper.layout_version``), so the same arrays mean the same map: with
this, both packages compute the same step from the same state.  A caller
holding a JAX state builds the dict with ``np.asarray`` on its own side.
"""

from __future__ import annotations

import numpy as np
import torch

from fast_limo_tpu_torch.models import mapper
from fast_limo_tpu_torch.models import pipeline as pl
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
