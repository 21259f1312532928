"""Per-packet LiDAR streaming (port of fast_limo_tpu/io/packets.py; the
reference's headline driver mode).

fast_LIMO is "developed with the purpose to be used with a modified LiDAR
driver capable of sending each scan packet as soon as it is ready, instead
of waiting for the LiDAR to complete a full rotation"
(reference README.md:247) — its `updatePointCloud` simply runs more often
on partial clouds.  The engine inherits the same property: every
dispatch is a fixed-shape padded batch with a validity mask, so a packet
is just a small scan — feed it through `update_pointcloud` with the
SWEEP's header stamp and the packet's per-point time subset, and deskew /
matching / insertion proceed per packet at packet rate (lower latency,
fresher map).  Loop closure composes too: `SLAM` buffers the
packet outputs of one sweep (they share the header stamp) and stitches
them into a sweep-complete keyframe cloud, so ScanContext retrieval, ICP
verification, GPS factors and the pose graph all run in packet mode
(`tests/test_torch_packets.py`).

`PacketSlicer` reproduces such a driver from full sweeps (replay/testing):
it orders points by their timestamp and cuts the sweep into contiguous
time windows.
"""

from __future__ import annotations

import numpy as np


class PacketSlicer:
    """Cut full sweeps into time-contiguous packets.

    ``n_packets`` windows per sweep.  Works for any sensor time convention
    — slicing is on the RAW per-point time field, whose order matches
    absolute firing time for every supported convention except
    ``end_of_sweep`` (negative-relative), which is handled by flipping the
    sort direction.
    """

    def __init__(self, n_packets: int = 4, end_of_sweep: bool = False):
        if n_packets < 1:
            raise ValueError(f"n_packets must be >= 1, got {n_packets}")
        self.n_packets = n_packets
        self.end_of_sweep = end_of_sweep

    def packets(self, points, t_raw, stamp: float):
        """Yield ``(points_i, t_raw_i, stamp)`` per packet, in firing order.

        The header stamp is the SWEEP's — exactly what the reference's
        per-packet driver publishes (the sweep reference frame does not
        change mid-rotation); the engine keys deskew on the per-point
        times it already receives.
        """
        points = np.asarray(points)
        t_raw = np.asarray(t_raw)
        order = np.argsort(-t_raw if self.end_of_sweep else t_raw,
                           kind="stable")
        bounds = np.linspace(0, len(order), self.n_packets + 1).astype(int)
        for i in range(self.n_packets):
            sel = order[bounds[i]:bounds[i + 1]]
            if len(sel) == 0:
                continue
            yield points[sel], t_raw[sel], float(stamp)
