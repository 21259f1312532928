"""ScanContext place-recognition descriptors (Kim & Kim, IROS 2018); port
of fast_limo_tpu/models/scancontext.py.

Descriptor: R rings × S sectors; cell = max z of points in the cell (one
scatter-max).  Ring-key: per-ring occupancy ratio (rotation invariant) for
fast candidate retrieval; full distance = 1 − max over sector shifts of the
mean column-wise cosine similarity, all S shifts evaluated at once.
"""

from __future__ import annotations

import math

import torch

N_RING = 20
N_SECTOR = 60
MAX_RADIUS = 80.0


def descriptor(points, valid, *, n_ring: int = N_RING, n_sector: int = N_SECTOR,
               max_radius: float = MAX_RADIUS, height_shift: float = 2.0):
    """(R,S) scan-context of a body-frame scan; empty cells = 0.

    Heights are shifted by ``height_shift`` (≈ sensor height above ground)
    so ground returns contribute positive occupancy.  The geometry knobs
    live in ``Config.sc``."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    r = torch.sqrt(x * x + y * y)
    theta = torch.atan2(y, x)  # [-pi, pi]
    ring = torch.clamp((r / max_radius * n_ring).to(torch.int32), 0, n_ring - 1)
    sector = torch.clamp(((theta + math.pi) / (2 * math.pi) * n_sector).to(torch.int32),
                         0, n_sector - 1)
    ok = valid & (r < max_radius) & (r > 1e-3)
    cell = torch.where(ok, ring * n_sector + sector,
                       torch.full_like(ring, n_ring * n_sector)).to(torch.int64)
    ninf = torch.full_like(z, float("-inf"))
    h = torch.where(ok, z + height_shift, ninf)
    flat = torch.full((n_ring * n_sector + 1,), float("-inf"), dtype=points.dtype,
                      device=points.device)
    flat = flat.scatter_reduce(0, cell, h, reduce="amax", include_self=True)
    desc = flat[:-1].reshape(n_ring, n_sector)
    return torch.where(torch.isfinite(desc), desc, torch.zeros_like(desc))


def ring_key(desc):
    """(R,) rotation-invariant key: per-ring occupancy ratio."""
    return torch.mean((desc != 0.0).to(desc.dtype), dim=-1)


def _colwise_cos(d1, d2):
    """Mean column-wise cosine similarity of (…,R,S) descriptors.

    Columns where only ONE side is occupied score 0 and still count in the
    mean — averaging over the overlap alone lets a wrong shift with two
    accidentally-matching columns score 1.0 (sparse scenes alias badly)."""
    num = torch.sum(d1 * d2, dim=-2)
    n1 = torch.linalg.norm(d1, dim=-2)
    n2 = torch.linalg.norm(d2, dim=-2)
    both = (n1 > 1e-9) & (n2 > 1e-9)
    either = (n1 > 1e-9) | (n2 > 1e-9)
    sim = torch.where(both, num / torch.where(both, n1 * n2, torch.ones_like(n1)),
                      torch.zeros_like(num))
    n_cols = torch.clamp(torch.sum(either.to(d1.dtype), dim=-1), min=1.0)
    return torch.sum(sim, dim=-1) / n_cols


def distance(d1, d2):
    """ScanContext distance: min over all sector shifts of 1 − colwise cos.
    ``d2`` may carry leading batch axes (a keyframe database).  Returns
    (dist (…), best_shift (…) int64); ties to the lowest shift."""
    S = d1.shape[1]
    cols = torch.arange(S, device=d1.device)
    # rolled[..., s, :, j] = d2[..., :, (j − s) mod S]  (a roll by s sectors)
    idx = (cols[None, :] - cols[:, None]) % S                     # (S shifts, S cols)
    rolled = d2[..., :, idx].movedim(-2, -3)                      # (…, S, R, S)
    sims = _colwise_cos(d1, rolled)                               # (…, S)
    best = torch.argmax(sims, dim=-1)
    return 1.0 - torch.gather(sims, -1, best[..., None])[..., 0], best


def retrieve(query_key, keys, key_valid):
    """Ring-key L1 distances to all stored keyframes ((K,) with inf at invalid)."""
    d = torch.sum(torch.abs(keys - query_key[None, :]), dim=-1)
    return torch.where(key_valid, d, torch.full_like(d, float("inf")))


def shift_to_yaw(shift, n_sector: int = N_SECTOR):
    """Sector shift → approximate relative yaw (rad)."""
    half = n_sector // 2
    signed = shift - n_sector if shift > half else shift
    return -2.0 * math.pi * signed / n_sector
