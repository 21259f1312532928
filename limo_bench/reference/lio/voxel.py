"""Fixed-shape voxel-grid centroid downsampling (port of
fast_limo_tpu/ops/voxel.py; the reference's PCL VoxelGrid,
Localizer.cpp:313-321).

The voxel id is packed into one 31-bit int32 key (10 bits per axis,
invalids last), grouped by ONE key/index sort (K9, ``ops/sort``), and the
centroids accumulate as one segmented sum of ``[x, y, z, 1]`` rows in
sorted order.  The voxel sets equal the JAX package's bit for bit: voxel
coordinates come from a true float32
division ``floor(p / leaf)`` (``floor_div``), never from a multiplication
by the reciprocal.
"""

from __future__ import annotations

import torch

from reference.lio import sort


def floor_div(x, leaf: float):
    """``floor(x / f32(leaf))`` by IEEE float32 division.  The divisor is a
    tensor on x's device: PyTorch turns division by a host scalar into a
    multiplication by its reciprocal on CUDA, which can move points across
    voxel boundaries."""
    return torch.floor(x / torch.full((), leaf, dtype=x.dtype, device=x.device))


def pack_key(vc):
    """10-bit-per-axis packed voxel key of int coords (…,3) → int64."""
    return (((vc[..., 0] & 0x3FF) << 20) | ((vc[..., 1] & 0x3FF) << 10)
            | (vc[..., 2] & 0x3FF))


def voxel_downsample(pts, valid, leaf: float):
    """pts (N,3), valid (N,) → (out_pts (N,3), out_valid (N,)): one centroid
    per occupied voxel, compacted to the front in voxel-key order."""
    N = pts.shape[0]
    vc = floor_div(pts, leaf).to(torch.int64)
    key = torch.where(valid, pack_key(vc), torch.full_like(vc[:, 0], 0x7FFFFFFF))
    key_s, order = sort.sort_key_val(
        key.to(torch.int32), torch.arange(N, dtype=torch.int32, device=pts.device))

    fused = torch.cat([pts, valid.to(pts.dtype)[:, None]], dim=1)[order.long()]
    valid_s = fused[:, 3] > 0
    pts_s = torch.where(valid_s[:, None], fused[:, :3], torch.zeros_like(fused[:, :3]))
    new_seg = torch.cat([torch.ones(1, dtype=torch.bool, device=pts.device),
                         key_s[1:] != key_s[:-1]]) & valid_s
    seg_id = torch.cumsum(new_seg.to(torch.int64), dim=0) - 1
    seg_id = torch.where(valid_s, seg_id, torch.full_like(seg_id, N - 1))
    acc = torch.cat([pts_s, valid_s[:, None].to(pts.dtype)], dim=1)
    # segment sums in sorted order, one sequential sum per segment: the
    # same order on CPU and CUDA (no float atomics), as the JAX scatter-add
    lengths = torch.zeros(N, dtype=torch.int64, device=pts.device).index_add_(
        0, seg_id, torch.ones_like(seg_id))
    sums = torch.segment_reduce(acc, "sum", lengths=lengths, axis=0, unsafe=True)

    n_seg = torch.sum(new_seg)
    out_valid = torch.arange(N, device=pts.device) < n_seg
    centroids = sums[:, :3] / torch.clamp(sums[:, 3], min=1.0)[:, None]
    return torch.where(out_valid[:, None], centroids, torch.zeros_like(centroids)), out_valid
