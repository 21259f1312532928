"""Checkpoint / resume of the full SLAM state (port of
fast_limo_tpu/utils/checkpoint.py, same on-disk format).

The whole ``LIOState`` (filter mean and covariance, voxel-hash map,
carries) serializes to one compressed ``.npz``: a ``__meta__`` JSON
(sorted leaf paths and the caller's ``extra``) plus one array per leaf,
keyed by its NamedTuple field path joined with ``__`` (``x__rot``,
``P``, ``map__table``).  The leaf paths, dtypes and shapes are the JAX
package's, so a checkpoint written by either package loads in the other.
``save_map_pcd`` exports the occupied map points as ASCII PCD.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch


def _is_tree(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _flatten_with_paths(tree, prefix: str = "") -> dict:
    """{"x/pos": leaf, ..., "map/table": leaf, ...} in field order."""
    out = {}
    for name in tree._fields:
        node, key = getattr(tree, name), prefix + name
        if _is_tree(node):
            out.update(_flatten_with_paths(node, key + "/"))
        else:
            out[key] = node
    return out


def _rebuild(template, fn, prefix: str = ""):
    """``template`` with every leaf replaced by ``fn(path, leaf)``."""
    return type(template)(*[
        _rebuild(node, fn, prefix + name + "/") if _is_tree(node) else fn(prefix + name, node)
        for name, node in zip(template._fields, template)])


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _np_dtype(leaf) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def save_state(path: str, state, extra: Optional[dict] = None) -> None:
    """Serialize a LIOState (or any NamedTuple tree of tensors) to ``path`` (.npz)."""
    arrays = {k: _to_numpy(v) for k, v in _flatten_with_paths(state).items()}
    meta = {"keys": sorted(arrays), "extra": extra or {}}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, __meta__=json.dumps(meta),
                        **{k.replace("/", "__"): v for k, v in arrays.items()})


def load_host_arrays(path: str, template):
    """Restore into the structure of ``template`` as numpy arrays (each
    leaf cast to the template leaf's dtype; shapes must agree)."""
    data = np.load(path, allow_pickle=False)
    arrays = {k.replace("__", "/"): data[k] for k in data.files if k != "__meta__"}

    def leaf(key, want):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        got = arrays[key]
        if tuple(got.shape) != tuple(want.shape):
            raise ValueError(f"shape mismatch for {key}: {got.shape} vs {tuple(want.shape)}")
        return np.asarray(got, _np_dtype(want))

    return _rebuild(template, leaf)


def load_state(path: str, template):
    """Restore into the structure of ``template``; every leaf lands on the
    template leaf's device with its dtype."""
    host = load_host_arrays(path, template)
    devices = {k: v.device for k, v in _flatten_with_paths(template).items()}
    return _rebuild(host, lambda key, a: torch.tensor(a, device=devices[key]))


def load_extra(path: str) -> dict:
    data = np.load(path, allow_pickle=False)
    return json.loads(str(data["__meta__"])).get("extra", {})


def map_points(map_state) -> np.ndarray:
    """The occupied (n,3) world points of a VoxelHashMap, entry by entry."""
    counts = _to_numpy(map_state.counts)
    pts = _to_numpy(map_state.points)
    occ = np.nonzero(counts > 0)[0]
    out = [pts[s, :counts[s]] for s in occ]
    return np.concatenate(out) if out else np.zeros((0, 3), np.float32)


def save_map_pcd(path: str, map_state) -> int:
    """ASCII PCD export of the occupied map points; returns their count."""
    pts = map_points(map_state)
    with open(path, "w") as f:
        f.write("# .PCD v0.7 - Point Cloud Data file format\n"
                "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
                f"COUNT 1 1 1\nWIDTH {len(pts)}\nHEIGHT 1\n"
                "VIEWPOINT 0 0 0 1 0 0 0\n"
                f"POINTS {len(pts)}\nDATA ascii\n")
        for p in pts:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
    return len(pts)


def load_map_pcd(path: str) -> np.ndarray:
    pts = []
    with open(path) as f:
        in_data = False
        for line in f:
            if in_data:
                xs = line.split()
                if len(xs) >= 3:
                    pts.append([float(xs[0]), float(xs[1]), float(xs[2])])
            elif line.startswith("DATA"):
                if "ascii" not in line:
                    raise ValueError("only ascii PCD supported")
                in_data = True
    return np.asarray(pts, np.float32).reshape(-1, 3)
