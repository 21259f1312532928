"""ctypes bindings for the port's native host runtime (``io/fastlimo_host.cpp``;
the port's copy of fast_limo_tpu/io/native.py: the KITTI parser, the filter
chain, the ring, and the int16 packer).

``get_lib`` builds the C source with ``g++ -O3`` on first use into
``build/fast_limo_tpu_torch/libfastlimo_host_<hash>.so`` (the name carries
a hash of the source, so a changed source rebuilds) and returns None where
there is no toolchain; ``parse_kitti_bin``, ``preprocess``,
``pack_scan_i16`` and ``SPSCRing`` then raise.  Each C function has a NumPy
twin (``parse_kitti_bin_numpy``, ``preprocess_numpy`` — the JAX package's
fallbacks — and ``pack_scan_i16_numpy``, bit-identical to the packer) that
the tests and ``chip_smoke.py`` hold the C path against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fastlimo_host.cpp")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "fast_limo_tpu_torch")
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib = None
_lock = threading.Lock()


def library_path() -> str:
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(_BUILD, f"libfastlimo_host_{h}.so")


def _build(out: str) -> Optional[str]:
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError):
        return None
    os.replace(tmp, out)
    return out


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib or None
        path = library_path()
        if not os.path.isfile(path):
            path = _build(path)
        if path is None:
            _lib = False
            return None
        lib = ctypes.CDLL(path)
        lib.flh_parse_kitti_bin.restype = ctypes.c_int64
        lib.flh_parse_kitti_bin.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_double]
        lib.flh_preprocess.restype = ctypes.c_int64
        lib.flh_preprocess.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.flh_ring_create.restype = ctypes.c_void_p
        lib.flh_ring_create.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
        lib.flh_ring_destroy.restype = None
        lib.flh_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.flh_ring_push.restype = ctypes.c_int
        lib.flh_ring_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.flh_ring_pop.restype = ctypes.c_int
        lib.flh_ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.flh_ring_size.restype = ctypes.c_uint64
        lib.flh_ring_size.argtypes = [ctypes.c_void_p]
        lib.flh_pack_scan_i16.restype = ctypes.c_int64
        lib.flh_pack_scan_i16.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        return lib


def _cptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def parse_kitti_bin_numpy(path: str, max_points: int = 200_000,
                          sweep_period: float = 0.1):
    """NumPy twin of ``flh_parse_kitti_bin`` (the JAX package's fallback;
    its azimuth runs in float32, the C path's in float64, so times agree
    to ~1e-8 s, not bit for bit)."""
    raw = np.fromfile(path, np.float32).reshape(-1, 4)[:max_points]
    xyz, inten = raw[:, :3].copy(), raw[:, 3].copy()
    az = np.arctan2(xyz[:, 1], xyz[:, 0])
    frm = (az + np.pi) % (2 * np.pi)
    return xyz, inten, (frm / (2 * np.pi) * sweep_period).astype(np.float32)


def preprocess_numpy(xyz, t_rel, n_out: int, *, crop_active=False,
                     crop_min=(-1, -1, -1), crop_max=(1, 1, 1),
                     dist_active=False, min_dist=0.0,
                     rate_active=False, rate_value=1,
                     fov_active=False, fov_angle=np.pi):
    """NumPy twin of ``flh_preprocess`` (the JAX package's fallback): the
    same masks, stable time sort, truncation and padding; ``n_kept`` counts
    the points that passed before truncation, as the C path does (the JAX
    fallback counts them after)."""
    xyz = np.ascontiguousarray(xyz, np.float32)
    t_rel = np.ascontiguousarray(t_rel, np.float32)
    m = np.all(np.isfinite(xyz), axis=1)
    if crop_active:
        inside = np.all((xyz >= crop_min) & (xyz <= crop_max), axis=1)
        m &= ~inside
    if dist_active:
        m &= np.linalg.norm(xyz, axis=1) > min_dist
    if rate_active:
        m &= np.arange(len(xyz)) % rate_value == 0
    if fov_active:
        m &= np.abs(np.arctan2(xyz[:, 1], xyz[:, 0])) < fov_angle
    idx = np.nonzero(m)[0]
    idx = idx[np.argsort(t_rel[idx], kind="stable")][:n_out]
    n = len(idx)
    out_xyz = np.zeros((n_out, 3), np.float32)
    out_t = np.zeros(n_out, np.float32)
    out_v = np.zeros(n_out, bool)
    out_xyz[:n] = xyz[idx]
    out_t[:n] = t_rel[idx]
    out_v[:n] = True
    return out_xyz, out_t, out_v, int(np.sum(m))


def pack_scan_i16_numpy(pts, t_raw, n_cap: int, quant: float):
    """NumPy twin of ``flh_pack_scan_i16`` — BIT-identical to the C path:
    quantization products run in DOUBLE on both sides (IEEE f64 multiply +
    rint/nearbyint under round-half-even is compiler-independent; f32
    products can land on .5 ties that resolve differently), so replay
    trajectories match between hosts with and without a g++ toolchain.
    The LSB enters as the float32 the C function receives (its ``quant``
    parameter is a float): with the float64 LSB, points on a millimetre
    grid that land exactly on a tie round to the other side (the JAX
    package's twin does that)."""
    n = min(len(pts), n_cap)
    pts, t_raw = pts[:n], t_raw[:n]
    out = np.zeros((n_cap, 4), np.int16)
    tmax = float(np.max(np.abs(t_raw))) if n else 0.0
    ts32 = np.float32(max(tmax, 1e-12) / 32767.0)
    inv_q = 1.0 / float(np.float32(quant))
    inv_ts = 1.0 / float(ts32)
    np.clip(np.rint(pts.astype(np.float64) * inv_q), -32767, 32767,
            out=out[:n, :3], casting="unsafe")
    np.clip(np.rint(t_raw.astype(np.float64) * inv_ts), -32767, 32767,
            out=out[:n, 3], casting="unsafe")
    return out, float(ts32), n


def _require_lib():
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable: building "
                           "io/fastlimo_host.cpp needs g++")
    return lib


def parse_kitti_bin(path: str, max_points: int = 200_000,
                    sweep_period: float = 0.1):
    """(xyz (n,3) f32, intensity (n,) f32, t_rel (n,) f32) from a KITTI
    .bin of float32 [x, y, z, intensity] rows: the first ``max_points``
    rows, each point's time from its azimuth (the sweep starts at the rear,
    t = (atan2(y, x) + π) / 2π · ``sweep_period``)."""
    lib = _require_lib()
    xyz = np.empty((max_points, 3), np.float32)
    inten = np.empty(max_points, np.float32)
    t = np.empty(max_points, np.float32)
    n = lib.flh_parse_kitti_bin(os.fsencode(path), _cptr(xyz), _cptr(inten), _cptr(t),
                                max_points, sweep_period)
    if n < 0:
        raise FileNotFoundError(path)
    return xyz[:n], inten[:n], t[:n]


def preprocess(xyz, t_rel, n_out: int, *, crop_active=False,
               crop_min=(-1, -1, -1), crop_max=(1, 1, 1),
               dist_active=False, min_dist=0.0,
               rate_active=False, rate_value=1,
               fov_active=False, fov_angle=np.pi):
    """The filter chain (finite, negative crop box, range, rate, FoV) and a
    stable time sort into padded arrays: (xyz (n_out,3), t (n_out,),
    valid (n_out,), n_kept), n_kept counted before truncation to n_out."""
    lib = _require_lib()
    xyz = np.ascontiguousarray(xyz, np.float32)
    t_rel = np.ascontiguousarray(t_rel, np.float32)
    if xyz.shape != (len(t_rel), 3):
        raise ValueError(f"xyz {xyz.shape} and t_rel {t_rel.shape} do not pair up")
    if rate_active and rate_value < 1:
        raise ValueError(f"rate_value must be >= 1, got {rate_value}")
    out_xyz = np.empty((n_out, 3), np.float32)
    out_t = np.empty(n_out, np.float32)
    out_v = np.empty(n_out, np.uint8)
    cmin = np.asarray(crop_min, np.float32)
    cmax = np.asarray(crop_max, np.float32)
    n = lib.flh_preprocess(
        _cptr(xyz), _cptr(t_rel), len(xyz), int(crop_active), _cptr(cmin), _cptr(cmax),
        int(dist_active), min_dist, int(rate_active), int(rate_value),
        int(fov_active), fov_angle, _cptr(out_xyz), _cptr(out_t), _cptr(out_v), n_out)
    return out_xyz, out_t, out_v.astype(bool), int(n)


def pack_scan_i16(pts, t_raw, n_cap: int, quant: float):
    """One-pass int16 scan packing (the quantized transfer's hot path).

    pts (n,3) f32 contiguous, t_raw (n,) f32 contiguous →
    (out (n_cap,4) int16 zero-padded, t_scale, n_packed)."""
    lib = _require_lib()
    pts = np.ascontiguousarray(pts, np.float32)
    t_raw = np.ascontiguousarray(t_raw, np.float32)
    if pts.shape != (len(t_raw), 3):
        raise ValueError(f"pts {pts.shape} and t_raw {t_raw.shape} do not pair up")
    out = np.empty((n_cap, 4), np.int16)
    ts = ctypes.c_float(0.0)
    n = lib.flh_pack_scan_i16(_cptr(pts), _cptr(t_raw), len(pts), quant, _cptr(out),
                              n_cap, ctypes.byref(ts))
    return out, float(ts.value), int(n)


class SPSCRing:
    """Lock-free single-producer single-consumer ring of fixed-size records."""

    def __init__(self, n_items: int, item_size: int):
        self._lib = _require_lib()
        self._item_size = item_size
        self._ptr = ctypes.c_void_p(self._lib.flh_ring_create(n_items, item_size))

    def push(self, data: bytes) -> bool:
        if len(data) != self._item_size:
            raise ValueError(f"record of {len(data)} bytes, the ring holds {self._item_size}")
        return bool(self._lib.flh_ring_push(self._ptr, data))

    def pop(self) -> Optional[bytes]:
        buf = ctypes.create_string_buffer(self._item_size)
        if self._lib.flh_ring_pop(self._ptr, buf):
            return buf.raw
        return None

    def __len__(self):
        return int(self._lib.flh_ring_size(self._ptr))

    def __del__(self):
        ptr, self._ptr = getattr(self, "_ptr", None), None
        if ptr:
            self._lib.flh_ring_destroy(ptr)
