"""ctypes bindings for the port's native host runtime (``io/fastlimo_host.cpp``;
the port's copy of fast_limo_tpu/io/native.py's packer and ring).

``get_lib`` builds the C source with ``g++ -O3`` on first use into
``build/fast_limo_tpu_torch/libfastlimo_host_<hash>.so`` (the name carries
a hash of the source, so a changed source rebuilds) and returns None where
there is no toolchain; ``pack_scan_i16`` and ``SPSCRing`` then raise.
``pack_scan_i16_numpy`` is the packer's plain version, bit-identical to it:
the tests and ``chip_smoke.py`` hold the C packer against it.
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
