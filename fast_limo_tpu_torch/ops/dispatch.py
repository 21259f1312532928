"""Kernel dispatch and the CUDA kernel library.

Policy: a kernel wrapper launches its hand-written CUDA kernel iff the
tensors it is given lie on a CUDA device; on CPU tensors it runs its plain
PyTorch version.  There is no switch that routes a CUDA tensor around its
kernel, and a launch failure raises.

The kernels (``fast_limo_tpu_torch/csrc/*.cu``) are compiled on first use
with ``nvcc`` for ``sm_90a`` — one ``nvcc -c`` per source, all started
together, then one link — into ONE shared library with a plain C
interface, loaded with ``ctypes``.  The library name carries a hash of the
sources and flags, so a changed source rebuilds; the build directory is
``build/fast_limo_tpu_torch/`` at the repository root.

The port's entry points run on the card unless the caller asks for the
CPU (``device="cpu"``); ``resolve_device`` refuses a CUDA device where
there is none instead of carrying on on the CPU.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "fast_limo_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-lineinfo", "-Xptxas", "-v", "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: name → argument types (pointers and the stream as c_void_p;
# scalars by value, so a launch uploads nothing)
_SIGNATURES = {
    "fl_deskew": [_P, _P],
    "fl_knn_rows": [_P] * 7 + [_I] * 9 + [_P] * 7,
    "fl_masked_topk": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "fl_masked_topk_table": [_P] * 4 + [_I] * 7 + [_P] * 4,
    "fl_fit_planes": [_P, _P, _P, _I, _I, _I, _F, _F, _F, _P, _P, _P, _P],
    "fl_fit_planes_select": [_P] * 11 + [_I] * 4 + [_F] * 3 + [_P] * 4,
    "fl_hstats": [_P, _I, _P, _I, _P, _P, _P],
    "fl_gain": [_P, _P, _P, _F, _P, _P, _P, _P],
    "fl_update_body": [_P, _P, _P, _P, _P, _F, _F, _P, _P, _P, _P, _P, _P],
    "fl_update_loop_scratch": [_I],
    "fl_update_loop": [_P, _I, _P, _P, _F, _F, _F, _I, _I, _F, _F, _F, _F, _I, _F,
                       _I, _I, _P, _P, _P, _P, _P],
    "fl_sort3": [_P] * 3 + [_I] + [_P] * 8,
    "fl_sort3_grid_table": [_I],
}

_lib = None


def on_cuda(t: torch.Tensor) -> bool:
    """The kernel runs iff the tensor lies on a CUDA device."""
    return t.is_cuda


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, refusing a CUDA device where there is none."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fast_limo_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device=\"cpu\" to run the plain versions on the CPU")
    return d


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", "") + "/bin/nvcc",
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libfastlimo_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernel library (if its hashed file is missing); returns
    its path.  Raises on any compiler failure."""
    out = library_path()
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}"
    jobs = []
    for src in (p for p in _sources() if p.endswith(".cu")):
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        text = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + text)
        if proc.returncode != 0:
            failed.append(text)
    objs = [obj for _, obj, _ in jobs]
    tmp = f"{out}.{tag}.tmp"
    if not failed:
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", tmp, *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(res.stderr)
    with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
        f.write("\n".join(log))
    for obj in objs:
        if os.path.isfile(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(t[-3000:] for t in failed))
    os.replace(tmp, out)
    return out


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


_COUNTED = {}   # "module.name" → (wrapper, its counter attributes)


def counted(fn, *more):
    """Register the kernel wrapper ``fn``, which counts its launches in
    ``fn.launches`` (and a part of them in each attribute named in
    ``more``); sets them to 0.  A module imported again registers anew."""
    names = ("launches", *more)
    for name in names:
        setattr(fn, name, 0)
    _COUNTED[f"{fn.__module__}.{fn.__qualname__}"] = (fn, names)
    return fn


def counters():
    """(wrapper, attribute) of every launch counter registered with ``counted``."""
    return [(fn, name) for fn, names in _COUNTED.values() for name in names]


def ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def flag(active):
    """The device pointer of an optional active flag (a () bool CUDA
    tensor, read by the kernel), or NULL for "always run"."""
    if active is None:
        return None
    require(active, "active", dtype=torch.bool, shape=())
    return ptr(active)


def stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")


def require(t: torch.Tensor, name: str, dtype=torch.float32, shape=None):
    """Device, dtype, shape and contiguity checks of a kernel argument."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t
