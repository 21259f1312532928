#!/usr/bin/env python3
"""Where K6's time goes: the phase split of the whole-loop update kernel
(fast_limo_tpu_torch/csrc/update_loop.cu) on one NVIDIA GPU.

The script copies a tree's kernel sources into
build/k6_phases/<tag>/csrc, inserts a %globaltimer stamp before every
``// ---- <phase> ----`` section comment of the kernel and of the
iteration body it includes (iter_body.cuh, gain.cuh; thread 0 of block 0
stamps after a barrier, so the time between two stamps is the time block
0 — for a cluster kernel, rank 0, which waits for the others at each
phase's cluster barrier — spent in that phase).  Where the body runs on a
team of warps beside a guard warp (a header that uses FlTeam), the body's
stamps meet at the team's barrier, and every ``// ==== <phase> ====``
comment of the guard warp's code gets a stamp of its own, taken by the
guard warp's lane 0 (``==== join ====`` closes them).  The body's
critical path is then thread 0's time from the body's first stamp to the
end of the body, the join's wait for the guard warp included.  The copy
is built beside the tree's plain library, a few scans of the bench
corridor at presets.kitti_like_cfg are replayed through the tree's own
Localizer, K6's arguments are captured on a steady scan and K6 is
launched on them ``--reps`` times through the tree's wrapper.  It prints,
per launch: the plain and the instrumented kernel's device time
(torch.profiler), the stamped time of each phase, the guard warp's
phases, and the body's critical path.  The stamps add one barrier a
phase, so the instrumented kernel runs a little longer than the plain
one; shares are of the stamped total.  It also times K4 (csrc/hstats.cu)
and one ``H.T @ H`` on a 10112-point statistics pack, device time, for
the cluster-size choice.

Usage: python3 k6_phases.py [--tree DIR] [--cluster C] [--reps N]
  --tree     repository root whose fast_limo_tpu_torch is measured (default:
             this one), e.g. a `git archive` of an older commit
  --cluster  build the copy with the kernels' cluster-size constants
             (FL_UL_CLUSTER, FL_HS_CLUSTER) set to C; the plain library
             keeps the tree's own
Needs a CUDA device and nvcc; prints one JSON line last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

_STAMPS = r"""
// ---- %globaltimer phase stamps (inserted by k6_phases.py) ----
#define FL_PH_MAX 32
__device__ unsigned long long fl_ph_ns[FL_PH_MAX];
__device__ unsigned long long fl_ph_last;
__device__ int fl_ph_cur = -1;
__device__ __forceinline__ unsigned long long fl_ph_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define FL_PH_STAMP(k)                                                    \
  if (threadIdx.x == 0 && blockIdx.x == 0) {                              \
    unsigned long long t_ = fl_ph_now();                                  \
    if (fl_ph_cur >= 0) fl_ph_ns[fl_ph_cur] += t_ - fl_ph_last;           \
    fl_ph_last = t_;                                                      \
    fl_ph_cur = (k);                                                      \
  }
#define FL_PH(k)                                                          \
  do {                                                                    \
    __syncthreads();                                                      \
    FL_PH_STAMP(k)                                                        \
  } while (0)
// a stamp of the body's team (the FlTeam `team` in scope)
#define FL_PH_TEAM(k)                                                     \
  do {                                                                    \
    fl_sync(team);                                                        \
    FL_PH_STAMP(k)                                                        \
  } while (0)
// a stamp of the guard warp (the block's last), by its lane 0
#define FL_PG_MAX 8
__device__ unsigned long long fl_pg_ns[FL_PG_MAX];
__device__ unsigned long long fl_pg_last;
__device__ int fl_pg_cur = -1;
#define FL_PG(k)                                                          \
  do {                                                                    \
    __syncwarp();                                                         \
    if (threadIdx.x == blockDim.x - 32 && blockIdx.x == 0) {              \
      unsigned long long t_ = fl_ph_now();                                \
      if (fl_pg_cur >= 0) fl_pg_ns[fl_pg_cur] += t_ - fl_pg_last;         \
      fl_pg_last = t_;                                                    \
      fl_pg_cur = (k);                                                    \
    }                                                                     \
  } while (0)
extern "C" int fl_ph_read(unsigned long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out, fl_ph_ns, sizeof(fl_ph_ns));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out + FL_PH_MAX, fl_pg_ns, sizeof(fl_pg_ns));
  unsigned long long z[FL_PH_MAX] = {0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(fl_ph_ns, z, sizeof(fl_ph_ns));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(fl_pg_ns, z, sizeof(fl_pg_ns));
  return (int)e;
}
"""


_SECTION = re.compile(r"(\s*)// ---- (.+?) ----\s*$")
_GUARD = re.compile(r"(\s*)// ==== (.+?) ====\s*$")


def instrument(src: str):
    """(instrumented source, phase names): the stamp macros go first; a
    stamp opens phase 0 ("setup") at the kernel's first statement, one goes
    before every section comment inside the kernel, and one closes the last
    phase before the output store ``xo[i] = ...``."""
    lines = src.splitlines()
    start = next(i for i, ln in enumerate(lines) if re.match(r"\s*fl_update_loop_kernel\(", ln))
    body = next(i for i in range(start, len(lines)) if lines[i].rstrip().endswith("{"))
    end = next(i for i in range(body, len(lines)) if re.search(r"\bxo\[i\] = ", lines[i]))
    names, out = ["setup"], [_STAMPS]
    for i, ln in enumerate(lines):
        m = _SECTION.match(ln)
        if body < i < end and m:
            names.append(m.group(2))
            out.append(f"{m.group(1)}FL_PH({len(names) - 1});")
        if i == end:
            out.append(re.match(r"\s*", ln).group(0) + "FL_PH(-1);")
        out.append(ln)
        if i == body:
            out.append("  FL_PH(0);")
    return "\n".join(out) + "\n", names


def instrument_header(src: str, names: list, body: list, gnames: list):
    """A stamp before every section comment of a header the kernel
    includes (the iteration body's), compiled only where the kernel's
    source defined the stamps first: the team's stamp where the header
    runs its body on a team (FlTeam), a guard-warp stamp before every
    ``==== <phase> ====`` comment.  Appends the phase names (body: their
    indices among names; gnames: the guard warp's)."""
    mark = "FL_PH_TEAM" if "FlTeam" in src else "FL_PH"
    out = []
    for ln in src.splitlines():
        m, g = _SECTION.match(ln), _GUARD.match(ln)
        if m:
            names.append(m.group(2))
            body.append(len(names) - 1)
            out += ["#ifdef FL_PH", f"{m.group(1)}{mark}({len(names) - 1});", "#endif"]
        elif g:
            k = -1 if g.group(2) == "join" else len(gnames)
            if k >= 0:
                gnames.append(g.group(2))
            out += ["#ifdef FL_PH", f"{g.group(1)}FL_PG({k});", "#endif"]
        out.append(ln)
    return "\n".join(out) + "\n"


def _device_ms(torch, fn, reps: int, prefix=None) -> float:
    """Device time per call of fn() from torch.profiler: the CUDA kernels
    whose names start with ``prefix`` (all of them if None)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
          and (prefix is None or e.key.startswith(prefix))]
    return sum(e.self_device_time_total for e in ev) / reps / 1e3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--cluster", type=int, default=0)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(2)
    from fast_limo_tpu_torch.models.localizer import Localizer
    from fast_limo_tpu_torch.ops import dispatch, hstats, update_loop
    from fast_limo_tpu_torch.utils import presets

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    plain_lib = dispatch.library()

    # the instrumented copy
    tag = f"{os.path.basename(tree)}_c{args.cluster}"
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "k6_phases", tag)
    csrc = os.path.join(root, "csrc")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(dispatch.CSRC, csrc)
    path = os.path.join(csrc, "update_loop.cu")
    with open(path) as f:
        src, names = instrument(f.read())
    with open(path, "w") as f:
        f.write(src)
    body, gnames = [], []
    for name in ("iter_body.cuh", "gain.cuh"):
        with open(os.path.join(csrc, name)) as f:
            text = instrument_header(f.read(), names, body, gnames)
        with open(os.path.join(csrc, name), "w") as f:
            f.write(text)
    if len(names) > 32 or len(gnames) > 8:
        raise RuntimeError("more phases than stamps")
    for name in ("update_loop.cu", "hstats.cu") if args.cluster else ():
        p = os.path.join(csrc, name)
        with open(p) as f:
            text, n = re.subn(r"#define (FL_UL_CLUSTER|FL_HS_CLUSTER) \d+",
                              rf"#define \1 {args.cluster}", f.read())
        if not n:
            raise RuntimeError(f"no cluster constant in {name}")
        with open(p, "w") as f:
            f.write(text)
    dispatch.CSRC, dispatch.BUILD_DIR, dispatch._lib = csrc, os.path.join(root, "lib"), None
    inst_lib = dispatch.library()
    inst_lib.fl_ph_read.argtypes = [ctypes.c_void_p]
    inst_lib.fl_ph_read.restype = ctypes.c_int

    # K6's arguments on a steady scan of the bench corridor: the last call
    # that ran in Python (where the update stage replays as a CUDA graph,
    # its capture, whose buffers hold the last replay's arguments)
    dispatch._lib = plain_lib
    cfg = presets.kitti_like_cfg()
    cap, orig = {}, update_loop._launch

    def grab(*a, **kw):
        cap["args"] = (a, kw)
        return orig(*a, **kw)

    update_loop._launch = grab
    presets.replay(Localizer(cfg, device=torch.device("cuda:0")),
                   presets.bench_sequence(n_scans=8))
    update_loop._launch = orig
    a, kw = cap["args"]

    def k6():
        return update_loop._launch(*a, **kw)

    plain_ms = _device_ms(torch, k6, args.reps, "fl_update_loop")
    dispatch._lib = inst_lib
    buf = (ctypes.c_ulonglong * 40)()
    k6()
    inst_lib.fl_ph_read(buf)
    inst_ms = _device_ms(torch, k6, args.reps, "fl_update_loop")
    inst_lib.fl_ph_read(buf)          # the profiler's reps plus its warm-up
    n_iters = int(k6()[2][0])
    ns = [buf[i] / (args.reps + 1) for i in range(len(names))]
    gns = [buf[32 + i] / (args.reps + 1) for i in range(len(gnames))]
    total = sum(ns)
    phases = {nm: {"us": round(v / 1e3, 3), "share": round(v / total, 4)}
              for nm, v in zip(names, ns)}
    guard = {nm: round(v / 1e3, 3) for nm, v in zip(gnames, gns)}
    body_us = sum(ns[i] for i in body) / 1e3
    Np = a[0].shape[0] // (5 + 3 * kw["window"].W)
    for nm, v in phases.items():
        print(f"[k6] {nm:60s} {v['us']:10.3f} us/launch  {100 * v['share']:5.1f} %")
    for nm, us in guard.items():
        print(f"[k6] guard warp: {nm:48s} {us:10.3f} us/launch")
    print(f"[k6] body critical path (thread 0, the body's first stamp to its end, all "
          f"iterations): {body_us:.3f} us/launch, {body_us / max(n_iters, 1):.3f} an iteration")
    print(f"[k6] device ms/launch: plain {plain_ms:.4f} | instrumented {inst_ms:.4f} | stamped "
          f"total {total / 1e6:.4f} (Np={Np}, n_iters {n_iters}, reps {args.reps})")

    # K4 and one H.T @ H on a 10112-point pack
    rng = np.random.default_rng(0)
    n = 10112
    pc = torch.tensor(np.float32(rng.uniform(-30, 30, (n, 3))), device="cuda")
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nd = torch.tensor(np.float32(np.c_[nrm, rng.uniform(-20, 20, n)]), device="cuda")
    keep = torch.tensor(rng.random(n) < 0.9, device="cuda")
    X = hstats.pack_inputs(pc, nd, keep)
    sc = hstats.pack_scalars(a[2])
    k4_ms = _device_ms(torch, lambda: hstats.hstats(X, sc, estimate_extrinsics=True),
                       args.reps, "fl_hstats")
    cols, _ = hstats.h_rows(tuple(X[i * n:(i + 1) * n] for i in range(8)), sc,
                            estimate_extrinsics=True)
    H = torch.stack(cols, dim=-1).contiguous()
    mm_ms = _device_ms(torch, lambda: H.T @ H, args.reps)
    print(f"[k6] K4 device ms/call {k4_ms:.4f} | H.T @ H {mm_ms:.4f} (Np={n})")
    print(smi)
    print(json.dumps({"tree": tree, "cluster": args.cluster or "tree's", "Np": Np,
                      "n_iters": n_iters, "k6_device_ms": plain_ms,
                      "k6_instrumented_ms": inst_ms, "phases": phases, "guard_us": guard,
                      "body_critical_path_us": round(body_us, 3),
                      "k4_device_ms": k4_ms, "hth_device_ms": mm_ms, "card": smi}))


if __name__ == "__main__":
    main()
