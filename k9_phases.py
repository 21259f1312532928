#!/usr/bin/env python3
"""Where the time of K9's grid kernel goes, and K9 of several trees on the
same inputs, on one NVIDIA GPU.

Two measurements, in this order:

1. ``--trees DIR [DIR ...]``: each tree in turn, in a process of its own
   that imports DIR's fast_limo_tpu_torch (and builds its kernel library),
   times one ``sort.sort3`` call on every row below: device ms from
   torch.profiler (5 calls after a warm-up, the kernels named fl_sort3*) and
   wrapper ms from CUDA events (median of 5), each result held bit-equal to
   that tree's ``sort3_plain``; and ``torch.sort``'s one call on the same
   inputs (the voxel form: the int32 key with its indices; the insert form:
   the stable sort of the int64 key (k1 << 30) | k2).  Give an older tree
   and this one as ``--trees old . . old`` to compare two kernels in one
   call, each measured twice.
2. The phase split of this tree's grid kernel: csrc/sort3.cu is copied
   into build/k9_phases/<hash>/ and a %globaltimer stamp is inserted there
   before each phase (the library's source carries no hooks); the copy is
   built alone and every row is sorted through its grid route (held
   bit-equal to the plain version).  Thread 0 of every block adds the time
   between the stamps, each taken after a block barrier, so the stamped
   kernel runs a little longer than the library's.  Printed per row, mean
   over the blocks and over 5 launches: the stamped time (the blocks' phase
   sums), then each phase — the input read with the block's digit counts,
   their adds into the table, the digit bases and each pass's set-up, the
   grid barriers, the wait for a tile's loads, the warps' ballot ranks, the
   tile's digit counts (published) and their scan, the shared-memory
   reorder, the look-back, the digit-run writes — in µs a call and a pass.
3. ``--variant NAME=SPEC`` (repeatable): the same copy with other tile
   constants, SPEC a space-separated list of ``FL_SORTG_THREADS=n``,
   ``FL_SORTG_ITEMS=n``, ``FL_SORTG_LOOK=n`` (each rewrites that
   ``#define``), ``PER_SM=k`` (k blocks an SM where they fit: the launch
   bounds and the resident grid rewritten) and ``PREFETCH=0`` (the next
   tile's loads issued after this tile's writes, not while it is ranked),
   e.g. ``t256="FL_SORTG_THREADS=256 FL_SORTG_ITEMS=8 PER_SM=2"``; its grid
   kernel timed through ctypes on every row (device ms as above, bit-equal
   to the plain version) and, without ``--no-phases``, split into phases
   like the library's.

Rows: phase 12's captured sorts (the voxel and insert sorts of a 128-beam
scan and the 262 144-point map rebuild, from build/k9_wide.npz, which a
chip_smoke.py run in this checkout writes) where that file exists, and
chip_smoke.py's seeded forms: voxel and insert at 2^18, insert at 2^17 + 1,
2^20 and 2^22.

Usage: python3 k9_phases.py [--trees DIR ...] [--no-phases] [--variant NAME=SPEC ...]
Needs a CUDA device and nvcc; prints one JSON line last.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "build", "k9_phases")
PHASES = ("input read and counts", "count adds", "digit bases and pass set-up", "grid barriers",
          "tile loads", "ballot ranks", "tile counts and scan", "shared-memory reorder",
          "look-back", "digit-run writes")


def _rows():
    """(name, form, (3, N) int32) of every row."""
    import torch

    import chip_smoke

    rows = []
    if os.path.isfile(chip_smoke.K9_WIDE_INPUTS):
        with np.load(chip_smoke.K9_WIDE_INPUTS) as f:
            rows += [(f"phase 12 {name}", "voxel" if name == "voxel" else "insert", f[name])
                     for name in ("voxel", "insert", "rebuild")]
    cpu = torch.device("cpu")
    for form, N in (("voxel", 1 << 18), ("insert", 1 << 18), ("insert", (1 << 17) + 1),
                    ("insert", 1 << 20), ("insert", 1 << 22)):
        ops = chip_smoke._k9_seeded(torch, cpu, form, N, 12 + N)
        rows.append((f"seeded {form} N={N}", form, torch.stack(ops).numpy()))
    return rows


def _passes(ops) -> int:
    """The passes the kernels' skip rule takes on (k1, k2, v)."""
    k1, k2, v = ops
    u = [x.view(np.uint32) for x in ops]
    lo = [int(np.bitwise_and.reduce(x)) for x in u]
    hi = [int(np.bitwise_or.reduce(x)) for x in u]
    bad_v = bool((v[:-1] > v[1:]).any())
    bad_kv = bool(((k2[:-1] > k2[1:]) | ((k2[:-1] == k2[1:]) & (v[:-1] > v[1:]))).any())
    taken = 0
    for p in range(12):
        op, shift = 2 - p // 4, 8 * (p % 4)
        constant = ((lo[op] ^ hi[op]) >> shift) & 0xFF == 0
        in_order = (op == 2 and not bad_v) or (op >= 1 and not bad_kv)
        taken += not (constant or in_order)
    return taken


def _library_calls(torch, k1, k2, form):
    packed = (k1.long() << 30) | k2.long()
    return (lambda: torch.sort(k1, stable=True)) if form == "voxel" else \
        (lambda: torch.sort(packed, stable=True))


def _worker(tree: str, rows_path: str) -> None:
    """One tree's sort3 on every row: one JSON line a row."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import chip_smoke
    from fast_limo_tpu_torch.ops import sort

    dev = torch.device("cuda:0")
    with np.load(rows_path, allow_pickle=False) as f:
        names, forms = list(f["names"]), list(f["forms"])
        arrays = [f[f"row{i}"] for i in range(len(names))]
    for name, form, ops in zip(names, forms, arrays):
        k1, k2, v = (torch.tensor(x, device=dev) for x in ops)
        g0 = sort.sort3.grid_launches
        got = sort.sort3(k1, k2, v)
        grid = sort.sort3.grid_launches > g0
        equal = all(torch.equal(a, b) for a, b in zip(got, sort.sort3_plain(k1, k2, v)))
        lib = _library_calls(torch, k1, k2, form)
        call = lambda: sort.sort3(k1, k2, v)   # noqa: E731
        print(json.dumps({
            "tree": os.path.abspath(tree), "row": str(name), "N": int(k1.shape[0]),
            "grid": bool(grid), "equal": equal,
            "device_ms": chip_smoke._device_ms(call, "fl_sort3"),
            "wrapper_ms": chip_smoke._time_ms(call), "events_ms": _events_ms(torch, call),
            "torch_sort_device_ms": chip_smoke._device_ms(lib),
            "torch_sort_ms": chip_smoke._time_ms(lib)}), flush=True)


def _define(src: str, name: str) -> int:
    return int(re.search(rf"#define {name} \(?(\d+)", src).group(1))


_STAMPS = r"""
// ---- %globaltimer phase stamps (inserted by k9_phases.py) ----
#define FL_SG_PHASES 10
#define FL_SG_MAXG 1024
__device__ unsigned long long fl_sortg_ns[FL_SG_MAXG][FL_SG_PHASES];
#define FL_SG_MARK(k)                                                            \
  do {                                                                           \
    __syncthreads();                                                             \
    if (tid == 0) {                                                              \
      unsigned long long t_;                                                     \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                     \
      if (ph_cur >= 0) ph_ns[ph_cur] += t_ - ph_last;                            \
      ph_last = t_;                                                              \
      ph_cur = (k);                                                              \
    }                                                                            \
  } while (0)
"""

_READ = """
// the phase times of the last stamped launch, [blocks][FL_SG_PHASES] ns
extern "C" int fl_sort3_grid_stamps(unsigned long long* host, int blocks) {
  return (int)cudaMemcpyFromSymbol(host, fl_sortg_ns,
                                   sizeof(unsigned long long) * FL_SG_PHASES * blocks);
}
"""


def _line(lines, pattern: str, start: int = 0) -> int:
    """The index of the one line at or after ``start`` that matches."""
    hits = [i for i in range(start, len(lines)) if re.search(pattern, lines[i])]
    if len(hits) != 1:
        raise RuntimeError(f"sort3.cu: {len(hits)} lines match {pattern!r}, not one")
    return hits[0]


def instrument(src: str) -> str:
    """sort3.cu with a stamp before each of PHASES in the grid kernel."""
    lines = src.splitlines()
    k0 = _line(lines, r"^fl_sort3_grid_kernel\(")
    end = next(i for i in range(k0, len(lines)) if lines[i] == "}")
    at = {}   # line index → the statements that go before it

    def before(i, text):
        at.setdefault(i, []).append(text)

    before(_line(lines, r"// ---- set the table up", k0),
           "  unsigned long long ph_ns[FL_SG_PHASES] = {}, ph_last = 0;\n  int ph_cur = -1;\n"
           "  FL_SG_MARK(0);")
    for note, after in (("the table is set up", 1), ("every count and word is in", 2),
                        ("every element has landed", 2)):
        i = _line(lines, rf"grid\.sync\(\);\s+// {note}", k0)
        lines[i] = lines[i].replace("grid.sync();", f"FL_SG_MARK(3); grid.sync(); "
                                                    f"FL_SG_MARK({after});")
    for pattern, k in ((r"const int cnt = \(int\)min\(", 4),
                       (r"// stable rank of each element among its warp", 5),
                       (r"// the tile's count of digit tid", 6),
                       (r"// reorder the tile by digit in shared memory", 7),
                       (r"// look back over the lower tiles' counts", 8),
                       (r"// thread i writes element i of the reordered tile", 9)):
        before(_line(lines, pattern, k0), f"      FL_SG_MARK({k});")
    before(end, "  FL_SG_MARK(2);\n  if (tid == 0 && b < FL_SG_MAXG)\n"
                "    for (int k = 0; k < FL_SG_PHASES; ++k) fl_sortg_ns[b][k] = ph_ns[k];")
    before(_line(lines, r"^static_assert\(FL_SORTG_THREADS"), _STAMPS)
    out = []
    for i, ln in enumerate(lines):
        out += at.get(i, [])
        out.append(ln)
    return "\n".join(out) + "\n" + _READ


def _variant(src: str, spec) -> str:
    """sort3.cu with the rewrites of a --variant SPEC."""
    for item in spec:
        name, _, value = item.partition("=")
        if name in ("FL_SORTG_THREADS", "FL_SORTG_ITEMS", "FL_SORTG_LOOK"):
            src, n = re.subn(rf"#define {name} \d+", f"#define {name} {int(value)}", src)
        elif name == "PER_SM":
            k = int(value)
            src, n = re.subn(r"__launch_bounds__\(FL_SORTG_THREADS, 1\)",
                             f"__launch_bounds__(FL_SORTG_THREADS, {k})", src)
            call = "fl_grid_blocks(fl_sort3_grid_kernel, FL_SORTG_THREADS, FL_SORTG_DYN, &blocks)"
            per = ("int per_sm = 0;\n    r = " + call + ";\n"
                   "    if (r == cudaSuccess) r = cudaOccupancyMaxActiveBlocksPerMultiprocessor("
                   "&per_sm, fl_sort3_grid_kernel, FL_SORTG_THREADS, FL_SORTG_DYN);\n"
                   f"    blocks *= per_sm < {k} ? per_sm : {k};\n    return r;")
            src = src.replace("return " + call + ";", per)
            n = n if per in src else 0
        elif name == "PREFETCH" and value == "0":
            load = re.search(r"\n( *if \(t \+ G < ntiles\)[^\n]*\n[^\n]*nx\);)", src)
            n = 0
            if load:
                src = src.replace(load.group(0), "")
                src, n = re.subn(r"\n( *)__syncthreads\(\);   // the next tile reuses",
                                 "\n" + load.group(1) + r"\n\1__syncthreads();   // the next tile reuses",
                                 src)
        else:
            raise ValueError(f"unknown variant item {item!r}")
        if n != 1:
            raise RuntimeError(f"sort3.cu: the rewrite {item!r} matched {n} places, not one")
    return src


def _variant_library(spec=(), stamps=True):
    """This tree's sort3.cu, rewritten by ``spec`` (and stamped), copied into
    build/k9_phases/<hash>/ and built alone → (ctypes handle, elements a
    tile)."""
    from fast_limo_tpu_torch.ops import dispatch

    with open(os.path.join(dispatch.CSRC, "sort3.cu")) as f:
        text = _variant(f.read(), spec)
    if stamps:
        text = instrument(text)
    h = hashlib.sha256(text.encode())
    with open(os.path.join(dispatch.CSRC, "common.cuh"), "rb") as f:
        h.update(f.read())
    h.update(" ".join(dispatch.NVCC_FLAGS).encode())
    where = os.path.join(OUT, h.hexdigest()[:16])
    lib = os.path.join(where, "libk9.so")
    if not os.path.isfile(lib):
        os.makedirs(where, exist_ok=True)
        src = os.path.join(where, "sort3.cu")
        with open(src, "w") as f:
            f.write(text)
        cmd = [dispatch._nvcc(), *dispatch.NVCC_FLAGS, "-I", dispatch.CSRC, "-shared",
               "-o", lib, src]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + res.stdout[-3000:] + res.stderr[-3000:])
        out = res.stdout + res.stderr
        at = out.find("fl_sort3_grid_kernel")
        print(f"[k9] built {' '.join(spec) or 'as the library'}{' stamped' if stamps else ''}: "
              + " | ".join(x.strip() for x in out[at:].splitlines()[1:4]
                           if "ptxas" in x or "bytes" in x), flush=True)
    handle = ctypes.CDLL(lib)
    P, I = ctypes.c_void_p, ctypes.c_int
    handle.fl_sort3.argtypes = [P] * 3 + [I] + [P] * 7 + [I, P]
    handle.fl_sort3_grid_table.argtypes = [I]
    names = ["fl_sort3", "fl_sort3_grid_blocks", "fl_sort3_grid_table"]
    if stamps:
        handle.fl_sort3_grid_stamps.argtypes = [P, I]
        names.append("fl_sort3_grid_stamps")
    for fn in names:
        getattr(handle, fn).restype = I
    return handle, _define(text, "FL_SORTG_THREADS") * _define(text, "FL_SORTG_ITEMS")


def _launcher(torch, lib, tile, ops, dev):
    """(a call of lib's grid route on ops, its outputs, launched blocks)."""
    G = lib.fl_sort3_grid_blocks()
    if G <= 0:
        raise RuntimeError(f"the grid kernel cannot be resident: error {-G}")
    N = ops.shape[1]
    k1, k2, v = (torch.tensor(x, device=dev) for x in ops)
    res = torch.empty((3, N), dtype=torch.int32, device=dev)
    buf = torch.empty((3, N), dtype=torch.int32, device=dev)
    table = torch.empty(lib.fl_sort3_grid_table(N), dtype=torch.int32, device=dev)
    ptr = [ctypes.c_void_p(t.data_ptr()) for t in (k1, k2, v, *res, *buf, table)]

    def call():
        err = lib.fl_sort3(*ptr[:3], N, *ptr[3:], G,
                           ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"the grid kernel failed to launch: error {err}")

    keep = (k1, k2, v, buf, table)
    return call, res, keep, min(G, -(-N // tile))


def _events_ms(torch, call, n: int = 20) -> float:
    """Mean CUDA-event time of one call over n back-to-back calls (after a
    warm-up): the host enqueues faster than the card sorts, so the gaps
    between launches do not count."""
    call()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        call()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def _check(torch, sort, res, keep, name):
    if not all(torch.equal(a, b) for a, b in zip(res, sort.sort3_plain(*keep[:3]))):
        raise RuntimeError(f"the grid kernel differs from the plain sort on {name}")


def _timed_variant(rows, spec) -> list:
    import torch

    import chip_smoke
    from fast_limo_tpu_torch.ops import sort

    lib, tile = _variant_library(spec, stamps=False)
    out = []
    for name, _, ops in rows:
        call, res, keep, blocks = _launcher(torch, lib, tile, ops, torch.device("cuda:0"))
        call()
        torch.cuda.synchronize()
        _check(torch, sort, res, keep, name)
        out.append({"row": name, "N": int(ops.shape[1]), "blocks": blocks,
                    "device_ms": chip_smoke._device_ms(call, "fl_sort3_grid"),
                    "events_ms": _events_ms(torch, call)})
    return out


def _phases(rows, spec=(), reps: int = 5) -> list:
    import torch

    from fast_limo_tpu_torch.ops import sort

    lib, tile = _variant_library(spec)
    out = []
    for name, _, ops in rows:
        call, res, keep, blocks = _launcher(torch, lib, tile, ops, torch.device("cuda:0"))
        N = ops.shape[1]
        ns = np.zeros((blocks, len(PHASES)), np.float64)
        host = np.zeros((blocks, len(PHASES)), np.uint64)
        for r in range(reps + 1):   # one warm-up
            call()
            torch.cuda.synchronize()
            if lib.fl_sort3_grid_stamps(host.ctypes.data_as(ctypes.c_void_p), blocks):
                raise RuntimeError(f"the stamps of {name} could not be read")
            if r:
                ns += host
        _check(torch, sort, res, keep, name)
        us = ns.mean(axis=0) / reps / 1e3
        P = _passes(ops)
        out.append({"row": name, "N": int(N), "passes": P, "blocks": blocks,
                    "stamped_us": float(us.sum()),
                    "us": dict(zip(PHASES, map(float, us))),
                    "us_a_pass": dict(zip(PHASES, (float(x) / max(P, 1) for x in us)))})
        print(f"[k9] phases {name} (N={N}, {P} passes, {blocks} blocks): stamped "
              f"{us.sum():.1f} us = " + ", ".join(f"{k} {x:.1f}" for k, x in zip(PHASES, us)),
              flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="*", default=[],
                    help="repository roots whose sort3 is timed, in this order")
    ap.add_argument("--no-phases", action="store_true", help="skip the phase split")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=SPEC: a copy with these rewrites (see above), timed and split")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--rows", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        _worker(args.worker, args.rows)
        return
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("[k9] no CUDA device", flush=True)
        sys.exit(2)
    smi = chip_smoke._smi()
    print(f"[k9] {smi}", flush=True)
    rows = _rows()
    os.makedirs(OUT, exist_ok=True)
    rows_path = os.path.join(OUT, "rows.npz")
    np.savez(rows_path, names=np.array([r[0] for r in rows]),
             forms=np.array([r[1] for r in rows]),
             **{f"row{i}": r[2] for i, r in enumerate(rows)})
    timed = []
    for tree in args.trees:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree,
                              "--rows", rows_path], capture_output=True, text=True)
        lines = [json.loads(x) for x in res.stdout.splitlines() if x.startswith("{")]
        if res.returncode != 0 or len(lines) != len(rows):
            print(res.stdout[-3000:] + res.stderr[-3000:], flush=True)
            sys.exit(1)
        timed.append(lines)
        for x in lines:
            print(f"[k9] {tree}: {x['row']} {'grid' if x['grid'] else 'cluster'} "
                  f"device {chip_smoke._fmt(x['device_ms'])}, wrapper {x['wrapper_ms']:.4f} "
                  f"ms, events over 20 calls {x['events_ms']:.4f} ms | torch.sort device {chip_smoke._fmt(x['torch_sort_device_ms'])} "
                  f"| bit-equal {x['equal']}", flush=True)
        if not all(x["equal"] for x in lines):
            print(f"[k9] FAIL: {tree}'s sort3 differs from its plain version", flush=True)
            sys.exit(1)
    phases = [] if args.no_phases else _phases(rows)
    variants = {}
    for arg in args.variant:
        name, _, spec = arg.partition("=")
        spec = spec.split()
        timed_v = _timed_variant(rows, spec)
        for x in timed_v:
            print(f"[k9] variant {name}: {x['row']} ({x['blocks']} blocks) device "
                  f"{chip_smoke._fmt(x['device_ms'])}, events over 20 calls "
                  f"{x['events_ms']:.4f} ms", flush=True)
        variants[name] = {"spec": spec, "timed": timed_v,
                          "phases": [] if args.no_phases else _phases(rows, spec)}
    print(json.dumps({"device": smi, "trees": args.trees, "timed": timed, "phases": phases,
                      "variants": variants}))


if __name__ == "__main__":
    main()
