"""One process of a multi-process sharded run (port of
fast_limo_tpu/parallel/_dist_worker.py) over ``torch.distributed`` (gloo,
CPU tensors): one rank a process, all processes forming one 'map' mesh.
It drives what a single-process mesh never touches: the collectives
between processes inside the sharded scan step, and the checkpoint saved
from and restored onto processes that each hold one shard.

Run by file path, one process a rank:

    python fast_limo_tpu_torch/parallel/_dist_worker.py \\
        --process-id 0 --num-processes 2 --port 12345 --scans 2 --out w.npz

Rank 0 writes ``--out`` (the per-scan positions, the final map point
count, the continuation positions from the live and the restored state,
the round-trip flag, the received bytes) and, with ``--checkpoint``,
leaves the checkpoint it saved after the scans there.  Every process
exits 0 on success.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--scans", type=int, default=3)
    ap.add_argument("--out", required=True)
    ap.add_argument("--checkpoint", default=None,
                    help="keep the checkpoint saved after the scans at this path")
    args = ap.parse_args(argv)

    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from fast_limo_tpu_torch import entry
    from fast_limo_tpu_torch.parallel import distributed as dist
    from fast_limo_tpu_torch.parallel import sharded

    n = args.num_processes
    dist.initialize(f"localhost:{args.port}", n, args.process_id)
    try:
        # ('map',) mesh over the processes: scans + checkpoint
        mesh = sharded.make_mesh(n, backend="gloo")
        cfg = entry._tiny_cfg(n_pts=512, map_cap=1024, n_shards=n)
        step, state = sharded.build_sharded_scan_step(cfg, mesh, device="cpu")
        positions = []
        for i in range(args.scans):
            state, out = step(state, entry._example_batch(cfg, seed=i, device="cpu"))
            positions.append(out.pos.numpy().copy())
        received = mesh.received()

        ckpt_path = args.checkpoint or os.path.join(
            os.path.dirname(os.path.abspath(args.out)), f"dist_ckpt_{args.port}.npz")
        dist.save_checkpoint(ckpt_path, state, mesh)
        restored = dist.load_checkpoint(
            ckpt_path, sharded.init_global_state(cfg, n, "cpu"), mesh)
        batch = entry._example_batch(cfg, seed=999, device="cpu")
        s_live, out_live = step(state, batch)
        s_rest, out_rest = step(restored, batch)
        np_live = int(s_live.map.num_points)
        roundtrip_ok = bool(torch.equal(out_live.pos, out_rest.pos)
                            and torch.equal(s_live.map.table, s_rest.map.table)
                            and np_live == int(s_rest.map.num_points))

        if args.process_id == 0:
            np.savez(args.out, positions=np.stack(positions), final_pos=out_live.pos.numpy(),
                     num_points=np_live, roundtrip_ok=roundtrip_ok,
                     n_processes=n, received=json.dumps(received))
        dist.barrier(mesh)
        if args.checkpoint is None and args.process_id == 0 and os.path.exists(ckpt_path):
            os.remove(ckpt_path)
    finally:
        torch.distributed.destroy_process_group()
    print(f"[dist-worker p{args.process_id}] ok: {n} processes (gloo), "
          f"roundtrip_ok={roundtrip_ok}", flush=True)
    return 0 if roundtrip_ok else 1


if __name__ == "__main__":
    sys.exit(main())
