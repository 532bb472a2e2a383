"""Scaling efficiency of the sharded per-variable update.

    torchrun --nproc-per-node N -m cwbnwp_letkf_torch.examples.scaling_bench
    python -m cwbnwp_letkf_torch.examples.scaling_bench --mock [--shards 8]

Times :func:`..parallel.update.sharded_update_points` on a synthetic case
over meshes of n cards, n in {1, 2, N}, and reports

    efficiency(n) = wall(1 card) / (n * wall(n cards)).

Under torchrun each process binds one card (``LOCAL_RANK``) and the mesh of
n is a process group of the first n ranks (NCCL), whose shards run
concurrently.  ``--mock`` runs in-process meshes of CPU shards, which run in
turn: it validates the harness only, and its numbers say nothing of
scaling (the output says so).  Rank 0 prints one JSON line: walls,
efficiency and the analytic leg (:mod:`..parallel.scaling_model`, labelled
``model``) built on the measured one-card wall, the measured shard-work
imbalance and, on a card, the measured pinned host-to-device rate.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist


def build_case(points: int, members: int, nobs: int, device):
    """The JAX scaling bench's case: ``(pts [B, 3], xb [B, k], platform)``."""
    from ..obs.synthetic import (correlated_ensemble, idealized_grid,
                                 synthetic_gts_platform)
    from ..ops.update import prepare_platform

    rng = np.random.default_rng(0)
    side = int(np.sqrt(points / 16))
    pts = idealized_grid(side, side, 16, dx_m=8e3)
    truth, xb = correlated_ensemble(rng, pts, members, n_bumps=6)
    st, po = synthetic_gts_platform(
        rng, pts, truth, xb, nobs=nobs, nvar=2, hclr_km=40.0, vclr_km=3.0,
        max_lz_pts=100, extent_frac=1.0)
    return pts, xb, prepare_platform(st, po, device=device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="scaling_bench")
    ap.add_argument("--mock", action="store_true",
                    help="in-process CPU shards: validates the harness only")
    ap.add_argument("--shards", type=int, default=8,
                    help="largest mesh of --mock")
    ap.add_argument("--points", type=int, default=65536)
    ap.add_argument("--members", type=int, default=20)
    ap.add_argument("--nobs", type=int, default=5000)
    ap.add_argument("--chunk", type=int, default=2048)
    args = ap.parse_args(argv)

    from ..parallel import scaling_model as sm
    from ..parallel.mesh import make_mesh
    from ..parallel.update import sharded_update_points

    if args.mock:
        device, rank, world = torch.device("cpu"), 0, args.shards
    else:
        if "RANK" not in os.environ:
            raise SystemExit("run under torchrun (one process per card), "
                             "or pass --mock")
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method="env://", rank=rank,
                                world_size=world)
    try:
        k = args.members
        pts, xb, dp = build_case(args.points, k, args.nobs, device)
        b = pts.shape[0]
        sizes = sorted({1, 2, world} & set(range(1, world + 1)))
        walls = {}
        for n in sizes:
            if args.mock:
                mesh = make_mesh([device] * n)
            else:
                group = dist.new_group(list(range(n)))   # every rank calls
                mesh = make_mesh(group=group) if rank < n else None
            if mesh is not None:
                bb = (b // (n * args.chunk)) * n * args.chunk or n * args.chunk
                xb_d = torch.from_numpy(xb[:bb]).to(device)
                q_d = torch.from_numpy(pts[:bb]).to(device)

                def run():
                    sharded_update_points(
                        mesh, xb_d, q_d, [dp], 0, inflat=(k - 1) / 1.1,
                        weight_function=0, chunk=args.chunk)
                    _sync(device)

                run()                                     # warm
                best = float("inf")
                for _ in range(3):
                    t0 = time.time()
                    run()
                    best = min(best, time.time() - t0)
                walls[n] = best
                if rank == 0:
                    print(f"n={n}: {best:.3f}s", file=sys.stderr, flush=True)
            if not args.mock:
                dist.barrier()
        if rank != 0:
            return 0
        eff = {n: walls[sizes[0]] * sizes[0] / (n * walls[n]) for n in sizes}

        # the analytic leg: measured shard balance and comm volumes folded
        # into a labelled model (parallel/scaling_model.py)
        q = torch.from_numpy(pts).to(device)
        imb, shards = {}, {}
        for cards in (8, 16, 32, 64):
            w = np.asarray(sm.shard_work(q, [dp], 0, cards))
            if w.sum() > 0:
                imb[cards] = float(w.max() / w.mean())
            shards[str(cards)] = {"points_per_shard": -(-b // cards),
                                  "work_imbalance": round(imb.get(cards, 1.0),
                                                          4)}
        model = None
        if device.type == "cuda":
            model = sm.predict(b, 1, k, walls[sizes[0]], sm.obs_bytes([dp]),
                               n_hosts=(1, 2, 4, 8), imbalance=imb,
                               h2d_bytes_s=sm.pinned_h2d_bytes_s(device))
            model["shards"] = shards
        print(json.dumps({
            "walls_s": {str(n): round(w, 3) for n, w in walls.items()},
            "efficiency": {str(n): round(e, 3) for n, e in eff.items()},
            "points": b, "k": k, "mock": bool(args.mock),
            "note": ("mock run: in-process CPU shards run in turn; validates "
                     "the harness, says nothing of scaling" if args.mock else
                     "one process per card under NCCL"),
            "shards": shards,
            "analytic": model,
        }))
        return 0
    finally:
        if not args.mock:
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
