"""One production group's time split into accumulation and solve, on the card.

    python -m cwbnwp_letkf_torch.examples.profile_groups [--out PATH]
    python -m cwbnwp_letkf_torch.examples.profile_groups --platform cpu

The port of the JAX package's ``examples/profile_groups.py``.  On the bench
case (:mod:`.bench_case`) it runs the UV group (synop dense, vr bucketed,
k=40, 327,680 points, chunk 2048, budgets from ``update.plan_max_blocks``)
three ways: the full ``update.update_points_group``; the accumulation only
(the update's own point order, accumulators and ``_accumulate_chunk``,
keeping every chunk's normal terms); and the solve only
(``solver.letkf_solve_group_from_normal`` on those terms).  The solve takes
each chunk's background rows in the accumulation's point order, so its
analysis is the full update's.  Each is timed once after a warm run, with
``torch.cuda.synchronize`` around it.  Prints one JSON line with the three
times and ``acc+sol`` beside ``full``; ``--out`` also writes it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..ops import solver, update
from . import bench_case, device_label, select_device

#: the solve batch of the JAX drive
CHUNK = 2048


def group_args(ivars, k):
    """The group's per-variable solve arguments, as the bench sets them."""
    nv = len(ivars)
    return dict(inflats=tuple((k - 1) / bench_case.MULTI_INFL[iv]
                              for iv in ivars),
                rtpp_alpha=(bench_case.RTPP,) * nv,
                rtps_alpha=(bench_case.RTPS,) * nv)


def accumulate(pts, dplats, ivar, *, budgets, chunk, k):
    """``(perm, [(a_obs, g, count)] per chunk)``: the per-group update's
    accumulation, in its point order (``perm`` None for the input order)."""
    active = update._active(dplats, ivar)
    kinds = [update._resolve_kind("auto", dp) for dp, _ in active]
    perm = update._maybe_morton_perm(pts, "auto", active, kinds, ivar)
    q = pts if perm is None else pts[perm]
    b = q.shape[0]
    chunk = min(chunk, max(b, 1))
    accs = update._platform_accumulators(
        active, kinds, ivar, budgets, torch.float32,
        q_chunks=update._padded_chunks(q, chunk))
    terms = []
    for c0 in range(0, b, chunk):
        a, g, cnt, _ = update._accumulate_chunk(
            q[c0:c0 + chunk], accs, ivar, 0, torch.float32, k)
        terms.append((a, g, cnt))
    return perm, terms


def solve(xb_v, perm, terms, *, inflats, rtpp_alpha, rtps_alpha):
    """The group's analysis ``[B, V, k]`` from :func:`accumulate`'s terms."""
    xa = torch.empty_like(xb_v)
    c0 = 0
    for a, g, cnt in terms:
        c = a.shape[0]
        rows = (perm[c0:c0 + c] if perm is not None else slice(c0, c0 + c))
        xa[rows] = solver.letkf_solve_group_from_normal(
            a, g, xb_v[rows], inflats, cnt > 0, rtpp_alpha=rtpp_alpha,
            rtps_alpha=rtps_alpha)
        c0 += c
    return xa


def _timed(fn, dev):
    """``(seconds of one run after a warm run, its result)``."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.time() - t0, out


@torch.inference_mode()
def profile(xb, pts, dplats, *, chunk=CHUNK):
    """Time the bench's UV group three ways on ``xb [B, k]`` and
    ``pts [B, 3]``; returns the record."""
    dev = pts.device
    b, k = xb.shape
    name, ivars, _ = bench_case.PROD_GROUPS[0]
    iv0 = ivars[0]
    budgets = update.plan_max_blocks(pts, dplats, iv0, chunk=chunk)
    kw = group_args(ivars, k)
    xb_v = xb[:, None, :].expand(b, len(ivars), k)

    t_full, xa_full = _timed(lambda: update.update_points_group(
        xb_v, pts, dplats, ivars, weight_function=0, chunk=chunk,
        max_blocks=budgets, **kw), dev)
    t_acc, (perm, terms) = _timed(lambda: accumulate(
        pts, dplats, iv0, budgets=budgets, chunk=chunk, k=k), dev)
    t_sol, xa = _timed(lambda: solve(xb_v, perm, terms, **kw), dev)
    if not (bool(torch.isfinite(xa_full).all())
            and bool(torch.isfinite(xa).all())):
        raise RuntimeError("profile_groups: an analysis is not finite")
    out = {"group": name, "variables": list(ivars), "points": b, "k": k,
           "chunk": chunk, "budgets": {n: list(bb) for n, bb in
                                       budgets.items()},
           "device": device_label(dev), "full_s": round(t_full, 4),
           "accumulation_s": round(t_acc, 4), "solve_s": round(t_sol, 4),
           "acc_plus_sol_s": round(t_acc + t_sol, 4),
           "solve_equals_full": bool(torch.equal(xa, xa_full))}
    print(f"full group:   {t_full:.3f} s\naccumulation: {t_acc:.3f} s\n"
          f"solve:        {t_sol:.3f} s\nacc+sol={t_acc + t_sol:.3f} vs "
          f"full={t_full:.3f}", file=sys.stderr, flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="profile_groups")
    ap.add_argument("--platform", default=None,
                    help="'cpu' for the plain versions; default the card")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    dev = select_device(args.platform)

    pts, xb, plats = bench_case.build_case()
    dplats = [update.prepare_platform(st, po, device=dev) for st, po in plats]
    out = profile(torch.from_numpy(xb).to(dev), torch.from_numpy(pts).to(dev),
                  dplats)
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
