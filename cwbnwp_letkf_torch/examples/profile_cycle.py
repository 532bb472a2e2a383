"""Where the fused production cycle's time goes, on the card: a stage ablation.

    python -m cwbnwp_letkf_torch.examples.profile_cycle [--reps 2] [--out PATH]
    python -m cwbnwp_letkf_torch.examples.profile_cycle --platform cpu

The port of the JAX package's ``examples/profile_cycle.py``.  On the bench
case (:mod:`.bench_case`: 327,680 points, 16 variables in the 5 production
groups, k=40; chunk 4096, subchunk 512, budgets from
``cycle.plan_cycle_budgets``) it times six nested stages:

  full_cycle   ``cycle.update_points_cycle``: accumulation and solve
  accum_only   the cycle's accumulation (``cycle.accumulate_chunk`` per
               chunk, its terms reduced to sums), no solve
  accum_nocap  accum_only with the ``max_lz_pts`` cap multisection off:
               the cost of the cap search
  cull_only    accum_only with ``terms_from_r2`` replaced by cheap sums
               that still read every gathered table row: culling, gathers
               and distances
  solve_only   the stacked per-chunk solves
               (``solver.letkf_solve_cycle_from_normal``) on synthetic
               normal terms ``a = 3 I + 0.01 x x^T``
  ns_only      only the ``Z = A^(-1/2)`` builds (``solver._ns_z``, the
               Newton-Schulz kernel on a card), one per distinct inflation
               value stacked across groups: the cycle's two launches a chunk

and derives: solve = full - accum; cap search = accum - accum_nocap;
gather and distance = cull_only; accumulation matmul = accum_nocap -
cull_only; weight application = solve_only - ns_only; Z builds = ns_only.

Each stage runs once warm, then ``reps`` times; the best is kept, with
``torch.cuda.synchronize`` around each run.  The Newton-Schulz kernel's
launches of one run of each stage are counted.  Prints one JSON line, with
the keys of the JAX package's ``PROFILE_CYCLE_r05.json`` plus ``device`` and
``k1_launches``; ``--out`` also writes it to a file.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from ..constants import GC1999_SQ
from ..ops import cycle, dense, ns_kernel, solver
from . import bench_case, device_label, select_device

STAGES = ("full_cycle", "accum_only", "accum_nocap", "cull_only",
          "solve_only", "ns_only")


def table_k(width: int) -> int:
    """k of a fused table row, ``width = k (k + 1)``
    (:func:`..ops.dense.fused_platform_table`'s layout)."""
    return int((-1 + (1 + 4 * width) ** 0.5) / 2)


def cheap_terms(r2, fused, nvalid, *, n_max, weight_function,
                r2_cap=GC1999_SQ, row_mask=None):
    """``terms_from_r2`` without the cap search, the weights and the
    accumulation matmul: sums that read every distance and every gathered
    table row, so the gathers and distances stay in the stage's work."""
    c = r2.shape[0]
    k = table_k(fused.shape[-1])
    s = r2.sum(-1) + (fused.sum() + nvalid.sum()) * 1e-30
    a = torch.zeros((c, k, k), dtype=fused.dtype, device=r2.device) \
        + s[:, None, None].to(fused.dtype)
    g = torch.zeros((c, k), dtype=fused.dtype, device=r2.device)
    cnt = torch.ones((c,), dtype=torch.int32, device=r2.device)
    return a, g, cnt


def nocap_terms_of(real):
    """``real`` (``terms_from_r2``) with a cap that never binds."""
    def nocap_terms(r2, fused, nvalid, **kw):
        kw["n_max"] = r2.shape[1] + 1
        return real(r2, fused, nvalid, **kw)

    return nocap_terms


@contextlib.contextmanager
def terms_swapped(fn):
    """``terms_from_r2`` replaced by ``fn`` in both ``ops.cycle`` (which
    binds the name at import) and ``ops.dense``; the originals come back on
    every exit, exceptions included."""
    saved = cycle.terms_from_r2, dense.terms_from_r2
    cycle.terms_from_r2 = dense.terms_from_r2 = fn
    try:
        yield
    finally:
        cycle.terms_from_r2, dense.terms_from_r2 = saved


def accumulate_sums(pts, dplats, groups, *, budgets, chunk, subchunk, k):
    """The cycle's accumulation over all points, each chunk's terms reduced
    to per-group sums before the next chunk: ``(a [G], g [G])`` float64 and
    ``count [G]`` int64 (holding every chunk's terms would take
    80 x 5 x 4096 x 40 x 40 x 4 B = 10.5 GB on the bench case)."""
    plans = cycle._resolve_plans(dplats, groups, max_blocks=budgets)
    perm = cycle._cycle_point_perm(pts, plans)
    q = pts if perm is None else pts[perm]
    b = q.shape[0]
    chunk, sub = cycle._subchunk(b, chunk, subchunk)
    n_groups = len(groups)
    dev = q.device
    a_s = torch.zeros(n_groups, dtype=torch.float64, device=dev)
    g_s = torch.zeros(n_groups, dtype=torch.float64, device=dev)
    c_s = torch.zeros(n_groups, dtype=torch.int64, device=dev)
    for c0 in range(0, b, chunk):
        a, g, cnt, _ = cycle.accumulate_chunk(
            q[c0:c0 + chunk], plans, groups, k=k, weight_function=0,
            subchunk=sub)
        a_s += a.sum((1, 2, 3), dtype=torch.float64)
        g_s += g.sum((1, 2), dtype=torch.float64)
        c_s += cnt.sum(1, dtype=torch.int64)
    return a_s, g_s, c_s


def synthetic_normal(xbc):
    """``a = 3 I + 0.01 x x^T`` ``[C, k, k]`` per point, ``x`` its members."""
    k = xbc.shape[-1]
    eye = torch.eye(k, dtype=torch.float32, device=xbc.device)
    return 3.0 * eye + 0.01 * xbc[:, :, None] * xbc[:, None, :]


def ns_chunk(xbc, groups):
    """``{inflation value: Z}``: one stacked ``solver._ns_z`` call per
    distinct inflation value, over the groups that take it, as the cycle's
    solve stacks them (two under the production namelist)."""
    a = synthetic_normal(xbc)
    by_val: dict = {}
    for gi, grp in enumerate(groups):
        for val in dict.fromkeys(float(v) for v in grp.inflats):
            by_val.setdefault(val, []).append(gi)
    return {val: solver._ns_z(torch.cat([a] * len(gis)), val)[0]
            for val, gis in by_val.items()}


def solve_chunk(xbc, groups):
    """Every group's solve of one chunk on the synthetic normal terms, ``g``
    all ones and one background field for every variable:
    ``(xa per group, {"ns_residual"})``."""
    c, k = xbc.shape
    a = synthetic_normal(xbc)
    g = torch.ones((c, k), dtype=torch.float32, device=xbc.device)
    has = torch.ones((c,), dtype=torch.bool, device=xbc.device)
    return solver.letkf_solve_cycle_from_normal(
        [a] * len(groups), [g] * len(groups),
        [xbc[:, None, :].expand(c, len(grp.ivars), k) for grp in groups],
        [grp.inflats for grp in groups], [has] * len(groups),
        rtpp_alpha_groups=[grp.rtpp_alpha for grp in groups],
        rtps_alpha_groups=[grp.rtps_alpha for grp in groups],
        solver_dtype=torch.float32, return_diagnostics=True)


def make_stages(xb, pts, dplats, groups, *, budgets, chunk=bench_case.CHUNK,
                subchunk=bench_case.SUBCHUNK):
    """``{stage: callable}`` on ``xb [B, k]`` (one field for every
    variable, as the JAX drive broadcasts it) and ``pts [B, 3]``; each
    callable returns what its stage computed: the analysis, the sums
    ``(a, g, count)`` per group, or a 0-d float64 total."""
    b, k = xb.shape
    v_tot = sum(len(grp.ivars) for grp in groups)

    def full_cycle():
        return cycle.update_points_cycle(
            xb[:, None, :].expand(b, v_tot, k), pts, dplats, groups,
            weight_function=0, chunk=chunk, subchunk=subchunk,
            max_blocks=budgets)

    def accum(terms):
        def run():
            ctx = (terms_swapped(terms) if terms is not None
                   else contextlib.nullcontext())
            with ctx:
                return accumulate_sums(pts, dplats, groups, budgets=budgets,
                                       chunk=chunk, subchunk=subchunk, k=k)
        return run

    def solve(body):
        def run():
            tot = torch.zeros((), dtype=torch.float64, device=xb.device)
            for c0 in range(0, b, chunk):
                tot += body(xb[c0:c0 + chunk])
            return tot
        return run

    def solve_total(xbc):
        outs, diag = solve_chunk(xbc, groups)
        return (torch.cat(outs, 1).sum(dtype=torch.float64)
                + diag["ns_residual"])

    def ns_total(xbc):
        return sum(z[:, 0, 0].sum(dtype=torch.float64)
                   for z in ns_chunk(xbc, groups).values())

    return {"full_cycle": full_cycle,
            "accum_only": accum(None),
            "accum_nocap": accum(nocap_terms_of(dense.terms_from_r2)),
            "cull_only": accum(cheap_terms),
            "solve_only": solve(solve_total),
            "ns_only": solve(ns_total)}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_stage(fn, dev, reps):
    """``(best seconds of reps runs after a warm one, K1 launches of one
    run)``; raises if the last run's result is not finite."""
    n0 = ns_kernel.LAUNCHES["trio"]
    out = fn()
    _sync(dev)
    launches = ns_kernel.LAUNCHES["trio"] - n0
    best = float("inf")
    for _ in range(reps):
        t0 = time.time()
        out = fn()
        _sync(dev)
        best = min(best, time.time() - t0)
    for x in (out if isinstance(out, tuple) else (out,)):
        if not bool(torch.isfinite(x).all()):
            raise RuntimeError("a stage's result is not finite")
    return best, launches


@torch.inference_mode()
def profile(xb, pts, dplats, groups, *, budgets=None, chunk=bench_case.CHUNK,
            subchunk=bench_case.SUBCHUNK, reps=2):
    """Time the six stages on ``xb [B, k]`` and ``pts [B, 3]`` (tensors on
    one device) with ``reps`` timed runs each; returns the record (budgets
    planned here unless given)."""
    dev = pts.device
    if budgets is None:
        budgets = cycle.plan_cycle_budgets(pts, dplats, groups, chunk=chunk,
                                           subchunk=subchunk)
    stages = make_stages(xb, pts, dplats, groups, budgets=budgets,
                         chunk=chunk, subchunk=subchunk)
    out = {"points": int(pts.shape[0]), "k": int(xb.shape[1]),
           "n_vars": sum(len(grp.ivars) for grp in groups),
           "chunk": chunk, "subchunk": subchunk,
           "budgets": {n: list(bb) for n, bb in budgets.items()},
           "device": device_label(dev), "reps": reps, "k1_launches": {}}
    for name in STAGES:
        best, launches = time_stage(stages[name], dev, reps)
        out[name + "_s"] = round(best, 4)
        out["k1_launches"][name] = launches
        print(f"[prof] {name}: {best:.4f} s, K1 launches {launches}",
              file=sys.stderr, flush=True)
    full, acc = out["full_cycle_s"], out["accum_only_s"]
    out["derived"] = {
        "solve_s": round(full - acc, 4),
        "cap_search_s": round(acc - out["accum_nocap_s"], 4),
        "gather_distance_s": out["cull_only_s"],
        "accumulate_matmul_s": round(
            out["accum_nocap_s"] - out["cull_only_s"], 4),
        "weight_apply_s": round(out["solve_only_s"] - out["ns_only_s"], 4),
        "ns_z_builds_s": out["ns_only_s"],
    }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="profile_cycle")
    ap.add_argument("--platform", default=None,
                    help="'cpu' for the plain versions; default the card")
    ap.add_argument("--reps", type=int, default=2,
                    help="timed runs per stage after one warm run")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    dev = select_device(args.platform)

    from ..ops.update import prepare_platform

    pts, xb, plats = bench_case.build_case()
    dplats = [prepare_platform(st, po, device=dev) for st, po in plats]
    out = profile(torch.from_numpy(xb).to(dev), torch.from_numpy(pts).to(dev),
                  dplats, bench_case.prod_cycle_groups(), reps=args.reps)
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
