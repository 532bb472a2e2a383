"""The analytic multi-card scaling prediction on the bench case, as JSON.

    python -m cwbnwp_letkf_torch.examples.scaling_model_report \\
        --t-compute-1 SECONDS --h2d-gbs GBS [--prod-compute-s SECONDS] [OUT]

Evaluates :mod:`..parallel.scaling_model` on measured inputs and prints the
JSON, or writes it to ``OUT``:

  * imbalance: the per-shard localized-obs work measured on the bench case
    (bench.py:47-112: 128x128x20 points at 10 km, synop 2,000 records, vr
    and dbz 20,000 each; the U/V group's radii), the quantity the model's
    efficiency degrades by;
  * the bench-case prediction, with ``t_compute(1 card)`` the warm
    single-card 16-variable cycle measured on an H100 (``chip_smoke.py``
    phase 3 prints it) and the pinned host-to-device rate measured there
    (phase 15(d));
  * with ``--prod-compute-s``, the production-volume prediction per group
    (10,530,000 points, k=96, one variable: ``chip_smoke.py`` phase 13's
    projection to 20 slabs): efficiency is a ratio, so one group stands for
    the cycle.

Everything carries ``model: true``; nothing here is a multi-card
measurement.  The case is built on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

#: the bench case (bench.py:47-112): grid and spacing, members, and per
#: platform (name, records, observed variables, cap, obs error, the U/V
#: group's radii (hclr km, vclr km), None where the group takes none)
GRID, DX_M, K = (128, 128, 20), 10e3, 40
PLATFORMS = (("synop", 2000, 5, 100, 0.5, (50.0, 3.0)),
             ("vr", 20000, 1, 300, 1.0, (36.0, 3.0)),
             ("dbz", 20000, 1, 300, 2.5, None))
#: the production volume of phase 13 (bench.py:548-717)
PROD_POINTS, PROD_K = 450 * 450 * 52, 96
#: card counts whose shard work is measured
CARDS = (8, 16, 32, 64)


def bench_case(grid=GRID, device="cuda"):
    """``(points [B, 3], device platforms)`` of the bench case, seed 0."""
    from ..config import MAX_VARS
    from ..obs.base import PlatformStatic
    from ..obs.synthetic import (correlated_ensemble, idealized_grid,
                                 synthetic_gts_platform)
    from ..ops.update import prepare_platform

    rng = np.random.default_rng(0)
    pts = idealized_grid(grid[0], grid[1], grid[2], dx_m=DX_M)
    truth, xb = correlated_ensemble(rng, pts, K, n_bumps=8, length_m=1.5e5)
    plats = []
    for name, nobs, nvar, cap, err, radii in PLATFORMS:
        st, po = synthetic_gts_platform(
            rng, pts, truth, xb, name=name, nobs=nobs, nvar=nvar,
            obs_err=err, max_lz_pts=cap, extent_frac=1.0)
        h, v = radii or (-1.0, -1.0)
        st = PlatformStatic(
            name=name, kind=st.kind, nvar=nvar, max_lz_pts=cap,
            hclr=(h,) * MAX_VARS, vclr=(v,) * MAX_VARS,
            err_muti=st.err_muti, err_rej=st.err_rej, is_assim=st.is_assim)
        plats.append(prepare_platform(st, po, device=device))
    return torch.from_numpy(pts).to(device), plats


def report(pts, platforms, t_compute_1: float, h2d_bytes_s: float, *,
           v_total: int = 16, k: int = K,
           prod_compute_s: float | None = None) -> dict:
    """The model's JSON for measured inputs on the case ``(pts,
    platforms)``: the measured imbalance, the bench-case prediction and,
    given ``prod_compute_s``, the production-volume one."""
    from ..parallel import scaling_model as sm

    imbalance = {}
    for cards in CARDS:
        w = np.asarray(sm.shard_work(pts, platforms, 0, cards, chunk=512))
        imbalance[cards] = float(w.max() / max(w.mean(), 1e-30))
    obs = sm.obs_bytes(platforms)
    kw = dict(n_hosts=(1, 2, 4, 8), imbalance=imbalance,
              h2d_bytes_s=h2d_bytes_s)
    out = {
        "model": True,
        "inputs": {
            "t_compute_1_s": t_compute_1,
            "h2d_bytes_s": h2d_bytes_s,
            "prod_group_compute_s": prod_compute_s,
            "obs_bytes": obs,
            "imbalance_measured": {str(c): round(v, 4)
                                   for c, v in imbalance.items()},
        },
        "bench_case": sm.predict(int(pts.shape[0]), v_total, k, t_compute_1,
                                 obs, **kw),
    }
    if prod_compute_s is not None:
        out["production_volume_per_group"] = sm.predict(
            PROD_POINTS, 1, PROD_K, prod_compute_s, obs, **kw)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="scaling_model_report")
    ap.add_argument("out", nargs="?", default=None,
                    help="write the JSON here (default: print it)")
    ap.add_argument("--t-compute-1", type=float, required=True,
                    help="warm single-card cycle seconds (chip_smoke.py "
                         "phase 3)")
    ap.add_argument("--h2d-gbs", type=float, required=True,
                    help="pinned host-to-device GB/s (chip_smoke.py phase "
                         "15(d))")
    ap.add_argument("--prod-compute-s", type=float, default=None,
                    help="one group's seconds at the production volume "
                         "(chip_smoke.py phase 13's 20-slab projection)")
    ap.add_argument("--grid", type=int, nargs=3, default=GRID)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    pts, plats = bench_case(tuple(args.grid), args.device)
    out = report(pts, plats, args.t_compute_1, args.h2d_gbs * 1e9,
                 prod_compute_s=args.prod_compute_s)
    text = json.dumps(out, indent=1)
    if args.out is None:
        print(text)
    else:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
