"""End-to-end drive of the update on the card: a synthetic analysis, checked.

    python -m cwbnwp_letkf_torch.examples.gpu_drive [--platform cpu]

The counterpart of the JAX package's ``examples/tpu_drive.py``, on its
case: 64x64 points at 4 km and z = 500 m, k=40 members that are a +2
biased truth plus spatially correlated perturbations, 60 stations near the
domain centre observing the truth with 0.2 noise (error 0.5, hclr 10 km,
cap 100).  For both weight functions ``update_points`` must: lower the
analysis-mean RMSE near the stations below half the background's; leave
the far corner, beyond every station's cutoff, bit for bit the background;
shrink the spread; and give a bit-identical rerun.  Then a fused
3-variable ``update_points_group`` (the field, a half copy and a shifted
copy, each with its own inflation and relaxation) must be within 1e-3 of
the per-variable solves.  A failed check raises.  Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import device_label, select_device

K = 40
NX = NY = 64
DX_M = 4000.0
N_STATIONS = 60
RHO = 1.2
CHUNK = 2048
#: the fused group: per variable (inflation divisor, RTPP, RTPS)
FUSED = ((1.2, 0.0, 0.9), (1.0, 0.8, 0.0), (1.5, 0.0, 0.0))


def build_case():
    """``(pts [B, 3], xb [B, k], truth [NX, NY], (six, siy), (static,
    obs))``: the JAX drive's arrays, from the same seeds."""
    from ..config import MAX_VARS
    from ..obs.base import PlatformStatic, make_platform_obs

    rng = np.random.default_rng(0)
    xs = np.arange(NX) * DX_M
    ys = np.arange(NY) * DX_M
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    pts = np.stack([gx.ravel(), gy.ravel(), np.full(NX * NY, 500.0)], -1)

    def smooth_field(seed, scale=1.0):
        f = np.random.default_rng(seed).normal(size=(8, 8))
        return scale * np.kron(f, np.ones((NX // 8, NY // 8)))

    truth = smooth_field(1, 3.0)
    xb = np.empty((NX * NY, K), np.float32)
    for m in range(K):
        xb[:, m] = (truth + 2.0 + smooth_field(100 + m, 1.5)).ravel()

    six = rng.integers(NX // 4, 3 * NX // 4, N_STATIONS)
    siy = rng.integers(NY // 4, 3 * NY // 4, N_STATIONS)
    sxyz = np.stack([xs[six], ys[siy], np.full(N_STATIONS, 500.0)], -1)
    yobs = truth[six, siy] + rng.normal(0, 0.2, N_STATIONS)
    hdxb = xb.reshape(NX, NY, K)[six, siy, :]
    err = np.full(N_STATIONS, 0.5, np.float32)
    po = make_platform_obs(sxyz, yobs, hdxb, error=err)
    # the cutoff is about 3.65 hclr (gc1999), so 10 km reaches ~37 km; the
    # (0, 0) corner is at least 90 km from every station
    st = PlatformStatic(
        name="synop", kind="gts", nvar=1, max_lz_pts=100,
        hclr=tuple([10.0] + [0.0] * (MAX_VARS - 1)),
        vclr=tuple([-1.0] * MAX_VARS), err_muti=(1.0,), err_rej=(1e9,),
        is_assim=((True,) + (False,) * (MAX_VARS - 1),))
    return pts.astype(np.float32), xb, truth, (six, siy), (st, po)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"gpu_drive: {what}")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.inference_mode()
def main(device="cuda"):
    """Run the drive's checks on ``device``; returns ``(report, analyses)``,
    the analyses as numpy arrays: ``xa_wf0``, ``xa_wf1`` ``[B, k]`` and
    ``xa_group`` ``[B, 3, k]``.  A failed check raises."""
    from ..ops import ns_kernel
    from ..ops.update import (prepare_platform, update_points,
                              update_points_group)

    dev = select_device(device)
    pts, xb, truth, (six, siy), (st, po) = build_case()
    dp = prepare_platform(st, po, device=dev)
    xb_d = torch.from_numpy(xb).to(dev)
    pts_d = torch.from_numpy(pts).to(dev)
    n0 = ns_kernel.LAUNCHES["trio"]
    report = {"device": device_label(dev), "points": NX * NY, "k": K,
              "stations": N_STATIONS}
    analyses = {}
    near = np.zeros((NX, NY), bool)
    near[six, siy] = True

    def one(wf):
        out = update_points(xb_d, pts_d, [dp], 0, inflat=(K - 1) / RHO,
                            weight_function=wf, chunk=CHUNK)
        _sync(dev)
        return out.cpu().numpy()

    for wf in (0, 1):
        t0 = time.time()
        xa = one(wf)
        wall = time.time() - t0
        check(np.isfinite(xa).all(), f"non-finite analysis wf={wf}")
        check(np.array_equal(xa, one(wf)), f"rerun not bit-identical wf={wf}")
        xam = xa.mean(-1).reshape(NX, NY)
        xbm = xb.mean(-1).reshape(NX, NY)
        rmse_b = float(np.sqrt(((xbm - truth) ** 2)[near].mean()))
        rmse_a = float(np.sqrt(((xam - truth) ** 2)[near].mean()))
        far_same = bool(np.array_equal(xa.reshape(NX, NY, K)[0, 0],
                                       xb.reshape(NX, NY, K)[0, 0]))
        spread_b = float(xb.reshape(NX, NY, K)[near].std(-1).mean())
        spread_a = float(xa.reshape(NX, NY, K)[near].std(-1).mean())
        print(f"wf={wf}: rmse {rmse_b:.3f} -> {rmse_a:.3f}, spread "
              f"{spread_b:.3f} -> {spread_a:.3f}, far_identical={far_same}, "
              f"wall={wall:.3f}s", file=sys.stderr, flush=True)
        check(rmse_a < 0.5 * rmse_b,
              f"RMSE did not drop near stations wf={wf}")
        check(far_same, f"far points modified wf={wf}")
        check(spread_a < spread_b, f"spread did not shrink wf={wf}")
        report[f"wf{wf}"] = {"rmse_b": rmse_b, "rmse_a": rmse_a,
                             "spread_b": spread_b, "spread_a": spread_a,
                             "far_identical": far_same,
                             "rerun_identical": True,
                             "wall_s": round(wall, 4)}
        analyses[f"xa_wf{wf}"] = xa

    # the fused group: the field, a half copy and a shifted copy with their
    # own inflation and relaxation; each slice must match its own solve
    xb3 = torch.stack([xb_d, 0.5 * xb_d, xb_d + 3.0], 1)
    inflats = tuple((K - 1) / f for f, _, _ in FUSED)
    rtpp = tuple(p for _, p, _ in FUSED)
    rtps = tuple(s for _, _, s in FUSED)
    t0 = time.time()
    xa3 = update_points_group(xb3, pts_d, [dp], (0, 0, 0), inflats=inflats,
                              weight_function=0, rtpp_alpha=rtpp,
                              rtps_alpha=rtps, chunk=CHUNK)
    _sync(dev)
    wall = time.time() - t0
    xa3 = xa3.cpu().numpy()
    check(np.isfinite(xa3).all(), "non-finite fused analysis")
    errs = []
    for vi in range(3):
        single = update_points(
            xb3[:, vi], pts_d, [dp], 0, inflat=inflats[vi], weight_function=0,
            use_rtpp=rtpp[vi] > 0, rtpp_alpha=rtpp[vi],
            use_rtps=rtps[vi] > 0, rtps_alpha=rtps[vi], chunk=CHUNK)
        errs.append(float(np.abs(xa3[:, vi] - single.cpu().numpy()).max()))
        print(f"fused var {vi}: max |fused - single| = {errs[-1]:.2e}",
              file=sys.stderr, flush=True)
        check(errs[-1] < 1e-3, "fused path diverges from per-variable path")
    report["fused"] = {"max_abs_diff": errs, "wall_s": round(wall, 4)}
    report["k1_launches"] = ns_kernel.LAUNCHES["trio"] - n0
    analyses["xa_group"] = xa3
    return report, analyses


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gpu_drive")
    ap.add_argument("--platform", default=None,
                    help="'cpu' for the plain versions; default the card")
    args = ap.parse_args(argv)
    report, _ = main(args.platform or "cuda")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(cli())
