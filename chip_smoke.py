#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port's main path, on one NVIDIA GPU.

    python3 chip_smoke.py        (from the repository root; needs one card)

Phases, in order; any failure raises and the exit code is not 0:

0. the card: name and power limit, torch and CUDA versions;
1. build the CUDA Newton-Schulz kernel from ``cwbnwp_letkf_torch/csrc``;
2. the kernel against its plain PyTorch version at the main path's stacked
   shape ``[12288, 40, 40]`` and at ``[2048, 96, 96]``, on seeded normal
   matrices and on ill-conditioned dense-obs ones, with both times;
3. the slice: the fused production-grouped cycle (prepare_platform ->
   plan_cycle_budgets -> update_points_cycle -> tune_q) on the bench case,
   327,680 points x 16 variables at k=40, checked for finite values, zero
   overflow, a converged solve, kernel launches and a lower analysis RMSE;
   then a second, warm run, timed;
4. the kernel against the plain version on the real normal matrices of the
   cycle's first chunk.

The last two lines of standard output are the kernel record and the device
record, each one JSON object.  The port is imported from this directory, so
the script fails when run alone, and it fails without a card.
"""
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
K = 40
GRID = (128, 128, 20)       # 327,680 points at dx = 10 km
DX_M = 10e3
N_VARS = 16
CHUNK, SUBCHUNK = 4096, 512
#: var_update positions: 0:U 1:V 2:W 3:T 4:QVAPOR 5-12:hydrometeors 13:MU 14:P 15:PH
HYDRO = tuple(range(5, 13))
MOIST = slice(4, 13)        # the columns tune_q fixes
#: production variable groups by localization signature (input.nml:38-55):
#: (ivars, per-platform radii {platform: (hclr km, vclr km)})
PROD_GROUPS = (
    ((0, 1), {"synop": (50.0, 3.0), "vr": (36.0, 3.0)}),
    ((2,), {"synop": (50.0, 3.0), "vr": (12.0, 3.0)}),
    ((3, 4), {"synop": (50.0, 3.0), "vr": (24.0, 3.0)}),
    (HYDRO, {"dbz": (8.0, 2.0)}),
    ((13, 14, 15), {"synop": (50.0, -1.0), "vr": (24.0, -1.0)}),
)
#: platform, records, observed variables, max_lz_pts, obs error
PLATFORMS = (("synop", 2000, 5, 100, 0.5), ("vr", 20000, 1, 300, 1.0),
             ("dbz", 20000, 1, 300, 2.5))
#: multiplicative inflation (input.nml:160-170): 1.6 dynamics, 1.1 moisture
MULTI_INFL = tuple(1.1 if i >= 4 else 1.6 for i in range(N_VARS))
RTPP = RTPS = 0.95
NS_TOL = 1e-4
KERNEL_SOURCE = "cwbnwp_letkf_torch/csrc/ns_invsqrt.cu"
REPLACES = "cwbnwp_letkf_tpu/ops/pallas_ns.py:109"


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def median_ms(fn, reps=5):
    """Median of ``reps`` warm runs, timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def normal_matrices(rng, b, k, dev):
    """``Y Y^T`` with ``Y`` ``[b, k, 2k]`` of N(0, 0.5^2) entries."""
    y = torch.from_numpy(
        rng.standard_normal((b, k, 2 * k)).astype(np.float32) * 0.5).to(dev)
    return y @ y.transpose(1, 2)


def ill_conditioned_matrices(rng, b, k, dev, n=300):
    """300 strong obs seeing one ensemble mode: kappa in the hundreds."""
    u = rng.standard_normal((b, k, 1)).astype(np.float32)
    w = rng.standard_normal((b, 1, n)).astype(np.float32)
    y = 5.0 * u * w + 0.1 * rng.standard_normal((b, k, n)).astype(np.float32)
    y = torch.from_numpy(y).to(dev)
    return y @ y.transpose(1, 2)


def compare_kernel(a, inflat, label):
    """Kernel vs plain on one batch, with the CPU tests' tolerances.

    ``max|Z A Z - I|`` (float64) below ``max(5e-4, 20 kappa 1.2e-7)``, the
    float32 floor of the iteration (tests/test_ns_solver.py:115), and Z
    within ``max(2e-4, 20 kappa 1.2e-7) max|Z|`` of the plain version: 2e-4
    (tests/test_ns_solver.py:256-258) below kappa ~ 83, the same float32
    floor above, since the kernel runs the map in another form (it tracks
    ``W = ZY``, not ``Y``).  Against the float64 eigh solution the kernel's
    Z must also be no worse than twice the plain version's error (or
    ``2e-4 max|Z|``).  Returns ``max|dZ|``.
    """
    from cwbnwp_letkf_torch.ops import ns_kernel, solver

    z, iters, resid = ns_kernel.launch(a, inflat)
    z_plain, iters_plain, err_plain = solver.ns_invsqrt(a, inflat,
                                                        return_info=True)
    k = a.shape[-1]
    eye = torch.eye(k, dtype=torch.float64, device=a.device)
    a64 = a.double() + inflat * eye
    lam, vec = torch.linalg.eigh(a64)
    kappa = float((lam[:, -1] / lam[:, 0]).max())
    floor = 20 * kappa * 1.2e-7
    z_true = (vec * lam.rsqrt()[:, None, :]) @ vec.transpose(1, 2)
    err_true = float((z.double() - z_true).abs().max())
    err_true_plain = float((z_plain.double() - z_true).abs().max())

    def zaz(zz):
        zz = zz.double()
        return float((zz @ a64 @ zz - eye).abs().max())

    res, res_plain = zaz(z), zaz(z_plain)
    res_tol = max(5e-4, floor)
    dz = float((z - z_plain).abs().max())
    dz_tol = max(2e-4, floor) * float(z_plain.abs().max())
    print(f"  {label}: kappa_max {kappa:.1f}  iters kernel max "
          f"{int(iters.max())} mean {float(iters.float().mean()):.3f}, plain "
          f"{iters_plain}  NS residual kernel {float(resid.max()):.3e}, plain "
          f"{float(err_plain):.3e}  max|ZAZ-I| kernel {res:.3e}, plain "
          f"{res_plain:.3e} (tol {res_tol:.1e})  max|dZ| {dz:.3e} "
          f"(tol {dz_tol:.3e})  max|Z - Z_f64| kernel {err_true:.3e}, plain "
          f"{err_true_plain:.3e}")
    check(bool(torch.isfinite(z).all()), f"{label}: kernel Z not finite")
    check(float(resid.max()) <= NS_TOL, f"{label}: kernel did not converge")
    check(res < res_tol, f"{label}: max|ZAZ-I| {res} >= {res_tol}")
    check(dz <= dz_tol, f"{label}: kernel and plain Z differ by {dz}")
    # and no less accurate than the plain version, against float64 eigh
    check(err_true <= max(2 * err_true_plain, 2e-4 * float(z_true.abs().max())),
          f"{label}: kernel Z error {err_true} vs plain {err_true_plain}")
    return dz


def phase_kernel(dev, rng):
    """Phase 2: returns (max|dZ|, kernel ms, plain ms) at the main path's shape."""
    from cwbnwp_letkf_torch.ops import ns_kernel, solver

    worst = 0.0
    times = {}
    for b, k in ((12288, K), (2048, 96)):
        inflat = (k - 1) / 1.1
        a = normal_matrices(rng, b, k, dev)
        worst = max(worst, compare_kernel(a, inflat, f"normal [{b},{k},{k}]"))
        ill = ill_conditioned_matrices(rng, b // 8, k, dev)
        worst = max(worst, compare_kernel(ill, inflat,
                                          f"ill-conditioned [{b // 8},{k},{k}]"))
        ms = median_ms(lambda: ns_kernel.launch(a, inflat))
        plain_ms = median_ms(lambda: solver.ns_invsqrt(a, inflat))
        times[k] = (ms, plain_ms)
        print(f"  [{b},{k},{k}] kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
              f"  (median of 5 warm runs, CUDA events)")
    return worst, times[K][0], times[K][1]


def bench_case(rng, nz):
    """The bench case, built by the port's synthetic generators (numpy)."""
    from cwbnwp_letkf_torch.config import MAX_VARS
    from cwbnwp_letkf_torch.obs.base import PlatformStatic
    from cwbnwp_letkf_torch.obs.synthetic import (correlated_ensemble,
                                                  idealized_grid,
                                                  synthetic_gts_platform)

    pts = idealized_grid(GRID[0], GRID[1], nz, dx_m=DX_M)
    truth, xb = correlated_ensemble(rng, pts, K, n_bumps=8, length_m=1.5e5)
    plats = []
    for name, nobs, nvar, cap, err in PLATFORMS:
        st0, po = synthetic_gts_platform(
            rng, pts, truth, xb, name=name, nobs=nobs, nvar=nvar,
            obs_err=err, max_lz_pts=cap, extent_frac=1.0)
        h, v = [-1.0] * MAX_VARS, [-1.0] * MAX_VARS
        for ivars, radii in PROD_GROUPS:
            for iv in ivars:
                if name in radii:
                    h[iv], v[iv] = radii[name]
        plats.append((PlatformStatic(
            name=name, kind=st0.kind, nvar=nvar, max_lz_pts=cap,
            hclr=tuple(h), vclr=tuple(v), err_muti=st0.err_muti,
            err_rej=st0.err_rej, is_assim=st0.is_assim), po))
    return pts, truth, xb, plats


def cycle_groups():
    from cwbnwp_letkf_torch.ops.cycle import CycleGroup

    return [CycleGroup(ivars=tuple(ivars),
                       inflats=tuple((K - 1) / MULTI_INFL[iv] for iv in ivars),
                       rtpp_alpha=(RTPP,) * len(ivars),
                       rtps_alpha=(RTPS,) * len(ivars))
            for ivars, _ in PROD_GROUPS]


def main_path(xb_v, pts_d, plats, groups, dev):
    """The port's device path, as the driver runs it for one point set."""
    from cwbnwp_letkf_torch.ops import cycle, solver, update

    dplats = [update.prepare_platform(st, po, device=dev) for st, po in plats]
    budgets = cycle.plan_cycle_budgets(pts_d, dplats, groups, chunk=CHUNK,
                                       subchunk=SUBCHUNK)
    t0 = time.time()
    xa, diag = cycle.update_points_cycle(
        xb_v, pts_d, dplats, groups, weight_function=0, chunk=CHUNK,
        subchunk=SUBCHUNK, max_blocks=budgets, return_diagnostics=True)
    torch.cuda.synchronize(dev)
    cycle_s = time.time() - t0
    xa[:, MOIST] = solver.tune_q(xa[:, MOIST])
    return xa, diag, budgets, dplats, cycle_s


def phase_slice(dev, rng, nz):
    """Phase 3: returns what phase 4 needs and the kernel launch count."""
    from cwbnwp_letkf_torch.ops import ns_kernel

    t0 = time.time()
    pts, truth, xb, plats = bench_case(rng, nz)
    b = pts.shape[0]
    print(f"  case: {b} points ({GRID[0]}x{GRID[1]}x{nz}), k={K}, {N_VARS} "
          f"variables in {len(PROD_GROUPS)} groups, records "
          f"{[po.nrec for _, po in plats]}; built on the host in "
          f"{time.time() - t0:.2f} s")
    groups = cycle_groups()
    pts_d = torch.from_numpy(pts).to(dev)
    xb_d = torch.from_numpy(xb).to(dev)
    xb_v = xb_d[:, None, :].expand(b, N_VARS, K)   # one field for all columns

    torch.cuda.synchronize(dev)
    ns_kernel.LAUNCHES = 0
    t0 = time.time()
    xa, diag, budgets, dplats, _ = main_path(xb_v, pts_d, plats, groups, dev)
    torch.cuda.synchronize(dev)
    cold_s = time.time() - t0
    launches = ns_kernel.LAUNCHES
    overflow = int(diag["bucket_overflow"])
    resid = float(diag["ns_residual"])
    print(f"  first run {cold_s:.3f} s: budgets "
          f"{ {n: tuple(bb) for n, bb in budgets.items()} }, overflow "
          f"{overflow}, ns_residual {resid:.3e}, kernel launches {launches}")
    check(tuple(xa.shape) == (b, N_VARS, K), f"xa shape {tuple(xa.shape)}")
    check(bool(torch.isfinite(xa).all()), "analysis not finite")
    check(overflow == 0, f"bucket overflow {overflow}")
    check(resid <= NS_TOL, f"ns_residual {resid} > {NS_TOL}")
    n_chunks = -(-b // CHUNK)
    check(launches >= 2 * n_chunks,
          f"{launches} kernel launches < {2 * n_chunks} (2 per chunk)")
    truth_d = torch.from_numpy(truth).to(dev)
    for col, name in ((0, "U"), (3, "T")):
        rmse_b = float(((xb_d.mean(-1) - truth_d) ** 2).mean().sqrt())
        rmse_a = float(((xa[:, col].mean(-1) - truth_d) ** 2).mean().sqrt())
        print(f"  column {col} ({name}): mean RMSE background {rmse_b:.4f} "
              f"-> analysis {rmse_a:.4f}")
        check(rmse_a < rmse_b, f"column {col}: analysis RMSE not lower")
    del xa

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    xa, diag, _, _, cycle_s = main_path(xb_v, pts_d, plats, groups, dev)
    torch.cuda.synchronize(dev)
    wall = time.time() - t0
    check(bool(torch.isfinite(xa).all()), "warm analysis not finite")
    print(f"  warm run: wall {wall:.3f} s (prepare -> plan -> cycle -> "
          f"tune_q), {b * N_VARS / wall:.1f} var-point updates/s; "
          f"update_points_cycle alone {cycle_s:.3f} s, "
          f"{b * N_VARS / cycle_s:.1f} var-point updates/s; peak device "
          f"memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    return pts_d, dplats, groups, budgets, launches


def phase_real(pts_d, dplats, groups, budgets):
    """Phase 4: the kernel on the real normal matrices of the first chunk."""
    from cwbnwp_letkf_torch.ops import cycle

    plans = cycle._resolve_plans(dplats, groups, max_blocks=budgets)
    perm = cycle._cycle_point_perm(pts_d, plans)
    a, _, cnt, ovf = cycle.accumulate_chunk(
        pts_d[perm[:CHUNK]], plans, groups, k=K, weight_function=0,
        subchunk=SUBCHUNK)
    check(int(ovf) == 0, "overflow in the first chunk")
    worst = 0.0
    for val in sorted({v for grp in groups for v in grp.inflats}):
        members = [gi for gi, grp in enumerate(groups) if val in grp.inflats]
        stack = torch.cat([a[gi] for gi in members])
        with_obs = int(sum((cnt[gi] > 0).sum() for gi in members))
        worst = max(worst, compare_kernel(
            stack, val, f"first chunk, inflat {val:.4f}, {stack.shape[0]} "
                        f"matrices ({with_obs} with obs)"))
    return worst


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print("phase 0: device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi_line = smi.splitlines()[0]
    print(smi_line)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")

    from cwbnwp_letkf_torch.ops import ns_kernel

    print("phase 1: build")
    t0 = time.time()
    lib = ns_kernel.build()
    print(f"  built {lib.name} in {time.time() - t0:.2f} s")
    print("  " + lib.with_suffix(".log").read_text().strip().replace("\n", "\n  "))

    with torch.inference_mode():
        print("phase 2: kernel vs plain")
        err2, ms, plain_ms = phase_kernel(dev, np.random.default_rng(SEED + 1))

        print("phase 3: slice")
        # the bench case's own seed: the same arrays as bench.py:71-112
        pts_d, dplats, groups, budgets, launches = phase_slice(
            dev, np.random.default_rng(SEED), GRID[2])

        print("phase 4: real normal matrices")
        err4 = phase_real(pts_d, dplats, groups, budgets)

    print(json.dumps({"kernels": [{
        "name": "ns_invsqrt", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max(err2, err4), "ms": ms, "plain_ms": plain_ms}]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
