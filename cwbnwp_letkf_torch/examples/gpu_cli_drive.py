"""Drive the streaming CLI on the card on a production-shaped WRF case.

    python -m cwbnwp_letkf_torch.examples.gpu_cli_drive [--out PATH]
        [--platform cpu]

The counterpart of the JAX package's ``examples/tpu_cli_drive.py``, on its
case: a 64x64x16 WSM5 domain of k=24 member files, the production-shaped
namelist (the radii and grouping pattern of input.nml:24-55: 10 analysis
variables in 4 radii groups over 6 point sets), 500 synop stations x 5
variables and 30,000 VR radar records (the bucketed path).  It runs
``cli.main(["--stream", "--metrics-json", ...])`` (one variable group
resident, loads overlapped with the previous group's update), checks that
every member file and the mean file were written, that no bucket
overflowed and that every group's residual and time are finite, and prints
the CLI's metrics as one JSON line with ``drive`` added (the device, the
case, the CLI's wall time, the mode); ``--out`` also writes them.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time

import numpy as np

from . import device_label, select_device

K = 24
NX, NY, NZ = 64, 64, 16
N_SYNOP = 500
N_VR = 30_000

#: production-shaped namelist: the input.nml radii/grouping pattern
#: (input.nml:24-55) at WSM5 microphysics (qr, qs)
NML = """
&control
 write_analy_mean = T
 wrf_mp_physics   = 4
 nmember          = {k}
 var_update       = 'U','V','W','T','QVAPOR','QRAIN','QSNOW','MU','P','PH'
 weight_function  = 0
/
&projection
 cen_lon  = 120.0
 cen_lat  = 23.7
 truelat1 = 10.0
 truelat2 = 40.0
 sta_lon  = 120.0
/
&observations
 radar_nml % vr % use_it   = T
 radar_nml % vr % max_lz_pts = 300
 radar_nml % vr % err_rej  = 8.
 radar_nml % vr % error    = 1.
 radar_nml % vr % hclr     = 36., 36., 12., 24., 24.,  8.,  8., 24., 24., 24.
 radar_nml % vr % vclr     =  3.,  3.,  3.,  3.,  3.,  2.,  2., -1., -1., -1.
 synop_nml % use_it        = T
 synop_nml % max_lz_pts    = 100
 synop_nml % hclr          = 50., 50., 50., 50., 50., -1., -1., 50., 50., 50.
 synop_nml % vclr          =  3.,  3.,  3.,  3.,  3., -1., -1., -1., -1., -1.
 synop_nml % u % is_assim  = T, T, T, T, T, F, F, T, T, T
 synop_nml % v % is_assim  = T, T, T, T, T, F, F, T, T, T
 synop_nml % t % is_assim  = T, T, T, T, T, F, F, T, T, T
 synop_nml % p % is_assim  = F, F, F, F, F, F, F, F, F, F
 synop_nml % q % is_assim  = T, T, T, T, T, F, F, T, T, T
/
&inflation
 multi_infl = 1.6, 1.6, 1.6, 1.6, 1.1, 1.1, 1.1, 1.1, 1.1, 1.1
 use_RTPP   = T, T, T, T, T, T, T, T, T, T
 RTPP       = 0.95, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95
 use_RTPS   = T, T, T, T, T, T, T, T, T, T
 RTPS       = 0.95, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95
/
"""


def build_case(d, *, k=K, nx=NX, ny=NY, nz=NZ, n_synop=N_SYNOP, n_vr=N_VR):
    """Write the case's input files into directory ``d`` (the JAX drive's
    files, byte for byte, at the same sizes)."""
    from ..obs.gts import GtsRecords, write_member_file
    from ..obs.radar import write_radar_file
    from .wrf_case import make_wrf_ensemble

    rng = np.random.default_rng(42)
    make_wrf_ensemble(d, k, seed=6, nx=nx, ny=ny, nz=nz, dlat=0.02)
    with open(os.path.join(d, "input.nml"), "w") as fh:
        fh.write(NML.format(k=k))

    # GTS synop: stations in the domain
    base = GtsRecords()
    for i in range(n_synop):
        base.ids.append(f"S{i:04d}")
        base.lat.append(float(rng.uniform(23.1, 24.3)))
        base.lon.append(float(rng.uniform(119.4, 120.6)))
        base.pre.append(1000.0)
        base.obs.append([float(rng.normal(5, 1)), float(rng.normal(-3, 1)),
                         float(rng.normal(301, 1)), 1000.0,
                         float(abs(rng.normal(8e-3, 1e-3)))])
        base.qc.append([0, 0, 0, 0, 0])
        base.err.append([1.0, 1.0, 0.8, 1.0, 1e-3])
        base.level.append(1)
    for m in range(k):
        rec = GtsRecords(
            **{f: list(getattr(base, f))
               for f in ("ids", "lat", "lon", "pre", "obs", "qc", "err",
                         "level")},
            omb=[[float(rng.normal(0, s)) for s in (1, 1, 1, 1, 1e-3)]
                 for _ in range(n_synop)])
        write_member_file(os.path.join(d, f"gts_letkf_{m+1:03d}"),
                          {"synop": rec})

    # VR radar: enough records for the bucketed culling path
    lon = rng.uniform(119.4, 120.6, n_vr)
    lat = rng.uniform(23.1, 24.3, n_vr)
    alt = rng.uniform(0.0, 8e3, n_vr)
    obs = rng.normal(0.0, 5.0, n_vr)
    for m in range(k):
        hd = obs + rng.normal(0, 2.0, n_vr)
        data = np.stack([obs, hd, lon, lat, alt], axis=1)
        write_radar_file(os.path.join(d, f"VR_letkf_{m+1:03d}"), data)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"gpu_cli_drive: {what}")


def main(platform=None, out=None, **sizes) -> dict:
    """Build the case (``sizes``: :func:`build_case`'s keywords), run the
    streaming CLI on ``platform`` (None: the card), check its outputs and
    return its metrics with ``drive`` added; write them to ``out`` if
    given."""
    from ..cli import main as cli_main

    dev = select_device(platform)
    k = sizes.get("k", K)
    with tempfile.TemporaryDirectory(prefix="gpu_cli_drive_") as d:
        t0 = time.time()
        build_case(d, **sizes)
        print(f"[drive] case built ({time.time() - t0:.1f} s)",
              file=sys.stderr, flush=True)
        outdir = os.path.join(d, "out")
        mpath = os.path.join(d, "metrics.json")
        argv = ["--input", d, "--output", outdir, "--stream", "--quiet",
                "--metrics-json", mpath]
        if platform is not None:
            argv += ["--platform", platform]
        t0 = time.time()
        rc = cli_main(argv)
        wall = time.time() - t0
        check(rc == 0, f"the CLI returned {rc}")
        with open(mpath) as fh:
            metrics = json.load(fh)
        for m in range(k):
            p = os.path.join(outdir, f"wrfout_nc_{m+1:03d}")
            check(os.path.exists(p), f"{p} not written")
        check(os.path.exists(os.path.join(outdir, "wrfout_nc_mean")),
              "wrfout_nc_mean not written")
    check(metrics["groups"], "no group ran")
    for g in metrics["groups"]:
        check(g["bucket_overflow"] == 0,
              f"group {g['variables']}: bucket overflow "
              f"{g['bucket_overflow']}")
        check(math.isfinite(g["ns_residual"]) and math.isfinite(g["wall_s"]),
              f"group {g['variables']}: not finite: {g}")

    metrics["drive"] = {
        "device": device_label(dev),
        "case": {"nx": sizes.get("nx", NX), "ny": sizes.get("ny", NY),
                 "nz": sizes.get("nz", NZ), "k": k,
                 "synop_records": sizes.get("n_synop", N_SYNOP),
                 "vr_records": sizes.get("n_vr", N_VR)},
        "cli_wall_s": round(wall, 4),
        "mode": "--stream (one variable group resident; pipelined "
                "load->compute->store)",
    }
    if out:
        with open(out, "w") as fh:
            fh.write(json.dumps(metrics) + "\n")
    return metrics


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gpu_cli_drive")
    ap.add_argument("--platform", default=None,
                    help="'cpu' for the plain versions; default the card")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    print(json.dumps(main(args.platform, args.out)))
    return 0


if __name__ == "__main__":
    sys.exit(cli())
