"""Peak host RSS: eager whole-ensemble ingest against the streaming pipeline.

    python -m cwbnwp_letkf_torch.examples.memory_bench [--nx 96 --ny 96
        --nz 24 --k 16] [--platform cpu] [--out PATH]

The port of the JAX package's ``examples/memory_bench.py``.  The reference
bounds per-rank memory by holding one analysis variable at a time
(module_letkf_core.f90:59-297); the CLI's eager path reads every prognostic
field up front, and ``--stream`` (``models.state.StreamingWrfEnsemble``)
holds one variable group at a time.  This harness writes a synthetic WSM5
ensemble (:mod:`.wrf_case`, 7 analysis variables, 200 synop stations) and
runs the same analysis twice, eager then ``--stream``, each in a fresh
subprocess (``--child``) that prints ``{"mode", "peak_rss_mb"}`` from its
``ru_maxrss`` (with the device and its Newton-Schulz kernel launches).  The
children run on the card unless ``--platform cpu``; the CUDA build of
torch and a CUDA context add host RSS to both modes alike.  Prints one
JSON line: the case, one ensemble field's size in MB, and both children's
lines; ``--out`` also writes it.

Run the harness in a process of its own, as the command above does: on
Linux a child's ``ru_maxrss`` starts from the resident size of the address
space it replaced at ``exec``, its parent's, so children spawned from a
large process read that process's memory, not their own.  The harness
itself holds little (the case is written to disk).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

NML = """
&control
 nmember          = {k}
 var_update       = 'U', 'V', 'T', 'QVAPOR', 'P', 'PH', 'MU'
 weight_function  = 0
 wrf_mp_physics   = 4
/
&projection
 cen_lon  = 120.0
 cen_lat  = 23.7
 truelat1 = 10.0
 truelat2 = 40.0
 sta_lon  = 120.0
/
&observations
 synop_nml % use_it     = T
 synop_nml % max_lz_pts = 50
 synop_nml % hclr       = 30., 30., 30., 30., 30., 30., 30.
 synop_nml % vclr       =  3.,  3.,  3.,  3., -1., -1., -1.
 synop_nml % u % is_assim = T, T, F, F, F, F, F
 synop_nml % t % is_assim = F, F, T, F, T, T, T
 synop_nml % q % is_assim = F, F, F, T, F, F, F
/
&inflation
 multi_infl = 1.2, 1.2, 1.2, 1.1, 1.2, 1.2, 1.2
 use_RTPS   = F, F, F, F, F, F, F
 use_RTPP   = F, F, F, F, F, F, F
/
"""

#: the directory that holds the package, for the children's imports
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_case(workdir, nx, ny, nz, k):
    """Write the members, the namelist and the GTS files into ``workdir``
    (the JAX harness's files, byte for byte)."""
    import numpy as np

    from ..obs.gts import GtsRecords, write_member_file
    from .wrf_case import make_wrf_ensemble

    make_wrf_ensemble(workdir, k, seed=1, nx=nx, ny=ny, nz=nz)
    with open(os.path.join(workdir, "input.nml"), "w") as fh:
        fh.write(NML.format(k=k))
    rng = np.random.default_rng(5)
    nobs = 200
    base = GtsRecords()
    for i in range(nobs):
        base.ids.append(f"S{i:04d}")
        base.lat.append(float(rng.uniform(23.5, 23.9)))
        base.lon.append(float(rng.uniform(119.8, 120.2)))
        base.pre.append(1000.0)
        base.obs.append([float(rng.normal(5, 1)), float(rng.normal(-3, 1)),
                         float(rng.normal(301, 1)), 1000.0,
                         float(abs(rng.normal(8e-3, 1e-3)))])
        base.qc.append([0] * 5)
        base.err.append([1.0, 1.0, 0.8, 1.0, 1e-3])
        base.level.append(1)
    for m in range(k):
        rec = GtsRecords(
            **{f: list(getattr(base, f))
               for f in ("ids", "lat", "lon", "pre", "obs", "qc", "err",
                         "level")},
            omb=[[float(rng.normal(0, s)) for s in (1, 1, 1, 1, 1e-3)]
                 for _ in range(nobs)])
        write_member_file(os.path.join(workdir, f"gts_letkf_{m+1:03d}"),
                          {"synop": rec})


def run_child(mode, workdir, outdir, platform=None):
    """One analysis in ``mode``; prints its own peak RSS as JSON."""
    import resource

    from ..cli import main as cli_main
    from ..ops import ns_kernel
    from . import device_label, select_device

    dev = select_device(platform)
    args = ["--input", workdir, "--output", outdir, "--quiet",
            "--no-mesh", "--chunk", "4096"]
    if platform is not None:
        args += ["--platform", platform]
    if mode == "stream":
        args.append("--stream")
    if cli_main(args) != 0:
        raise RuntimeError(f"memory_bench: the {mode} CLI run failed")
    peak_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    print(json.dumps({"mode": mode, "peak_rss_mb": round(peak_kb / 1024.0),
                      "device": device_label(dev),
                      "k1_launches": ns_kernel.LAUNCHES["trio"]}))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="memory_bench")
    ap.add_argument("--nx", type=int, default=96)
    ap.add_argument("--ny", type=int, default=96)
    ap.add_argument("--nz", type=int, default=24)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--platform", default=None,
                    help="'cpu' for the plain versions; default the card")
    ap.add_argument("--child", choices=("eager", "stream"), default=None)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--outdir", default=None)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)

    if args.child:
        run_child(args.child, args.workdir, args.outdir, args.platform)
        return {}

    from . import select_device

    select_device(args.platform)      # refuse before writing anything
    field_mb = args.nx * args.ny * args.nz * args.k * 4 / 2**20
    print(f"case: {args.nx}x{args.ny}x{args.nz} k={args.k} "
          f"(one ensemble field = {field_mb:.0f} MB)", file=sys.stderr)
    runs = []
    with tempfile.TemporaryDirectory(prefix="memory_bench_") as tmp:
        workdir = os.path.join(tmp, "input")
        os.makedirs(workdir)
        build_case(workdir, args.nx, args.ny, args.nz, args.k)
        for mode in ("eager", "stream"):
            outdir = os.path.join(tmp, f"out_{mode}")
            cmd = [sys.executable, "-m", __spec__.name, "--child", mode,
                   "--workdir", workdir, "--outdir", outdir]
            if args.platform is not None:
                cmd += ["--platform", args.platform]
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 cwd=ROOT)
            if out.returncode != 0:
                raise RuntimeError(f"memory_bench: the {mode} child exited "
                                   f"{out.returncode}:\n{out.stderr[-4000:]}")
            runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
            print(json.dumps(runs[-1]), file=sys.stderr, flush=True)
    result = {"case": {"nx": args.nx, "ny": args.ny, "nz": args.nz,
                       "k": args.k},
              "field_mb": round(field_mb, 3), "runs": runs}
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
