"""End-to-end synthetic cycle: generate inputs, run the CLI, score vs truth.

    python -m cwbnwp_letkf_torch.examples.run_synthetic_cycle [workdir]
        [--platform cpu]

The port of the JAX package's ``examples/run_synthetic_cycle.py``.  Writes
a complete synthetic input directory (:func:`..synthetic_case.generate_case`:
8 WRF members of 24x20x6, a namelist and GTS omboma files of 40 stations
around a known truth), runs ``cli.main`` on it with ``--chunk 512`` (on the
card unless ``--platform cpu``), and scores the analysis-mean T against the
truth: its RMSE must fall below the prior mean's, or the drive raises.
Prints one JSON line with both RMSEs.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile

from . import select_device


def main(workdir=None, platform=None) -> dict:
    """Run the cycle in ``workdir`` (a new temporary directory if None) on
    ``platform`` (None: the card); returns the scores."""
    from ..cli import main as cli_main
    from ..synthetic_case import generate_case, score_case

    select_device(platform)
    workdir = workdir or tempfile.mkdtemp(prefix="letkf_case_")
    input_dir = f"{workdir}/input"
    output_dir = f"{workdir}/output"

    case = generate_case(input_dir, k=8, nx=24, ny=20, nz=6, n_obs=40)
    argv = ["--input", input_dir, "--output", output_dir, "--chunk", "512",
            "--quiet"]
    if platform is not None:
        argv += ["--platform", platform]
    if cli_main(argv) != 0:
        raise RuntimeError("run_synthetic_cycle: the CLI failed")

    scores = score_case(case, output_dir)
    print(f"prior-mean RMSE vs truth:    {scores['rmse_prior']:.3f} K\n"
          f"analysis-mean RMSE vs truth: {scores['rmse_analysis']:.3f} K",
          file=sys.stderr, flush=True)
    if not scores["rmse_analysis"] < scores["rmse_prior"]:
        raise RuntimeError("run_synthetic_cycle: the analysis did not "
                           "improve on the prior")
    return scores


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="run_synthetic_cycle")
    ap.add_argument("workdir", nargs="?", default=None)
    ap.add_argument("--platform", default=None,
                    help="'cpu' for the plain versions; default the card")
    args = ap.parse_args(argv)
    print(json.dumps(main(args.workdir, args.platform)))
    return 0


if __name__ == "__main__":
    sys.exit(cli())
