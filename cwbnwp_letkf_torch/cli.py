"""Command-line driver: the reference's ``cwb_letkf.f90`` pipeline, on a card.

    python -m cwbnwp_letkf_torch.cli --input DIR --output DIR

Port of the JAX package's ``cli.py``, with its options, its defaults and its
file conventions (cwb_letkf.f90:26,42,49-51,70,76).  The defaults of
``--input`` and ``--output`` are the reference's ``../input`` and
``../output``, relative to the working directory, so a caller run from a
checkout passes both, as the tests and ``chip_smoke.py`` do:

    <input>/input.nml              namelist config
    <input>/wrfinput_nc_###        prior members (3-digit, 1-based)
    <input>/gts_letkf_###          per-member GTS omboma files
    <input>/obs_gts                station-altitude ASCII (optional)
    <input>/VR_letkf_### MR_letkf_###   radar radial-velocity/reflectivity
    <output>/wrfout_nc_###         analysis members
    <output>/wrfout_nc_mean        analysis mean (write_analy_mean)

The reference's main wires only VR and MR radar files (cwb_letkf.f90:50-51)
even though the radar module supports zdr/kdp; ``--all-radar`` additionally
reads MD/MK files (framework extension).

The analysis runs on the CUDA card.  ``--platform cpu`` runs it on the CPU
through the kernels' plain versions, which is for tests; without a card and
without ``--platform cpu`` the CLI raises before it reads any file.  With
more than one visible card and no ``--no-mesh`` the points are sharded over
an in-process mesh of those cards, whose shards run in turn.
``--device-breakdown`` adds the per-stage device seconds of a sample batch
to the run metrics (``device_breakdown`` in ``--metrics-json``).

``--distributed`` runs one process per card under ``torch.distributed``
(NCCL on cards, gloo with ``--platform cpu``), from torchrun's environment
or from ``--coordinator``, ``--num-processes`` and ``--process-id``:

    torchrun --nproc-per-node 8 -m cwbnwp_letkf_torch.cli --distributed \
        --input DIR --output DIR

Each process reads and writes only its member block, the fields cross
between the member and point layouts by two ``all_to_all`` transposes, and
process 0 writes the mean and the metrics after a barrier (the reference's
multi-rank main, cwb_letkf.f90:20-81).  The input and output directories
must be shared by every process.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import os
import sys
from typing import Dict

import torch
import torch.distributed as dist

#: ``--platform`` values that select the card; None (no flag) does too
CUDA_PLATFORMS = ("gpu", "cuda")


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cwbnwp-letkf-torch",
        description="LETKF analysis for WRF ensembles on a CUDA card")
    p.add_argument("--input", default="../input", help="input directory")
    p.add_argument("--output", default="../output", help="output directory")
    p.add_argument("--namelist", default=None,
                   help="namelist path (default <input>/input.nml)")
    p.add_argument("--all-radar", action="store_true",
                   help="also read MD/MK (zdr/kdp) radar files")
    p.add_argument("--chunk", type=int, default=4096,
                   help="analysis points per device batch")
    p.add_argument("--no-mesh", action="store_true",
                   help="single-device update (skip sharding)")
    p.add_argument("--stream", action="store_true",
                   help="memory-bounded mode: hold one variable group in "
                        "host RAM at a time (the reference's "
                        "one-variable-resident pipeline, "
                        "module_letkf_core.f90:59-297); fields stream from "
                        "the prior files and analysis writes happen per "
                        "group instead of all-at-once")
    p.add_argument("--platform", default=None,
                   help="the device: 'gpu' or 'cuda' (the card, also the "
                        "default) or 'cpu' (the kernels' plain versions, "
                        "for tests)")
    p.add_argument("--distributed", action="store_true",
                   help="one process per card under torch.distributed "
                        "(NCCL; gloo with --platform cpu): member-block "
                        "ingest per process, point-sharded update, "
                        "per-process member write-back (the reference's "
                        "multi-rank main, cwb_letkf.f90:20-81; rank->member "
                        "binding :39-52).  Implies --stream (one group "
                        "resident); needs a shared filesystem.  The rank, "
                        "world size and address come from torchrun's "
                        "environment or the flags below")
    p.add_argument("--coordinator", default=None,
                   help="rank 0's address host:port (distributed)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--metrics-json", default=None,
                   help="write run metrics as one JSON line to this path")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the update into "
                        "this directory: the program's spans and the "
                        "device alone (tracing.maybe_trace; a Chrome "
                        "trace: Perfetto), and its counters beside it "
                        "(counters_<pid>_<ms>.json)")
    p.add_argument("--device-breakdown", action="store_true",
                   help="per-stage device time on a sample batch "
                        "(metrics key device_breakdown)")
    return p


def distributed_settings(args: argparse.Namespace) -> tuple:
    """``(init_method, rank, world_size, local_rank)`` of ``--distributed``:
    from ``--coordinator``, ``--num-processes`` and ``--process-id``, else
    from torchrun's environment; raises if neither is complete."""
    env = os.environ
    if args.coordinator:
        if args.num_processes is None or args.process_id is None:
            raise ValueError("--coordinator needs --num-processes and "
                             "--process-id")
        rank = args.process_id
        return (f"tcp://{args.coordinator}", rank, args.num_processes,
                int(env.get("LOCAL_RANK", rank)))
    if all(key in env for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                  "MASTER_PORT")):
        rank = int(env["RANK"])
        return ("env://", rank, int(env["WORLD_SIZE"]),
                int(env.get("LOCAL_RANK", rank)))
    raise ValueError("--distributed needs torchrun's environment (RANK, "
                     "WORLD_SIZE, MASTER_ADDR, MASTER_PORT) or --coordinator "
                     "HOST:PORT with --num-processes and --process-id")


def select_device(args: argparse.Namespace) -> torch.device:
    """The device ``args`` asks for; raises for what the port cannot run.

    Called before any file is read, so a refused run reads nothing.  Under
    ``--distributed`` it binds this process's card (``LOCAL_RANK``, or the
    process id, modulo the visible cards) before the process group starts.
    """
    settings = distributed_settings(args) if args.distributed else None
    if args.platform == "cpu":
        return torch.device("cpu")
    if args.platform is not None and args.platform not in CUDA_PLATFORMS:
        raise ValueError(f"--platform must be 'cpu', 'gpu' or 'cuda', got "
                         f"{args.platform!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the analysis runs on the card; "
                           "pass --platform cpu to run the plain versions "
                           "on the CPU (for tests)")
    if settings is None:
        return torch.device("cuda")
    device = torch.device("cuda", settings[3] % torch.cuda.device_count())
    torch.cuda.set_device(device)
    return device


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    device = select_device(args)
    if not args.distributed:
        return _run(args, device, None)
    init_method, rank, world, _ = distributed_settings(args)
    # NCCL on the cards, gloo on the CPU; never one for the other
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method, rank=rank,
                            world_size=world)
    try:
        from .parallel import make_mesh

        return _run(args, device, make_mesh())
    finally:
        dist.destroy_process_group()


def _run(args: argparse.Namespace, device: torch.device, mesh) -> int:
    from .config import LetkfConfig
    from .driver import StageTimer, run_analysis
    from .metrics import RunMetrics
    from .models.state import (StreamingWrfEnsemble, read_ensemble,
                               write_ensemble, write_mean)
    from .obs.gts import parse_obs_gts, read_gts_ensemble
    from .obs.radar import PREFIX_TO_NAME, read_radar_ensemble
    from .parallel import make_mesh
    from .parallel.multihost import member_block
    from .projection import LambertProjection
    from .tracing import maybe_trace

    timer = StageTimer(enabled=not args.quiet)
    metrics = RunMetrics()
    timer.stamp("reading namelist")
    nml = args.namelist or os.path.join(args.input, "input.nml")
    cfg = LetkfConfig.from_namelist(nml)
    k = cfg.nmember
    proj = LambertProjection.from_config(cfg.projection)

    def member(stem, m):
        return os.path.join(args.input, f"{stem}_{m+1:03d}")

    timer.stamp("reading model data")
    wrf_paths = [member("wrfinput_nc", m) for m in range(k)]
    out_paths = [os.path.join(args.output, f"wrfout_nc_{m+1:03d}")
                 for m in range(k)]
    if args.distributed:
        # member-block ingest: this process reads and writes only its
        # members (cwb_letkf.f90:39-52), streaming one group at a time
        os.makedirs(args.output, exist_ok=True)
        ens = StreamingWrfEnsemble(wrf_paths, cfg, out_paths,
                                   members=member_block(k, mesh))
    elif args.stream:
        os.makedirs(args.output, exist_ok=True)
        ens = StreamingWrfEnsemble(wrf_paths, cfg, out_paths)
    else:
        ens = read_ensemble(wrf_paths, cfg)

    timer.stamp("read obs data")
    obs_data: Dict[str, object] = {}
    gts_paths = [member("gts_letkf", m) for m in range(k)]
    if all(os.path.exists(p) for p in gts_paths):
        alt_path = os.path.join(args.input, "obs_gts")
        if os.path.exists(alt_path):
            alt = parse_obs_gts(alt_path)
        else:
            # the reference cannot run without obs_gts (it open()s it
            # unconditionally, gts_omboma.f90:726); we allow it for
            # synthetic cases but say so — altitudes become 0
            alt = None
            print(f"WARNING: no {alt_path}; station altitudes set to 0 "
                  "(vertical localization of GTS obs is then surface-"
                  "relative only)", file=sys.stderr)
        obs_data.update(read_gts_ensemble(gts_paths, proj, alt))
    prefixes = ("VR", "MR") + (("MD", "MK") if args.all_radar else ())
    for prefix in prefixes:
        paths = [member(f"{prefix}_letkf", m) for m in range(k)]
        if all(os.path.exists(p) for p in paths):
            po = read_radar_ensemble(paths, proj)
            if po is not None:
                obs_data[PREFIX_TO_NAME[prefix]] = po

    timer.stamp("get into letkf core")
    if (mesh is None and not args.no_mesh and device.type == "cuda"
            and torch.cuda.device_count() > 1):
        mesh = make_mesh()
    with maybe_trace(args.profile_dir):
        run_analysis(cfg, ens, obs_data, mesh=mesh, chunk=args.chunk,
                     timer=timer, metrics=metrics,
                     device_breakdown=args.device_breakdown,
                     distributed=args.distributed, device=device)
    timer.stamp("finish letkf core")

    os.makedirs(args.output, exist_ok=True)
    metrics_json = args.metrics_json
    if args.distributed:
        # every process's sinks are complete; the mean needs all of them
        # (shared filesystem): barrier, then process 0 writes it (the
        # reference's write_mean on one rank, cwb_letkf.f90:68-71)
        dist.barrier()
        if mesh.rank != 0:
            metrics_json = None         # one metrics file per run
        elif cfg.write_analy_mean:
            timer.stamp("write analysis mean")
            ens.write_mean(os.path.join(args.output, "wrfout_nc_mean"))
    elif args.stream:
        # member analyses were written per group during the cycle; only the
        # optional mean file remains (read back from the sinks, one field
        # resident at a time)
        if cfg.write_analy_mean:
            timer.stamp("write analysis mean")
            ens.write_mean(os.path.join(args.output, "wrfout_nc_mean"))
    else:
        with cf.ThreadPoolExecutor(max_workers=1) as ex:
            mean_job = None
            if cfg.write_analy_mean:
                # overlap the mean write with the member writes — the
                # reference runs them concurrently on disjoint ranks
                # (cwb_letkf.f90:68-77: mean on rank nproc-1 while ranks
                # 0..k-1 write members); each thread writes its own files
                timer.stamp("write analysis mean (async)")
                mean_job = ex.submit(
                    write_mean, ens,
                    os.path.join(args.output, "wrfout_nc_mean"))

            timer.stamp("write analysis ensemble")
            write_ensemble(ens, out_paths)
            if mean_job is not None:
                mean_job.result()
    timer.stamp("finish all steps")
    if metrics_json:
        with open(metrics_json, "w") as fh:
            fh.write(metrics.to_json() + "\n")
    elif not args.quiet:
        print("metrics:", metrics.to_json())
    return 0


if __name__ == "__main__":
    sys.exit(main())
