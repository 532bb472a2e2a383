"""Run one cell of the benchmark of ``cwbnwp_letkf_torch``.

    python3 -m letkf_bench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout, on a machine with the cell's CUDA cards.  The
cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``letkf_bench/configs/``), a traffic mix (``letkf_bench/traffic/``, which
names its entry in ``letkf_bench/entries/``), and its sample and limits
(``letkf_bench/cells/<cell>.json``); each metric is read by
``letkf_bench/metrics/<metric>.py``.  A run builds the inputs from the
seed, warms the path up with one whole step, runs whole steps for the
window, holds every step's answers at points drawn from the seed against
the plain float64 reference (``letkf_bench/reference/``), and prints one
JSON line last: the end-to-end metrics with ``--trace 0``, the per-layer
ones, read from ``torch.profiler``, with ``--trace 1``.
"""
from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level modules the timed process must never hold: the JAX package
#: and JAX, compared by their whole top-level names
FORBIDDEN = ("jax", "jaxlib", "flax", "cwbnwp_letkf_tpu")


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def resolve(workload: str) -> types.SimpleNamespace:
    """Everything a cell is made of, found by the names in BENCHMARK.json."""
    bench = load_json(ROOT / "BENCHMARK.json")
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    traffic = load_json(HERE / "traffic" / f"{wl['traffic']}.json")

    def mine(m):
        return workload in m.get("workloads", [workload])

    return types.SimpleNamespace(
        workload=wl, cfg=load_json(ROOT / conf["file"]), traffic=traffic,
        cell=load_json(HERE / "cells" / f"{workload}.json"),
        entry=importlib.import_module(f"letkf_bench.entries.{traffic['entry']}"),
        end_to_end=[m for m in bench["end_to_end"] if mine(m)],
        per_layer=[m for m in bench["per_layer"] if mine(m)])


def reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"letkf_bench.metrics.{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card() -> dict:
    """The card's name and the power limit nvidia-smi reads, or stop."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this benchmark measures the card")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as err:
        smi = [f"nvidia-smi: {err}"]
    return dict(kind=torch.cuda.get_device_name(0),
                count=torch.cuda.device_count(), smi=smi[0] if smi else "")


def window(parts, case, seconds: float, trace: bool) -> list:
    """Whole steps, back to back, while the next is expected to end inside
    ``seconds``; at least one.  Each step is timed alone; putting the
    background back and reading the answers are not part of it."""
    import torch

    from letkf_bench import trace as tr

    steps, other = [], 0.0
    record = (lambda: torch.profiler.record_function(tr.STEP)) if trace else None
    i = 0
    while True:
        t0 = time.perf_counter()
        parts.entry.before_step(case, i)
        t1 = time.perf_counter()
        if record:
            with record():
                n = parts.entry.step(case, i)
        else:
            n = parts.entry.step(case, i)
        t2 = time.perf_counter()
        parts.entry.after_step(case, i)
        other += (t1 - t0) + (time.perf_counter() - t2)
        steps.append((t2 - t1, n))
        i += 1
        spent = sum(s for s, _ in steps)
        if spent + spent / len(steps) > seconds:
            break
    print(f"window: {len(steps)} steps of {[round(s, 4) for s, _ in steps]} "
          f"s; {other:.3f} s of benchmark work between them (restoring the "
          f"background, reading the answers), not in the steps' time",
          flush=True)
    return steps


def run(parts, seed: int, seconds: float, trace: bool, device,
        on_card: bool = True) -> dict:
    """One run of a cell on ``device``; returns the result line's fields.
    ``on_card`` False runs the same path on the CPU (tests): no card is
    looked for and nothing on a card is read."""
    import torch

    from letkf_bench import trace as tr

    info = card() if on_card else dict(kind="cpu", count=0, smi="")
    if on_card and info["count"] < parts.workload["chips"]:
        raise SystemExit(f"{info['count']} CUDA devices; the cell needs "
                         f"{parts.workload['chips']}")
    print(f"device: {info['kind']} x {info['count']}; nvidia-smi name, power "
          f"limit: {info['smi']}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    # one process with few threads: the host's part of a step is launches
    # from one thread, and a steady run wants no more of the machine's cores
    torch.set_num_threads(min(4, torch.get_num_threads()))
    ctx = types.SimpleNamespace(data={}, trace=None)
    case = parts.entry.build(parts.cfg, parts.traffic, parts.cell, seed, device)
    t_built = time.perf_counter()
    parts.entry.before_step(case, -1)
    t0 = time.perf_counter()
    parts.entry.step(case, -1)
    warm = time.perf_counter() - t0
    ctx.setup_s = time.perf_counter() - START
    print(f"setup: {ctx.setup_s:.3f} s from process start (inputs built "
          f"at {t_built - START:.3f} s; warm-up step {warm:.3f} s)", flush=True)
    for key in list(case.counters):
        case.counters[key] = 0.0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    readers = {m["name"]: reader(m["name"])
               for m in (parts.per_layer if trace else parts.end_to_end)}
    if trace:
        # the window's first step once untraced: what tracing costs a step
        parts.entry.before_step(case, 0)
        t0 = time.perf_counter()
        parts.entry.step(case, 0)
        pace = time.perf_counter() - t0
        for key in list(case.counters):
            case.counters[key] = 0.0
        spans = parts.entry.spans(case)
        patches = [(owner, attr, tr.wrapped(getattr(owner, attr), name))
                   for owner, attr, name in spans]
        for mod in readers.values():
            patches += mod.install(ctx) if hasattr(mod, "install") else []
        with tr.patched(patches), tr.profiler() as prof:
            ctx.steps = window(parts, case, seconds, True)
        t0 = time.perf_counter()
        ctx.trace = tr.summarize(prof.events, [n for _, _, n in spans] + [
            mod.SPAN for mod in readers.values() if hasattr(mod, "SPAN")])
        del prof
        print(f"trace: {ctx.trace.n_device_events} device events "
              f"({ctx.trace.n_unattributed} with no launching span), busy "
              f"{ctx.trace.busy_s:.4f} of {ctx.trace.window_s:.4f} s; the "
              f"first step {ctx.steps[0][0]:.4f} s traced, {pace:.4f} s "
              f"untraced (ratio {ctx.steps[0][0] / pace:.4f}); read in "
              f"{time.perf_counter() - t0:.1f} s; device seconds by span "
              f"{ctx.trace.span_device_s}", flush=True)
    else:
        ctx.steps = window(parts, case, seconds, False)
    ctx.peak_bytes = torch.cuda.max_memory_allocated(device) if on_card else 0
    ctx.counters = dict(case.counters)
    metrics = {}
    for m in (parts.per_layer if trace else parts.end_to_end):
        value = readers[m["name"]].read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    parts.entry.free(case)
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = parts.entry.check(case, parts.cell)
    print(f"reference: {time.perf_counter() - t0:.3f} s", flush=True)
    limits = parts.cell["limits"]
    compared, failed = {}, 0
    for name, values in numbers.items():
        worst = max(values)
        compared[name] = {"value": worst, "limit": limits[name]}
        print(f"{name} per step: {values}", flush=True)
        failed = max(failed, sum(not (v <= limits[name]) for v in values))
    out = {"correct": failed == 0 and bool(numbers),
           "attempted": len(ctx.steps), "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if on_card else "cpu",
                      "kind": info["kind"], "count": parts.workload["chips"],
                      "memory_peak_bytes": ctx.peak_bytes}}
    if trace:
        t = ctx.trace
        out["device"].update(busy_s=t.busy_s, window_s=t.window_s)
        out["breakdown"] = {
            "device_ops": sorted(([n[:120], s] for n, s in t.kernel_s.items()),
                                 key=lambda x: -x[1])[:10],
            "idle_gaps": sorted(([n, s] for n, s in t.idle_s.items()),
                                key=lambda x: -x[1])[:10]}
    out["compared"] = compared
    return out


def check_modules() -> None:
    """Stop, printing no result, if the process holds JAX or the JAX
    package."""
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"the timed process holds {found}: the benchmark measures "
              f"cwbnwp_letkf_torch without JAX or the JAX package",
              file=sys.stderr)
        raise SystemExit(3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # caches a library might write go inside the checkout, at fixed paths
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    parts = resolve(args.workload)
    import torch

    out = run(parts, args.seed, args.seconds, bool(args.trace),
              torch.device("cuda", 0))
    check_modules()
    for name, c in out["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
