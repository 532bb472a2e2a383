"""The readings a cell's limits are set from, in one process.

    python3 -m letkf_bench.calibrate --workload NAME --seeds N [N ...]
        [--control-seeds N [N ...]] [--out FILE]

For each seed: the cell's inputs, one step through the cell's own entry at
its own size, and the comparison that decides ``correct``: the lower
reading is the largest number over the seeds.  For each control seed the
same in the cell's control, the lower precision a faster build would be
tempted by (:func:`reading`): the upper reading is the smallest.  The
benchmark's own runs never run this.  One JSON line a seed, on standard
output and appended to ``--out``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from letkf_bench import run as harness


@contextlib.contextmanager
def tf32():
    """The program's float32 matrix products in TF32 for the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def reading(parts, seed: int, device, control: bool = False) -> dict:
    """The compared numbers of one step of the cell on ``seed``; with
    ``control``, of the cell's control (``"control"`` in its cell file):
    ``"program_tf32"``, the program with its float32 products in TF32, or
    ``"reference_tf32"``, the reference in the program's place in TF32, for
    a program whose products never take TF32 at these shapes."""
    entry = parts.entry
    kind = parts.cell["control"] if control else None
    t0 = time.perf_counter()
    case = entry.build(parts.cfg, parts.traffic, parts.cell, seed, device)
    with tf32() if kind == "program_tf32" else contextlib.nullcontext():
        entry.before_step(case, 0)
        entry.step(case, 0)
    entry.after_step(case, 0)
    entry.free(case)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = entry.check(case, parts.cell, control=kind == "reference_tf32")
    del case
    return {"seed": seed, "control": kind, **numbers,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    parts = harness.resolve(args.workload)
    info = harness.card()
    print(f"device: {info['kind']} x {info['count']}; {info['smi']}",
          flush=True)
    device = torch.device("cuda", 0)
    rows = []
    for seed, control in ([(s, False) for s in args.seeds]
                          + [(s, True) for s in args.control_seeds]):
        rows.append(reading(parts, seed, device, control))
        line = json.dumps({"workload": args.workload, **rows[-1]})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
    for name in parts.cell["limits"]:
        lower = max(max(r[name]) for r in rows if not r["control"])
        upper = [min(r[name]) for r in rows if r["control"]]
        print(f"{name}: lower reading {lower!r} over {len(args.seeds)} seeds; "
              f"upper reading {min(upper) if upper else None!r} over "
              f"{len(upper)} control seeds", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
