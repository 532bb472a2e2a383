"""Time a Jacobi kernel of ``csrc/jacobi_eigh.cu`` against another revision's
source on one card, each build held bit for bit against the plain version.

    git show <rev>:cwbnwp_letkf_torch/csrc/jacobi_eigh.cu > .proof/jacobi_eigh_parent.cu
    python3 jacobi_ab.py .proof/jacobi_eigh_parent.cu [--kernel parallel|cyclic]
                         [--shapes main|large] [--sass FILE] [--cli] [name=old>>>new ...]

Builds the given source (``base``), the working tree's (``tree``) and each
variant (``tree`` with the text ``old`` replaced by ``new``, written beside
the given source) with one ``cuda_build.build``, and prints the registers and
spills of each build's kernels from its ``.log``.  Then, at the kernel's
``chip_smoke.JACOBI_SHAPES`` (``--shapes large``: ``LARGE_JACOBI_SHAPES``,
k above 96), it times every build on the same ``Y Y^T + (k-1)/1.6 I`` inputs
in the order base, tree, variants, then back (median of 5 warm runs each,
CUDA events), with the share of the bound and of twice the bound: each
product is rounded on its own, so one flop is one instruction and twice the
bound is the issue floor.  With ``--kernel cyclic`` each shape also gets
K4's chain floor: the latency of one link of its chain (the tree's
``jacobi_chain_floor_f32``, one warp running the links alone, median of 5)
times the rotations of a matrix times the waves the tree's launch makes
(``eigh_kernel.config``: matrices an SM).  A build that takes a rotation
log (``jacobi_log_bytes``) gets it as a workspace.  ``--cli`` (with
``--kernel cyclic``) then runs ``chip_smoke.phase_large_cli_k4``, the CLI
at ``nmember = 129`` whose ``--device-breakdown`` eigh stage launches K4,
with each build's K4 in the same order, and prints that stage's ms.
``--sass`` writes
``cuobjdump -sass`` of the tree's build and prints the instruction mix of
each kernel's longest and innermost loops.  Exits 1 if a build differs from
the plain version.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

import chip_smoke
from cwbnwp_letkf_torch.examples import layout_ab
from cwbnwp_letkf_torch.ops import cuda_build, eigh_kernel
from cwbnwp_letkf_torch.ops.jacobi_eigh import jacobi_cyclic, jacobi_parallel


def print_loop_mix(sass: str) -> None:
    """For each kernel in ``cuobjdump -sass`` text, the instruction mix of
    its longest loop (the span of its longest backward branch) and of each
    innermost loop of 32 instructions or more: for K3 the round loop, the
    instructions one warp issues a round; for K4 the rotation loops, one per
    slot of q, the instructions one warp issues a rotation."""
    for func in sass.split("Function : ")[1:]:
        name = func.split()[0]
        ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_]+)[^;]*?"
                         r"(?:0x([0-9a-f]+))?\s*;", func)
        spans = sorted({(int(tgt, 16), int(at, 16)) for at, _, op, tgt in ins
                        if op == "BRA" and tgt and int(tgt, 16) < int(at, 16)})
        if not spans:
            continue
        longest = max(spans, key=lambda span: span[1] - span[0])
        inner = [sp for sp in spans if sp != longest and not any(
            o != sp and sp[0] <= o[0] and o[1] <= sp[1] for o in spans)]
        for label, (lo, hi) in [("longest loop", longest)] + [
                ("inner loop", sp) for sp in inner]:
            ops = [op for at, _, op, _ in ins if lo <= int(at, 16) <= hi]
            if label == "inner loop" and len(ops) < 32:
                continue
            flt = sum(op in ("FMUL", "FADD", "FFMA") for op in ops)
            lds, sts = ops.count("LDS"), ops.count("STS")
            shfl = ops.count("SHFL")
            sync = sum(op in ("WARPSYNC", "BAR") for op in ops)
            print(f"  tree {name[-48:]}: {label} {len(ops)} instructions: "
                  f"float {flt}, LDS {lds}, STS {sts}, SHFL {shfl}, "
                  f"WARPSYNC/BAR {sync}, other "
                  f"{len(ops) - flt - lds - sts - shfl - sync}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base", type=Path, help="the other revision's jacobi_eigh.cu")
    ap.add_argument("variants", nargs="*", help="name=old>>>new")
    ap.add_argument("--kernel", choices=("parallel", "cyclic"), default="parallel")
    ap.add_argument("--shapes", choices=("main", "large"), default="main")
    ap.add_argument("--sass", type=Path, help="write the tree build's SASS here")
    ap.add_argument("--cli", action="store_true",
                    help="with --kernel cyclic: the k = 129 CLI's eigh stage with each build")
    args = ap.parse_intermixed_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())

    sources = {"base": args.base, "tree": eigh_kernel.SOURCE}
    text = eigh_kernel.SOURCE.read_text()
    for spec in args.variants:
        name, sub = spec.split("=", 1)
        old, new = sub.split(">>>")
        if old not in text:
            raise SystemExit(f"{spec}: {old!r} is not in {eigh_kernel.SOURCE}")
        path = args.base.with_name(f"jacobi_eigh_{name}.cu")
        path.write_text(text.replace(old, new))
        sources[name] = path
    libs = dict(zip(sources, cuda_build.build(*sources.values())))
    fns, log_bytes = {}, {}
    for name, lib in libs.items():
        cdll = ctypes.CDLL(str(lib))
        if hasattr(cdll, "jacobi_log_bytes"):
            fns[name] = eigh_kernel.bind(cdll, args.kernel)
            cdll.jacobi_log_bytes.argtypes = [ctypes.c_int] * 2
            cdll.jacobi_log_bytes.restype = ctypes.c_longlong
            log_bytes[name] = cdll.jacobi_log_bytes
        else:   # a revision before the log: (a, lam, v, batch, k, sweeps, stream)
            fns[name] = fn = getattr(cdll, f"jacobi_{args.kernel}_f32")
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for entry, res in cuda_build.resources(lib).items():
            print(f"  {name}: {entry[-48:]}: {res}")
    if args.sass:
        cuobjdump = Path(cuda_build._nvcc()).with_name("cuobjdump")
        sass = subprocess.run([str(cuobjdump), "-sass", str(libs["tree"])],
                              capture_output=True, text=True).stdout
        args.sass.write_text(sass)
        print_loop_mix(sass)

    plain = jacobi_parallel if args.kernel == "parallel" else jacobi_cyclic
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    order = list(fns) + list(reversed(fns))
    ok = True
    shapes = (chip_smoke.JACOBI_SHAPES if args.shapes == "main"
              else chip_smoke.LARGE_JACOBI_SHAPES)
    for b, k in shapes[f"jacobi_{args.kernel}"]:
        a = chip_smoke.normal_matrices(rng, b, k, dev)
        a += (k - 1) / 1.6 * torch.eye(k, device=dev)
        lam_p, v_p = plain(a)
        stream = cuda_build.stream_of(a)
        times = {name: [] for name in fns}
        for name in order:
            lam = torch.empty((b, k), device=dev)
            v = torch.empty_like(a)
            extra = ()
            if name in log_bytes:
                nbytes = b * log_bytes[name](k, 7)
                ws = torch.empty(nbytes, dtype=torch.uint8, device=dev)
                extra = (ws.data_ptr() if nbytes else None, nbytes)

            def run(fn=fns[name], extra=extra):
                rc = fn(a.data_ptr(), lam.data_ptr(), v.data_ptr(), b, k, 7, stream,
                        *extra)
                if rc != 0:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            times[name].append(chip_smoke.median_ms(run))
            if not (torch.equal(lam, lam_p) and torch.equal(v, v_p)):
                ok = False
                print(f"  [{b},{k},{k}] {name}: differs from the plain version: "
                      f"max|dlam| {float((lam - lam_p).abs().max()):.3e}, "
                      f"max|dV| {float((v - v_p).abs().max()):.3e}")
        bound = cuda_build.bound_ms(*eigh_kernel.work(args.kernel, b, k))
        print(f"  [{b},{k},{k}] bound {bound:.4f} ms, issue floor {2 * bound:.4f} ms")
        if args.kernel == "cyclic" and k >= 3:
            floor = layout_ab.chain_floor(a)
            print(f"  [{b},{k},{k}] chain: {floor['link_ns']:.2f} ns a link (one warp "
                  f"alone, median of 5), {floor['matrices_per_sm']} matrices an SM, "
                  f"{floor['waves']} wave(s): chain floor {floor['chain_floor_ms']:.4f} ms")
        for name, ts in times.items():
            print(f"  [{b},{k},{k}] {name}: {' / '.join(f'{t:.4f}' for t in ts)} ms; "
                  f"share of bound {bound / min(ts):.3f}, of the floor "
                  f"{2 * bound / min(ts):.3f}")
    print("all builds equal the plain version" if ok else "A BUILD DIFFERS")
    if args.cli and args.kernel == "cyclic":
        cli_ms = {name: [] for name in fns}
        with tempfile.TemporaryDirectory() as tmp, torch.inference_mode():
            for i, name in enumerate(order):
                fn = fns[name]
                eigh_kernel._fns["cyclic"] = (fn if name in log_bytes
                                              else lambda *a, fn=fn: fn(*a[:7]))
                cli_ms[name].append(chip_smoke.phase_large_cli_k4(Path(tmp) / str(i))[1])
        eigh_kernel._fns.pop("cyclic")
        for name, ms in cli_ms.items():
            print(f"  k=129 CLI's eigh stage with {name}'s K4: "
                  f"{' / '.join(f'{t:.4f}' for t in ms)} ms")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
