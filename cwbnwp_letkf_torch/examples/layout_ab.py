"""Time a kernel's layout against one alternative on one card, bit for bit.

    python -m cwbnwp_letkf_torch.examples.layout_ab [--out PATH]

Each alternative is built from the kernel's own source by one textual
substitution (:data:`VARIANTS`), so the two libraries share every other
line; a substitution that no longer matches the source raises.

- ``jacobi_v_consumers``: K4 (``csrc/jacobi_eigh.cu``) above k = 96 with
  consumer warps in the chain's block that make V from the rotation log as
  the chain writes it, their rows of V in shared memory after A, where
  they fit one block (through k = 159), in place of the V pass launched
  after the chain.  Timed at ``[256, 129, 129]`` and ``[128, 159, 159]``,
  seven sweeps, each case with K4's chain floor beside it
  (:func:`chain_floor`).  (K3 keeps V in registers at every k above 96.)
- ``jacobi_one_warp``: K4's chain above k = 96 on one warp a matrix
  (``ceil(k / 32)`` indices a lane, ``__syncwarp`` and shuffles) instead
  of two (a named barrier among the 64 lanes and an exchange in shared
  memory behind a second one).  Timed at ``[256, 129, 129]`` and ``[64,
  177, 177]``, seven sweeps, with the chain floor.
- ``jacobi_two_barriers``: K3 above k = 96 with every warp waiting on the
  barrier that only the warps computing the next round's rotations wait on
  in the source, where the others only arrive: two full barriers a round
  instead of one.  Timed at ``[1024, 128, 128]``, ``[512, 160, 160]`` and
  ``[256, 176, 176]``, seven sweeps.
- ``ns_k128_const``: K1/K2 (``csrc/ns_invsqrt.cu``) with the tile counts of
  k = 128 as template constants, as k = 40 and 96 have them.  The source
  reads them at run time above 96.  Timed at ``[2048, 128, 128]``, at most
  five steps.

Inputs are seeded symmetric positive definite matrices.  Each case runs
source, alternative, alternative, source, each a median of 5 warm runs by
CUDA events, and holds the two outputs equal bit for bit.  Prints the
card's name and power limit, then one JSON line a case; ``--out`` also
writes them as one JSON object.  Needs a card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..ops import cuda_build, eigh_kernel
from . import select_device

#: name -> (source, text in it, its replacement)
VARIANTS = {
    "jacobi_v_consumers": (
        "jacobi_eigh.cu",
        "constexpr bool kVConsumers = false;\n",
        "constexpr bool kVConsumers = true;\n"),
    "jacobi_one_warp": (
        "jacobi_eigh.cu",
        "constexpr int kChainWarps = 2;\n",
        "constexpr int kChainWarps = 1;\n"),
    "jacobi_two_barriers": (
        "jacobi_eigh.cu",
        "      bar_arrive(1, threads);\n",
        "      bar_sync(1, threads);\n"),
    "ns_k128_const": (
        "ns_invsqrt.cu",
        "  } else if (k > kMidK) {\n",
        "  } else if (k == 128) {\n"
        "    pl.kernel = rmul ? ns_invsqrt_kernel<8, true, 16, 32, kT128>\n"
        "                     : ns_invsqrt_kernel<8, false, 16, 32, kT128>;\n"
        "  } else if (k > kMidK) {\n"),
}

#: Jacobi variant -> its cases (kernel, batch, k)
JACOBI_CASES = {
    "jacobi_v_consumers": (("cyclic", 256, 129), ("cyclic", 128, 159)),
    "jacobi_one_warp": (("cyclic", 256, 129), ("cyclic", 64, 177)),
    "jacobi_two_barriers": (("parallel", 1024, 128), ("parallel", 512, 160),
                            ("parallel", 256, 176)),
}
NS_CASE = (2048, 128)
SWEEPS = 7
NS_STEPS = 5
SEED = 0


def variant_source(name: str) -> str:
    """The text of variant ``name``: its source with the one substitution
    made.  Raises ``ValueError`` unless the text occurs exactly once."""
    src, old, new = VARIANTS[name]
    text = (cuda_build.CSRC / src).read_text()
    if text.count(old) != 1:
        raise ValueError(f"{name}: the text to replace occurs "
                         f"{text.count(old)} times in {src}")
    return text.replace(old, new)


def build_pairs() -> dict:
    """``{variant: (source library, variant library)}``, all built at once
    (each source once)."""
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, (src, _, _) in VARIANTS.items():
        alt = cuda_build.BUILD_DIR / f"{Path(src).stem}_{name}.cu"
        alt.write_text(variant_source(name))
        paths.setdefault(src, cuda_build.CSRC / src)
        paths[name] = alt
    libs = dict(zip(paths, (ctypes.CDLL(str(p))
                            for p in cuda_build.build(*paths.values()))))
    return {name: (libs[src], libs[name])
            for name, (src, _, _) in VARIANTS.items()}


def median_ms(fn, reps: int = 5) -> float:
    for _ in range(2):
        fn()
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


def chain_floor(a: torch.Tensor, sweeps: int = SWEEPS) -> dict:
    """K4's chain floor on a ``[B, k, k]`` batch: the latency of one link of
    its sequential chain (``eigh_kernel.chain_floor``: one warp running a
    matrix's ``sweeps k (k - 1) / 2`` links alone, median of 5 warm runs,
    CUDA events) times the waves of matrices K4's launch makes (matrices an
    SM from ``eigh_kernel.config``, the card's SMs): no K4 launch on the
    batch can be faster.  Returns ``{"link_ns", "matrix_ms",
    "matrices_per_sm", "waves", "chain_floor_ms"}``."""
    b, k, _ = a.shape
    ms = median_ms(lambda: eigh_kernel.chain_floor(a, sweeps=sweeps))
    per_sm = eigh_kernel.config(k)["matrices_per_sm"]
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    waves = -(-b // (per_sm * sms))
    return {"link_ns": ms * 1e6 / (sweeps * k * (k - 1) // 2), "matrix_ms": ms,
            "matrices_per_sm": per_sm, "waves": waves,
            "chain_floor_ms": ms * waves}


def spd(b: int, k: int, seed: int, dev) -> torch.Tensor:
    """``b`` seeded ``x x^T / (2k) + I``, ``x`` a ``k x 2k`` normal draw."""
    x = np.random.default_rng(seed).standard_normal((b, k, 2 * k))
    a = x @ x.transpose(0, 2, 1) / (2 * k) + np.eye(k)
    return torch.from_numpy(a.astype(np.float32)).to(dev)


def ab(calls: dict, outputs) -> dict:
    """Time ``calls`` ``{"source": fn, "variant": fn}`` in the order
    source, variant, variant, source; ``outputs(side)`` gives a side's
    tensors after one call, compared bit for bit."""
    got = {}
    for side, fn in calls.items():
        rc = fn()
        if rc != 0:
            raise RuntimeError(f"{side}: launch failed with CUDA error {rc}")
        torch.cuda.synchronize()
        got[side] = [t.clone() for t in outputs(side)]
    ms = {side: [] for side in calls}
    for side in ("source", "variant", "variant", "source"):
        ms[side].append(median_ms(calls[side]))
    same = all(torch.equal(x, y) for x, y in zip(got["source"],
                                                 got["variant"]))
    if not same:
        raise AssertionError("the two layouts' outputs differ")
    return {"source_ms": ms["source"], "variant_ms": ms["variant"],
            "bit_for_bit": same}


def run(dev) -> dict:
    pairs = build_pairs()
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    out = {}
    for variant, cases in JACOBI_CASES.items():
        for kind, b, k in cases:
            a = spd(b, k, SEED + k, dev)
            bufs = {side: (torch.empty((b, k), device=dev), torch.empty_like(a))
                    for side in ("source", "variant")}
            calls, configs = {}, {}
            log = torch.empty(b * eigh_kernel.log_bytes(k, SWEEPS),
                              dtype=torch.uint8, device=dev)
            extra = (() if kind == "parallel" else
                     (log.data_ptr() if log.numel() else None, log.numel()))
            for side, lib in zip(("source", "variant"), pairs[variant]):
                fn = eigh_kernel.bind(lib, kind)
                lam, v = bufs[side]
                calls[side] = (lambda fn=fn, lam=lam, v=v: fn(
                    a.data_ptr(), lam.data_ptr(), v.data_ptr(), b, k, SWEEPS,
                    stream.value, *extra))
                cfg = (ctypes.c_int * len(eigh_kernel.CONFIG_KEYS))()
                if lib.jacobi_config(int(kind == "cyclic"), k, cfg) != 0:
                    raise RuntimeError(f"jacobi_config failed at k={k}")
                configs[side] = dict(zip(eigh_kernel.CONFIG_KEYS, cfg))
            res = ab(calls, lambda side: bufs[side])
            if kind == "cyclic":
                res["chain_floor"] = chain_floor(a)
            name = "K4" if kind == "cyclic" else "K3"
            key = f"{variant} {name} [{b},{k},{k}]"
            out[key] = {**res, "config": configs}
            print(key, json.dumps(out[key]), flush=True)
    b, k = NS_CASE
    a = spd(b, k, SEED, dev)
    for rmul in (0, 1):
        bufs = {side: (torch.empty_like(a),
                       torch.empty(b, dtype=torch.int32, device=dev),
                       torch.empty(b, device=dev))
                for side in ("source", "variant")}
        calls = {}
        for side, lib in zip(("source", "variant"), pairs["ns_k128_const"]):
            z, iters, resid = bufs[side]
            calls[side] = (lambda lib=lib, z=z, iters=iters, resid=resid:
                           lib.ns_invsqrt_f32(
                               ctypes.c_void_p(a.data_ptr()),
                               ctypes.c_void_p(z.data_ptr()),
                               ctypes.c_void_p(iters.data_ptr()),
                               ctypes.c_void_p(resid.data_ptr()), b, k,
                               ctypes.c_float(float(k - 1)),
                               ctypes.c_float(1e-4), NS_STEPS, rmul, stream))
        res = ab(calls, lambda side: bufs[side][:2])
        key = f"ns_k128_const {'K2' if rmul else 'K1'} [{b},{k},{k}]"
        out[key] = {**res,
                    "mean_steps": float(bufs["source"][1].float().mean())}
        print(key, json.dumps(out[key]), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="layout_ab")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    dev = select_device("gpu")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip().splitlines()[0] if smi.strip() else "nvidia-smi: none")
    out = run(dev)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
