"""Profiling: the device-time breakdown.

Port of the JAX package's ``profiling.py``.  The reference's only
instrumentation is root-rank wall-clock stage prints (timer(),
module_mpi_util.f90:66-71).  Here :func:`device_breakdown` re-runs the
update's stages on a sample batch, each timed alone behind a device
synchronize: where the device time goes, without a profiler.  A trace of a
region, with the program's spans and counters, is
:func:`.tracing.maybe_trace`.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import torch

from .ops.dense import dense_platform_terms, fused_platform_table
from .ops.neighbors import normalize_coords
from .ops.solver import apply_weight_factors, letkf_weight_factors_from_normal
from .tracing import count_sync


def _sync(x):
    """Wait for the device that holds ``x`` (a tensor or a tuple of them)."""
    first = x[0] if isinstance(x, (tuple, list)) else x
    if first.device.type == "cuda":
        count_sync()
        torch.cuda.synchronize(first.device)
    return x


def _best_of(fn, reps: int = 3) -> float:
    """The least host seconds of ``reps`` calls of ``fn``, each synchronized."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        _sync(fn())
        best = min(best, time.perf_counter() - t0)
    return best


@torch.inference_mode()
def device_breakdown(
    xb,
    points_xyz,
    platforms: Sequence,
    ivar: int = 0,
    *,
    weight_function: int = 0,
    inflat: Optional[float] = None,
    sample: int = 4096,
    reps: int = 3,
) -> Dict[str, float]:
    """Per-stage device seconds on the first ``sample`` points (best of
    ``reps``, after one warm call each).

    Stages of the update pipeline: ``localize_accumulate`` (the dense path
    over all records of every active platform: distance product, cap
    threshold, weighted table product; :func:`.ops.dense.dense_platform_terms`,
    as the JAX package times it.  A platform that the update accumulates
    bucketed is timed on this dense path all the same, and its table is
    built here and dropped on return, never cached), ``eigh`` (the
    eigen factors of the float32 normal matrices,
    :func:`.ops.solver.letkf_weight_factors_from_normal`: the Jacobi kernels
    on a card, ``torch.linalg.eigh`` on the CPU) and ``weight_apply``
    (:func:`.ops.solver.apply_weight_factors`).  Each runs on its inputs
    already on the platforms' device, so the times add up to an estimate of
    the pipeline.  Returns ``{stage}_s``, ``total_s``, ``points`` and
    ``{stage}_frac``.
    """
    active = [dp for dp in platforms
              if dp.static.active(ivar) and dp.xyz.shape[0] > 0]
    if not active:
        raise ValueError("no active platform for this variable")
    dev = active[0].xyz.device
    xb = torch.as_tensor(xb, device=dev)[:sample]
    q = torch.as_tensor(points_xyz, device=dev)[:sample]
    b, k = xb.shape
    if inflat is None:
        inflat = float(k - 1)
    out: Dict[str, float] = {}

    terms = []
    for dp in active:
        st = dp.static
        terms.append((
            normalize_coords(q, st.hclr[ivar], st.vclr[ivar]),
            normalize_coords(dp.xyz, st.hclr[ivar], st.vclr[ivar]),
            fused_platform_table(dp.stats, st.assim_mask(ivar),
                                 dtype=torch.float32),
            st.max_lz_pts))

    def run_accumulate():
        a = torch.zeros((b, k, k), dtype=torch.float32, device=dev)
        g = torch.zeros((b, k), dtype=torch.float32, device=dev)
        for qn, on, table, n_max in terms:
            a_p, g_p, _ = dense_platform_terms(
                qn, on, *table, n_max=n_max, weight_function=weight_function)
            a += a_p
            g += g_p
        return a, g

    a_obs, g = _sync(run_accumulate())
    out["localize_accumulate_s"] = _best_of(run_accumulate, reps)

    def run_eigh():
        return letkf_weight_factors_from_normal(a_obs, g, inflat)

    lam, v, g2 = _sync(run_eigh())
    out["eigh_s"] = _best_of(run_eigh, reps)

    def run_apply():
        return apply_weight_factors(lam, v, g2, xb)

    _sync(run_apply())
    out["weight_apply_s"] = _best_of(run_apply, reps)

    total = sum(out.values())
    out["total_s"] = total
    out["points"] = b
    for name in ("localize_accumulate", "eigh", "weight_apply"):
        out[f"{name}_frac"] = (out[f"{name}_s"] / total) if total else 0.0
    return out
