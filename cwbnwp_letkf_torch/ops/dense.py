"""Dense localization-weighted normal-term accumulation.

Port of the JAX package's ``ops/dense.py``.  The whitened normal terms are separable
in (gridpoint, obs): with ``E = (valid & assim) / err^2`` and the distance
weight ``G(r2)`` (Gaussian ``exp(-r2/2)`` or Gaspari-Cohn),

    a_obs[b] = sum_o G(r2_bo) * BGBG[o],   BGBG[o] = sum_v E_vo bg_vo bg_vo^T
    g[b]     = sum_o G(r2_bo) * OMBG[o],   OMBG[o] = sum_v E_vo omm_vo bg_vo

so one fused per-record table ``[R, k*(k+1)]`` is built per (platform,
assimilation mask), and a chunk of points needs one ``[C, R] @ [R, k*(k+1)]``
matmul.  Accumulation is full float32 (see :mod:`..device`).

The ``max_lz_pts`` cap becomes a per-point threshold on ``r2``: the largest
``t <= GC1999^2`` with ``#{o : r2_bo <= t} <= n_max``, found by vectorized
multisection.  Where the reference keeps an arbitrary ``max_lz_pts`` subset of
the in-radius obs, this keeps the nearest ones; obs tied within the
multisection resolution of the threshold may be left out.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .. import tracing
from ..constants import GC1999_SQ
from ..localization import WEIGHT_GC1999, gaspari_cohn_1999
from . import cap_kernel
from .whiten import ObsStats

#: ``accum_precision`` names of the JAX package (bf16_3x and full float32
#: there); see :func:`set_accum_precision`
ACCUM_PRECISIONS = ("high", "highest")


def set_accum_precision(name: str) -> None:
    """The float32 normal-term accumulation precision, by the JAX package's
    names ``"high"`` (its default) or ``"highest"``.

    Both names leave the numerics as they are: the port accumulates in full
    float32 under both (TF32 is off, :mod:`..device`, and CUDA cores have no
    bf16_3x), so its ``"high"`` is the JAX package's ``"highest"``, and
    nothing is stored.  Any other name is refused with the JAX package's
    message.
    """
    if name not in ACCUM_PRECISIONS:
        raise ValueError(f"accum_precision must be one of "
                         f"{sorted(ACCUM_PRECISIONS)}, got {name!r}")


#: rows per slice of the table build: bounds the einsum's transient to one
#: slice (the table at the production radar volume is ~7 GB at k=96 and
#: ~13 GB at k=128; a slice ~1.1 GB at k=128)
_TABLE_ROW_SLICE = 16384


def fused_platform_table(
    stats: ObsStats,
    assim_v: Tuple[bool, ...],
    *,
    order: torch.Tensor | None = None,
    pad_to: int | None = None,
    dtype=torch.float32,
):
    """The fused table ``[P, k*(k+1)]`` in ``dtype`` and accepted-obs counts
    ``[P]``.

    QC, the assimilation mask and the error scaling fold into
    ``E_vr = (valid & assim_v) / err^2``; record r's row is the
    ``k x (k+1)`` matrix ``[BGBG_r | OMBG_r]`` flattened row-major.
    ``order`` reorders the records and ``pad_to`` zero-pads them to ``P``
    rows; both act on the small ``[V, R, k]`` statistics before the table is
    built, and the build runs in row slices of ``_TABLE_ROW_SLICE``, so the
    only ``O(R k^2)`` array is the table itself.
    """
    if stats.omm.shape[0] != len(assim_v):
        raise ValueError(f"assim mask has {len(assim_v)} vars, stats have "
                         f"{stats.omm.shape[0]}")
    active = torch.tensor(assim_v, dtype=torch.bool, device=stats.omm.device)
    valid = stats.valid & active[:, None]                      # [V, R]
    err = stats.err.to(dtype)
    e = torch.where(valid, 1.0 / (err * err), 0.0)
    bg, omm = stats.bg.to(dtype), stats.omm.to(dtype)
    nvalid = valid.sum(0, dtype=torch.int32)                   # [R]
    if order is not None:
        e, bg, omm, nvalid = e[:, order], bg[:, order], omm[:, order], nvalid[order]
    if pad_to is not None and pad_to > e.shape[1]:
        pad = pad_to - e.shape[1]
        e, omm = F.pad(e, (0, pad)), F.pad(omm, (0, pad))
        bg = F.pad(bg, (0, 0, 0, pad))
        nvalid = F.pad(nvalid, (0, pad))
    ebg = e[..., None] * bg                                    # [V, P, k]
    bg_ext = torch.cat([bg, omm[..., None]], -1)               # [V, P, k+1]
    k = bg.shape[-1]
    p = ebg.shape[1]
    fused = torch.empty((p, k * (k + 1)), dtype=bg.dtype, device=bg.device)
    for r0 in range(0, p, _TABLE_ROW_SLICE):
        r1 = min(p, r0 + _TABLE_ROW_SLICE)
        fused[r0:r1] = torch.einsum(
            "vrk,vrl->rkl", ebg[:, r0:r1], bg_ext[:, r0:r1]).reshape(r1 - r0, -1)
    return fused, nvalid


def _cap_threshold(r2: torch.Tensor, n_max: int, r2_cap: float, *,
                   splits: int = 16, rounds: int = 6) -> torch.Tensor:
    """Largest per-row threshold ``t <= r2_cap`` with ``#(r2 <= t) <= n_max``.

    Each round counts ``splits - 1`` candidate thresholds in one masked pass
    over ``r2`` and narrows the bracket ``splits``-fold; resolution after
    ``rounds`` is ``r2_cap * splits**-rounds``.  ``count(lo) <= n_max`` holds
    throughout, so the threshold never overshoots the cap.
    """
    lo = torch.full_like(r2[:, 0], -1.0)
    hi = torch.full_like(r2[:, 0], r2_cap)
    over = (r2 <= r2_cap).sum(-1) > n_max                      # [B]
    frac = torch.arange(1, splits, dtype=r2.dtype, device=r2.device) / splits
    for _ in range(rounds):
        cand = lo[:, None] + frac[None, :] * (hi - lo)[:, None]   # [B, S-1]
        counts = (r2[:, None, :] <= cand[:, :, None]).sum(-1)     # [B, S-1]
        n_ok = (counts <= n_max).sum(-1, keepdim=True)            # monotone
        lo_c = torch.cat([lo[:, None], cand], 1)                  # [B, S]
        hi_c = torch.cat([cand, hi[:, None]], 1)
        lo, hi = lo_c.gather(1, n_ok)[:, 0], hi_c.gather(1, n_ok)[:, 0]
    return torch.where(over, lo, torch.full_like(lo, r2_cap))


def terms_from_r2(
    r2: torch.Tensor,
    fused: torch.Tensor,
    nvalid: torch.Tensor,
    *,
    n_max: int,
    weight_function: int,
    r2_cap: float = GC1999_SQ,
    row_mask: torch.Tensor | None = None,
):
    """Capped, localization-weighted normal terms from a distance matrix.

    Args:
      r2:     ``[C, R]`` squared normalized distances.
      fused:  ``[R, k*(k+1)]`` rows in :func:`fused_platform_table`'s layout.
      nvalid: ``[R]`` accepted-obs count per record.
      row_mask: optional ``[R]`` bool; False rows never contribute.

    Returns ``(a_obs [C, k, k], g [C, k], count [C] int32)``.

    Where the multisection runs (``R > n_max``) on float32 CUDA distances,
    the row mask, the threshold and the selection are one launch of the
    cap-search kernel (:func:`.cap_kernel.launch`, bit for bit with this
    function's own code, which every other call takes).

    Spans ``accumulate.cap`` (the row mask, the cap's threshold and the
    selection) and ``accumulate.matmul``, the label ``accumulate.weights``;
    counters ``accumulate.pairs`` (``C x R``, what the product multiplies),
    ``accumulate.pairs_selected``, where the multisection runs
    ``accumulate.cap_points`` (``C``) and ``accumulate.cap_bound`` (rows
    where the cap binds), and ``accumulate.cap_launches`` (the kernel's
    launches) (:mod:`..tracing`).
    """
    c, r = r2.shape
    kk_k = fused.shape[-1]
    k = int((-1 + (1 + 4 * kk_k) ** 0.5) / 2)   # k*(k+1) = kk_k
    if k * (k + 1) != kk_k:
        raise ValueError(f"table width {kk_k} is not k*(k+1)")
    capped = r > n_max
    kernel = capped and r2.is_cuda and r2.dtype == torch.float32
    with tracing.span("accumulate.cap"):
        if kernel:
            # sel is False at masked records, so the weights may read r2
            # unmasked
            sel, over = cap_kernel.launch(r2, row_mask, n_max, r2_cap)
        else:
            if row_mask is not None:
                r2 = torch.where(row_mask[None, :], r2, float("inf"))
            if capped:
                sel = r2 <= _cap_threshold(r2, n_max, r2_cap)[:, None]
            else:
                sel = r2 <= r2_cap
    with tracing.label("accumulate.weights"):
        r2_sel = torch.where(sel, r2, 0.0)
        if weight_function == WEIGHT_GC1999:
            w2 = gaspari_cohn_1999(torch.sqrt(r2_sel))
        else:
            w2 = torch.exp(-0.5 * r2_sel)   # (exp(0.25 r2))^-2, letkf_core.f90:444
        gm = torch.where(sel, w2, 0.0).to(fused.dtype)             # [C, R]
    with tracing.span("accumulate.matmul"):
        out3 = (gm @ fused).view(c, k, k + 1)
        count = (sel.to(torch.float32) @ nvalid.to(torch.float32)).to(torch.int32)
    if tracing.on():
        with tracing.label("tracing.count"):
            tracing.count("accumulate.pairs", c * r)
            tracing.count("accumulate.pairs_selected", sel.sum())
            if capped:
                tracing.count("accumulate.cap_points", c)
                tracing.count("accumulate.cap_bound", over.sum() if kernel
                              else ((r2 <= r2_cap).sum(1) > n_max).sum())
            if kernel:
                tracing.count("accumulate.cap_launches", 1)
    return out3[:, :, :k], out3[:, :, k], count


def centered_r2(q: torch.Tensor, obs: torch.Tensor,
                center: torch.Tensor) -> torch.Tensor:
    """``[C, R]`` squared distances between ``q`` and ``obs``, both centered
    on ``center`` ``[1, 3]`` and expanded through one 3-wide matmul."""
    qc = q - center
    oc = obs - center
    return ((qc * qc).sum(-1, keepdim=True) + (oc * oc).sum(-1)[None, :]
            - 2.0 * (qc @ oc.T)).clamp_min(0.0)


def dense_platform_terms(
    q_norm: torch.Tensor,
    obs_norm: torch.Tensor,
    fused: torch.Tensor,
    nvalid: torch.Tensor,
    *,
    n_max: int,
    weight_function: int,
    r2_cap: float = GC1999_SQ,
):
    """One platform's normal terms for a chunk of points, over all records.

    ``q_norm`` ``[C, 3]`` and ``obs_norm`` ``[R, 3]`` in the same
    localization-normalized coordinates; distances are taken about the
    records' mean; ``fused`` and ``nvalid`` are
    :func:`fused_platform_table`'s.  Returns ``(a_obs [C, k, k], g [C, k],
    count [C] int32)`` in the table's dtype.
    """
    obs = obs_norm.to(q_norm.dtype)
    center = (obs.mean(0, keepdim=True) if obs.shape[0]
              else torch.zeros((1, 3), dtype=q_norm.dtype, device=q_norm.device))
    return terms_from_r2(centered_r2(q_norm, obs, center), fused, nvalid,
                         n_max=n_max,
                         weight_function=weight_function, r2_cap=r2_cap)
