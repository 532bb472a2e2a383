"""Dense localization-weighted normal-term accumulation.

Port of ``fused_platform_table``, ``_cap_threshold`` and ``terms_from_r2`` of
the JAX package's ``ops/dense.py``.  The whitened normal terms are separable
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

from ..constants import GC1999_SQ
from ..localization import WEIGHT_GC1999, gaspari_cohn_1999
from .whiten import ObsStats

#: rows per slice of the table build: bounds the einsum's transient to one
#: slice (the table at the k=96 production radar volume is ~7 GB)
_TABLE_ROW_SLICE = 16384


def fused_platform_table(
    stats: ObsStats,
    assim_v: Tuple[bool, ...],
    *,
    order: torch.Tensor | None = None,
    pad_to: int | None = None,
):
    """The fused table ``[P, k*(k+1)]`` and accepted-obs counts ``[P]``.

    Record r's row is the ``k x (k+1)`` matrix ``[BGBG_r | OMBG_r]``
    flattened row-major.  ``order`` reorders the records and ``pad_to``
    zero-pads them to ``P`` rows; both act on the small ``[V, R, k]``
    statistics before the table is built, and the build runs in row slices of
    ``_TABLE_ROW_SLICE``, so the only ``O(R k^2)`` array is the table itself.
    """
    if stats.omm.shape[0] != len(assim_v):
        raise ValueError(f"assim mask has {len(assim_v)} vars, stats have "
                         f"{stats.omm.shape[0]}")
    active = torch.tensor(assim_v, dtype=torch.bool, device=stats.omm.device)
    valid = stats.valid & active[:, None]                      # [V, R]
    e = torch.where(valid, 1.0 / (stats.err * stats.err), 0.0)
    bg, omm = stats.bg, stats.omm
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
    """
    c = r2.shape[0]
    kk_k = fused.shape[-1]
    k = int((-1 + (1 + 4 * kk_k) ** 0.5) / 2)   # k*(k+1) = kk_k
    if k * (k + 1) != kk_k:
        raise ValueError(f"table width {kk_k} is not k*(k+1)")
    if row_mask is not None:
        r2 = torch.where(row_mask[None, :], r2, float("inf"))
    if r2.shape[1] > n_max:
        sel = r2 <= _cap_threshold(r2, n_max, r2_cap)[:, None]
    else:
        sel = r2 <= r2_cap
    r2_sel = torch.where(sel, r2, 0.0)
    if weight_function == WEIGHT_GC1999:
        w2 = gaspari_cohn_1999(torch.sqrt(r2_sel))
    else:
        w2 = torch.exp(-0.5 * r2_sel)   # (exp(0.25 r2))^-2, letkf_core.f90:444
    gm = torch.where(sel, w2, 0.0)                                 # [C, R]
    out3 = (gm @ fused).view(c, k, k + 1)
    count = (sel.to(torch.float32) @ nvalid.to(torch.float32)).to(torch.int32)
    return out3[:, :, :k], out3[:, :, k], count
