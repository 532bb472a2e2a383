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

Where the cap runs on a card, a point keeps a few hundred of a call's
thousands of records, and the terms are summed over the selected pairs alone
from the table's per-record factors (:class:`PairFactors`, K6:
:mod:`.select_kernel`) instead of the dense product.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .. import tracing
from ..constants import GC1999_SQ
from ..localization import WEIGHT_GC1999, gaspari_cohn_1999
from . import cap_kernel, select_kernel
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


class PairFactors(NamedTuple):
    """One assimilation mask's per-record factors of the fused table.

    Record r's row of :func:`fused_platform_table` is
    ``sum_v (e[r, v] bgo[r, v, :k]) (x) bgo[r, v]`` (:func:`fused_rows`).
    Shapes (P = records, V = observed variables, k = members):

      bgo: [P, V, k+1]  ``[bg | omm]``, shared by every mask of a platform
      e:   [P, V]       ``(valid & assim) / err^2``, 0 elsewhere
    """

    bgo: torch.Tensor
    e: torch.Tensor


def _assimilated(stats: ObsStats, assim_v) -> torch.Tensor:
    """``valid & assim_v`` ``[V, R]``; the mask is applied a variable at a
    time, so that nothing is copied to the device (a copy from the host
    would wait for the card)."""
    if stats.omm.shape[0] != len(assim_v):
        raise ValueError(f"assim mask has {len(assim_v)} vars, stats have "
                         f"{stats.omm.shape[0]}")
    valid = stats.valid.clone()
    for v, on in enumerate(assim_v):
        if not on:
            valid[v].fill_(False)
    return valid


def accepted_counts(stats: ObsStats, assim_v) -> torch.Tensor:
    """``[R]`` int32: each record's observations that pass QC and are
    assimilated under ``assim_v`` (:func:`fused_platform_table`'s counts,
    in record order)."""
    return _assimilated(stats, assim_v).sum(0, dtype=torch.int32)


def pair_factors(
    stats: ObsStats,
    masks,
    *,
    order: torch.Tensor | None = None,
    pad_to: int | None = None,
    dtype=torch.float32,
) -> Tuple[PairFactors, ...]:
    """One :class:`PairFactors` per assimilation mask of ``masks``, in the
    order and padding of :func:`fused_platform_table` with the same
    ``order`` and ``pad_to`` (padding rows are 0); the masks share one
    ``bgo``."""
    bg, omm = stats.bg.to(dtype), stats.omm.to(dtype)
    if order is not None:
        bg, omm = bg[:, order], omm[:, order]
    pad = 0 if pad_to is None else max(0, pad_to - bg.shape[1])
    bgo = F.pad(torch.cat([bg, omm[..., None]], -1), (0, 0, 0, pad))
    bgo = bgo.permute(1, 0, 2).contiguous()
    err = stats.err.to(dtype)
    out = []
    for assim_v in masks:
        e = torch.where(_assimilated(stats, assim_v), 1.0 / (err * err), 0.0)
        if order is not None:
            e = e[:, order]
        out.append(PairFactors(bgo, F.pad(e, (0, pad)).T.contiguous()))
    return tuple(out)


def fused_rows(factors: PairFactors) -> torch.Tensor:
    """``[P, k*(k+1)]``: the fused table's rows that ``factors`` multiply
    out to."""
    bgo, e = factors
    k = bgo.shape[-1] - 1
    ebg = e[..., None] * bgo[..., :k]
    return torch.einsum("rvk,rvl->rkl", ebg, bgo).reshape(bgo.shape[0], -1)


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
    ``k x (k+1)`` matrix ``[BGBG_r | OMBG_r]`` flattened row-major, the rows
    that :func:`pair_factors`' factors multiply out to (:func:`fused_rows`).
    ``order`` reorders the records and ``pad_to`` zero-pads them to ``P``
    rows; both act on the small per-record factors before the table is
    built, and the build runs in row slices of ``_TABLE_ROW_SLICE``, so the
    only ``O(R k^2)`` array is the table itself.
    """
    (bgo, e), = pair_factors(stats, (assim_v,), order=order, pad_to=pad_to,
                             dtype=dtype)
    nvalid = accepted_counts(stats, assim_v)                          # [R]
    if order is not None:
        nvalid = nvalid[order]
    nvalid = F.pad(nvalid, (0, bgo.shape[0] - nvalid.shape[0]))
    k = bgo.shape[-1] - 1
    p = bgo.shape[0]
    fused = torch.empty((p, k * (k + 1)), dtype=bgo.dtype, device=bgo.device)
    for r0 in range(0, p, _TABLE_ROW_SLICE):
        r1 = min(p, r0 + _TABLE_ROW_SLICE)
        fused[r0:r1] = fused_rows(PairFactors(bgo[r0:r1], e[r0:r1]))
    return fused, nvalid


def gather_blocks(x: torch.Tensor, n_blocks: int, idx: torch.Tensor):
    """Rows of ``x`` (``[n_blocks * S, ...]``, a blocked table or factor) of
    the blocks ``idx``, flattened to ``[len(idx) * S, ...]``."""
    s = x.shape[0] // n_blocks
    return x.view(n_blocks, s, *x.shape[1:])[idx].reshape(-1, *x.shape[1:])


def selects_pairs(r: int, n_max: int, dtype, device,
                  factors: PairFactors | None) -> bool:
    """Whether :func:`terms_from_r2` sums the selected pairs in K6
    (:mod:`.select_kernel`) for ``[C, r]`` distances of ``dtype`` on
    ``device``: where the cap search runs on a card (``r > n_max``, float32
    CUDA distances) and float32 ``factors`` are given.  Every other call
    takes the dense product with the fused table.  Decided from the input
    alone, so that a caller can gather only what the call will read."""
    return (r > n_max and torch.device(device).type == "cuda"
            and dtype == torch.float32 and factors is not None
            and factors.e.dtype == torch.float32)


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


def product_terms(r2, sel, fused, nvalid, weight_function):
    """The dense product: ``(a_obs [C, k, k], g [C, k], count [C] int32)``
    of the ``[C, R]`` selection ``sel`` at distances ``r2``, weighted and
    multiplied with the ``[R, k*(k+1)]`` fused table.  The label
    ``accumulate.weights`` and the span ``accumulate.matmul``."""
    c = r2.shape[0]
    k = int((-1 + (1 + 4 * fused.shape[-1]) ** 0.5) / 2)
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
    return out3[:, :, :k], out3[:, :, k], count


def terms_from_r2(
    r2: torch.Tensor,
    fused: torch.Tensor | None,
    nvalid: torch.Tensor,
    *,
    n_max: int,
    weight_function: int,
    r2_cap: float = GC1999_SQ,
    row_mask: torch.Tensor | None = None,
    factors: PairFactors | None = None,
):
    """Capped, localization-weighted normal terms from a distance matrix.

    Args:
      r2:     ``[C, R]`` squared normalized distances.
      fused:  ``[R, k*(k+1)]`` rows in :func:`fused_platform_table`'s layout;
              None where :func:`selects_pairs` holds.
      nvalid: ``[R]`` accepted-obs count per record.
      row_mask: optional ``[R]`` bool; False rows never contribute.
      factors: the table's :class:`PairFactors` in the same record order.

    Returns ``(a_obs [C, k, k], g [C, k], count [C] int32)``.

    Where the multisection runs (``R > n_max``) on float32 CUDA distances,
    the row mask, the threshold and the selection are one launch of the
    cap-search kernel (:func:`.cap_kernel.launch`, bit for bit with this
    function's own code, which every other call takes); given float32
    ``factors`` there, the terms are one launch of K6, which sums the
    selected pairs alone (:func:`.select_kernel.launch`; the same terms
    with the sum in another order).  Every other call takes the dense
    product (:func:`product_terms`).

    Spans ``accumulate.cap`` (the row mask, the cap's threshold and the
    selection) and ``accumulate.matmul`` (the product, or K6), the label
    ``accumulate.weights`` (the product's weights); counters
    ``accumulate.pairs`` (``C x R``, what the product multiplies),
    ``accumulate.pairs_selected``, where the multisection runs
    ``accumulate.cap_points`` (``C``) and ``accumulate.cap_bound`` (rows
    where the cap binds), ``accumulate.cap_launches`` (the cap search's
    launches) and ``accumulate.select_launches`` (K6's) (:mod:`..tracing`).
    """
    c, r = r2.shape
    capped = r > n_max
    kernel = capped and r2.is_cuda and r2.dtype == torch.float32
    select = selects_pairs(r, n_max, r2.dtype, r2.device, factors)
    if not select:
        if fused is None:
            raise ValueError("this call takes the dense product, which needs "
                             "the fused table")
        kk_k = fused.shape[-1]
        k = int((-1 + (1 + 4 * kk_k) ** 0.5) / 2)   # k*(k+1) = kk_k
        if k * (k + 1) != kk_k:
            raise ValueError(f"table width {kk_k} is not k*(k+1)")
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
    if select:
        with tracing.span("accumulate.matmul"):
            a_obs, g, count = select_kernel.launch(
                r2, sel, factors.bgo, factors.e, nvalid, weight_function)
    else:
        a_obs, g, count = product_terms(r2, sel, fused, nvalid,
                                        weight_function)
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
            if select:
                tracing.count("accumulate.select_launches", 1)
    return a_obs, g, count


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
    factors: PairFactors | None = None,
):
    """One platform's normal terms for a chunk of points, over all records.

    ``q_norm`` ``[C, 3]`` and ``obs_norm`` ``[R, 3]`` in the same
    localization-normalized coordinates; distances are taken about the
    records' mean; ``fused`` and ``nvalid`` are
    :func:`fused_platform_table`'s, ``factors`` its :class:`PairFactors`
    (:func:`terms_from_r2` takes them where the cap runs on a card).
    Returns ``(a_obs [C, k, k], g [C, k], count [C] int32)`` in the table's
    dtype.
    """
    obs = obs_norm.to(q_norm.dtype)
    center = (obs.mean(0, keepdim=True) if obs.shape[0]
              else torch.zeros((1, 3), dtype=q_norm.dtype, device=q_norm.device))
    return terms_from_r2(centered_r2(q_norm, obs, center), fused, nvalid,
                         n_max=n_max,
                         weight_function=weight_function, r2_cap=r2_cap,
                         factors=factors)
