"""Block-culled accumulation for large platforms, and its space-filling keys.

Port of the JAX package's ``ops/bucketed.py``.  Large platforms (radar
volumes) are Hilbert-sorted and cut into fixed blocks of records with
per-block centers and covering radii; a chunk of points then gathers only the
blocks that can reach it (:func:`bucketed_platform_terms`, and the fused
cycle's ``ops/cycle.py``).  Culled blocks lie outside every point's
localization ball, so the result equals the dense path's whenever no
candidate block overflows the budget.  The keys set the point and record
order, so they match the JAX package bit for bit.  Integer keys are int64
here (uint32 there); every value stays below 2**30.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constants import GC1999_SQ
from .dense import (PairFactors, centered_r2, fused_platform_table,
                    gather_blocks, pair_factors, selects_pairs, terms_from_r2)
from .whiten import ObsStats


def sq_norm3(d: torch.Tensor) -> torch.Tensor:
    """``d_x^2 + d_y^2 + d_z^2`` over the last axis, summed left to right as
    the JAX package's three-term reductions are, so culling decisions at a
    block's reach match it exactly."""
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x so there are 2 zero bits between each."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def _cells(xyz, bbox_min, bbox_max, bits):
    """Integer cell coordinates on one cubical grid of ``2**bits`` cells a side.

    One common cell size (the largest axis extent over ``2**bits``) keeps
    chunks of consecutive keys compact in the metric of the coordinates;
    degenerate axes quantize to cell 0.
    """
    if bbox_min is None:
        bbox_min = xyz.amin(0)
    if bbox_max is None:
        bbox_max = xyz.amax(0)
    n = (1 << bits) - 1
    cell_size = (bbox_max - bbox_min).max().clamp_min(1e-30) / (n + 1)
    return ((xyz - bbox_min) / cell_size).clamp(0, n).to(torch.int64)


def morton3(xyz: torch.Tensor, *, bbox_min=None, bbox_max=None,
            bits: int = 10) -> torch.Tensor:
    """30-bit Morton (Z-order) key per 3-D point; higher = later on the curve."""
    cell = _cells(xyz, bbox_min, bbox_max, bits)
    return (_part1by2(cell[:, 0]) | (_part1by2(cell[:, 1]) << 1)
            | (_part1by2(cell[:, 2]) << 2))


def hilbert3(xyz: torch.Tensor, *, bbox_min=None, bbox_max=None,
             bits: int = 10) -> torch.Tensor:
    """30-bit Hilbert-curve key per 3-D point (cubical cells, like morton3).

    Consecutive Hilbert keys are always adjacent cells, so equal segments of
    the sorted order have compact bounding boxes.  Skilling's AxestoTranspose
    (J. Skilling, AIP Conf. Proc. 707, 2004), vectorized over points.
    """
    cell = _cells(xyz, bbox_min, bbox_max, bits)
    x = [cell[:, 0], cell[:, 1], cell[:, 2]]
    q = 1 << (bits - 1)
    while q > 1:
        p = q - 1
        for i in range(3):
            hit = (x[i] & q) != 0
            t = (x[0] ^ x[i]) & p
            x[0] = torch.where(hit, x[0] ^ p, x[0] ^ t)
            x[i] = torch.where(hit, x[i], x[i] ^ t)
        q >>= 1
    for i in range(1, 3):           # Gray encode
        x[i] = x[i] ^ x[i - 1]
    t = torch.zeros_like(x[0])
    q = 1 << (bits - 1)
    while q > 1:
        t = torch.where((x[2] & q) != 0, t ^ (q - 1), t)
        q >>= 1
    x = [xi ^ t for xi in x]
    # x[0] holds the most significant bit of each 3-bit level
    return (_part1by2(x[0]) << 2) | (_part1by2(x[1]) << 1) | _part1by2(x[2])


def auto_block_size(obs_norm: torch.Tensor, *, target_radius: float = 1.25,
                    lo: int = 64, hi: int = 1024) -> int:
    """Density-adaptive block size: covering radius ~ ``target_radius``.

    A block's covering radius adds to every candidacy test's reach, so blocks
    must stay small next to the localization ball (radius ~3.65 normalized
    units) whatever the obs density.  Targets a block cube of side
    ``2 * target_radius / sqrt(d)`` at the observed density (d = number of
    non-degenerate axes), clamped to [lo, hi] and rounded up to 64s.
    """
    obs = obs_norm.detach().cpu().numpy()
    ext = obs.max(0) - obs.min(0)
    live = ext[ext > 1e-9]
    if live.size == 0:
        return lo
    side = 2.0 * target_radius / np.sqrt(live.size)
    density = obs.shape[0] / np.prod(live)
    s = int(density * side ** live.size)
    return int(np.clip(-(-s // 64) * 64, lo, hi))


def required_max_blocks(q_norm_chunks: torch.Tensor, centers: torch.Tensor,
                        radii: torch.Tensor, r2_cap: float = GC1999_SQ) -> int:
    """Exact candidate-block budget: the most candidate blocks of any chunk.

    ``q_norm_chunks`` ``[n_chunks, chunk, 3]`` are the normalized query points
    in the chunking the update will use.  A block is a candidate of a chunk
    iff some point of the chunk is within ``sqrt(r2_cap) + radius`` of its
    center.
    """
    reach = torch.sqrt(torch.tensor(r2_cap, dtype=radii.dtype,
                                    device=radii.device)) + radii
    counts = []
    for qc in q_norm_chunks:
        d2 = sq_norm3(qc[:, None, :] - centers[None, :, :])
        counts.append((torch.sqrt(d2.amin(0)) <= reach).sum())
    return int(torch.stack(counts).max())


def default_max_blocks(n_blocks: int) -> int:
    """Heuristic candidate-block budget: ~1/4 of the blocks, at least 32.

    Callers that know the obs density size the budget themselves (see
    ``ops/cycle.plan_cycle_budgets``) and watch the overflow counter.
    """
    return max(32, -(-n_blocks // 4))


class BucketedPlatform(NamedTuple):
    """Block-sorted records of one (platform, variable group).

    Shapes (NB = blocks, S = block size, F = k*(k+1)):
      obs_norm: [NB*S, 3]  normalized coords, Hilbert order; padding repeats
                           the last real record (masked out by rec_mask)
      fused:    [NB, S, F] reordered (bgbg | ombg) rows, zero on padding
      nvalid:   [NB, S]    accepted obs per record, 0 on padding
      rec_mask: [NB, S]    True on real records
      centers:  [NB, 3]    per-block mean of the real records
      radii:    [NB]       covering radius: max distance center -> record
      center:   [1, 3]     mean of the real records, the dense path's
                           centering point, so the per-pair r2 (hence the
                           cap thresholds) match the dense path's
      factors:  the table's PairFactors in block order, [NB*S, V, k+1] and
                [NB*S, V], zero on padding
    """

    obs_norm: torch.Tensor
    fused: torch.Tensor
    nvalid: torch.Tensor
    rec_mask: torch.Tensor
    centers: torch.Tensor
    radii: torch.Tensor
    center: torch.Tensor
    factors: PairFactors | None = None

    @property
    def n_blocks(self) -> int:
        return self.fused.shape[0]

    @property
    def block_size(self) -> int:
        return self.fused.shape[1]


class HilbertBlocks(NamedTuple):
    """Records in Hilbert order, cut into blocks of S (NB = blocks).

      order:    [R]        record order, Hilbert keys of the blocking coords;
                           None where the records came presorted
      pad:      int        records of padding after the last real one
      obs_s:    [NB*S, 3]  the blocking coords in that order; padding repeats
                           the last real record
      rec_mask: [NB, S]    True on real records
      centers:  [NB, 3]    per-block mean of the real records
      radii:    [NB]       covering radius: max distance center -> record
    """

    order: torch.Tensor
    pad: int
    obs_s: torch.Tensor
    rec_mask: torch.Tensor
    centers: torch.Tensor
    radii: torch.Tensor


def pad_last(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``x`` with ``pad`` copies of its last row appended."""
    return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])]) if pad else x


def hilbert_blocks(obs: torch.Tensor, block_size: int, *,
                   presorted: bool = False) -> HilbertBlocks:
    """Hilbert-sort records by ``obs`` ``[R, 3]`` and cut them into blocks
    with per-block centers and covering radii, in ``obs``' metric.

    ``presorted=True`` takes the records in the order given (``order`` is
    None): the caller has sorted them by ``hilbert3`` of these coordinates,
    and no reordered copy is made.  Any order is valid; one far from
    Hilbert order only culls worse.
    """
    r = obs.shape[0]
    if r == 0:
        raise ValueError("cannot block an empty platform")
    s = block_size
    nb = -(-r // s)
    pad = nb * s - r
    order = None if presorted else torch.argsort(hilbert3(obs), stable=True)
    obs_s = pad_last(obs if presorted else obs[order], pad)
    mask_b = (torch.arange(nb * s, device=obs.device) < r).view(nb, s)
    obs_b = obs_s.view(nb, s, 3)
    n_real = mask_b.sum(1, keepdim=True).clamp_min(1)
    centers = torch.where(mask_b[..., None], obs_b, 0.0).sum(1) / n_real
    d2 = sq_norm3(obs_b - centers[:, None, :])
    radii = torch.sqrt(torch.where(mask_b, d2, 0.0).amax(1))
    return HilbertBlocks(order=order, pad=pad, obs_s=obs_s, rec_mask=mask_b,
                         centers=centers, radii=radii)


def bucket_platform(obs_norm: torch.Tensor, stats: ObsStats,
                    assim_v: tuple, *, block_size: int | None = None,
                    dtype=torch.float32) -> BucketedPlatform:
    """Hilbert-sort the records and cut them into blocks of ``block_size``
    (None: :func:`auto_block_size`); the fused table is built in block order
    (:func:`.dense.fused_platform_table`), so it is the only full table,
    and its factors beside it (:func:`.dense.pair_factors`)."""
    if block_size is None:
        block_size = auto_block_size(obs_norm)
    hb = hilbert_blocks(obs_norm, block_size)
    nb, s = hb.rec_mask.shape
    fused, nvalid = fused_platform_table(stats, assim_v, order=hb.order,
                                         pad_to=nb * s, dtype=dtype)
    factors, = pair_factors(stats, (assim_v,), order=hb.order, pad_to=nb * s,
                            dtype=dtype)
    return BucketedPlatform(obs_norm=hb.obs_s, fused=fused.view(nb, s, -1),
                            nvalid=nvalid.view(nb, s), rec_mask=hb.rec_mask,
                            centers=hb.centers, radii=hb.radii,
                            center=obs_norm.mean(0, keepdim=True),
                            factors=factors)


def bucketed_platform_terms(
    q_norm: torch.Tensor,
    bp: BucketedPlatform,
    *,
    n_max: int,
    weight_function: int,
    max_blocks: int,
    r2_cap: float = GC1999_SQ,
):
    """One platform's normal terms for a chunk of points, candidate blocks only.

    A block is a candidate iff some point of the chunk is within
    ``sqrt(r2_cap) + radius`` of its center; the ``max_blocks`` best (by
    center distance less radius) are gathered: their factors where the call
    sums the selected pairs (:func:`.dense.selects_pairs`), their fused rows
    where it takes the product.  Returns ``(a_obs [C, k, k], g [C, k],
    count [C] int32, overflow)``: the dense path's terms whenever
    ``overflow``, the 0-d count of candidate blocks left out, is 0.
    """
    nb, s = bp.n_blocks, bp.block_size
    m = min(max_blocks, nb)
    dmin = torch.sqrt(sq_norm3(q_norm[:, None, :] - bp.centers[None]).amin(0))
    reach = torch.sqrt(torch.tensor(r2_cap, dtype=dmin.dtype,
                                    device=dmin.device)) + bp.radii
    cand = dmin <= reach
    score = torch.where(cand, dmin - bp.radii, float("inf"))
    idx = torch.topk(-score, m).indices   # best candidates first
    keep = cand[idx]
    overflow = cand.sum() - keep.sum()

    obs_c = bp.obs_norm.view(nb, s, 3)[idx].reshape(m * s, 3)
    row_mask = (keep[:, None] & bp.rec_mask[idx]).reshape(m * s)
    r2 = centered_r2(q_norm, obs_c, bp.center)
    fused = factors = None
    if selects_pairs(m * s, n_max, r2.dtype, r2.device, bp.factors):
        factors = PairFactors(*(gather_blocks(x, nb, idx) for x in bp.factors))
    else:
        fused = bp.fused[idx].reshape(m * s, -1)
    a_obs, g, count = terms_from_r2(
        r2, fused, bp.nvalid[idx].reshape(m * s), n_max=n_max,
        weight_function=weight_function, r2_cap=r2_cap, row_mask=row_mask,
        factors=factors)
    return a_obs, g, count, overflow
