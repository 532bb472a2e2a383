"""Space-filling-curve keys and block budgets for block-culled accumulation.

Port of the key and budget functions of the JAX package's ``ops/bucketed.py``.
Large platforms (radar volumes) are Hilbert-sorted and cut into fixed blocks
of records with per-block centers and covering radii; a chunk of points then
gathers only the blocks that can reach it (see ``ops/cycle.py``).  The keys
set the point and record order, so they match the JAX package bit for bit.
Integer keys are int64 here (uint32 there); every value stays below 2**30.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import GC1999_SQ


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
