"""Localization-normalized coordinates and the fixed-radius neighbor search.

Port of the JAX package's ``ops/neighbors.py``.  The reference builds one
kd-tree per (platform, analysis variable) in localization-normalized
coordinates and queries it per gridpoint (module_localization.f90:35-167,
188-331); here the search is a batched distance expansion and a capped top-k:

    r2[b, o] = |q_b - x_o|^2        (one [C, 3] x [3, N] product per chunk)
    keep the hits with r2 <= gc1999^2   (module_localization.f90:202)
    capped at the n_max nearest          (max_lz_pts)

Coordinates are normalized by the per-variable localization radii
(:func:`normalize_coords`), so the search radius is the constant
``GC1999_SQ`` for every platform.  Where more than ``n_max`` records fall
inside the ball the reference keeps the first ``n_max`` its tree walk meets;
here the ``n_max`` nearest are kept (the same set whenever the cap does not
bind).  The chunk loop is an eager Python loop.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..constants import GC1999_SQ

#: coordinate of padded and invalid records: r2 >> GC1999_SQ for any
#: normalized query, and its square (1e30) stays finite in float32
_FAR = 1e15


class NeighborSet(NamedTuple):
    """Fixed-width neighbor lists for a batch of query points.

    idx:  ``[B, n_max]`` int64 record indices; where ``~mask`` they are
          arbitrary and may lie past the last record (clamp before a gather)
    r2:   ``[B, n_max]`` squared normalized distances (``inf`` where ``~mask``)
    mask: ``[B, n_max]`` bool, True for real in-radius neighbors
    """

    idx: torch.Tensor
    r2: torch.Tensor
    mask: torch.Tensor


def normalize_coords(xyz: torch.Tensor, hclr_km: float, vclr_km: float):
    """Scale (x, y, z) meters by the localization radii, km -> m.

    Horizontal coordinates are divided by ``hclr*1e3``; the vertical one by
    ``vclr*1e3`` when ``vclr > 0``, else scaled to exactly 0 (2-D
    localization; module_localization.f90:76-82,148-157).
    """
    h_inv = 1.0 / (hclr_km * 1e3)
    v_inv = 1.0 / (vclr_km * 1e3) if vclr_km > 0.0 else 0.0
    scale = torch.tensor([h_inv, h_inv, v_inv], dtype=xyz.dtype,
                         device=xyz.device)
    return xyz * scale


def _chunk_neighbors(q, obs_t, obs_sq, n_max, r2_cap):
    """One chunk: ``q [C, 3]`` against ``obs_t [3, N]`` (N >= n_max) -> the
    capped top-k of the in-radius records."""
    # |q - o|^2 = |q|^2 + |o|^2 - 2 q.o on centered coordinates (see
    # radius_neighbors), so the cancellation stays benign in float32
    qsq = (q * q).sum(-1, keepdim=True)
    r2 = (qsq + obs_sq[None, :] - 2.0 * (q @ obs_t)).clamp_min(0.0)
    neg = torch.where(r2 <= r2_cap, -r2, float("-inf"))
    vals, idx = torch.topk(neg, n_max, dim=-1)
    mask = vals > float("-inf")
    return NeighborSet(idx=idx, r2=torch.where(mask, -vals, float("inf")),
                       mask=mask)


def radius_neighbors(
    query_xyz: torch.Tensor,
    obs_xyz: torch.Tensor,
    *,
    n_max: int,
    r2_cap: float = GC1999_SQ,
    obs_valid: Optional[torch.Tensor] = None,
    chunk: int = 4096,
) -> NeighborSet:
    """Up to ``n_max`` nearest records within ``sqrt(r2_cap)`` of each query.

    Args:
      query_xyz: ``[B, 3]`` normalized gridpoint coordinates.
      obs_xyz:   ``[N, 3]`` normalized record coordinates (same scaling).
      n_max:     cap per query (the platform's ``max_lz_pts``).
      r2_cap:    squared search radius (``gc1999^2``).
      obs_valid: optional ``[N]`` bool; invalid records are never returned.
      chunk:     queries per distance block (bounds the ``[chunk, N]``
                 buffers).

    Fewer than ``n_max`` records are padded with far-away sentinels, so the
    result is always ``[B, n_max]``; the sentinels are masked.
    """
    q = query_xyz
    obs = obs_xyz.to(q.dtype)
    b, n = q.shape[0], obs.shape[0]
    # centered on the records' centroid: distances are translation
    # invariant, and small magnitudes keep the expansion accurate
    center = (obs.mean(0, keepdim=True) if n
              else torch.zeros((1, 3), dtype=q.dtype, device=q.device))
    q = q - center
    obs = obs - center
    if obs_valid is not None:
        obs = torch.where(obs_valid[:, None], obs, _FAR)
    if n < n_max:
        obs = torch.cat([obs, obs.new_full((n_max - n, 3), _FAR)])
    obs_t = obs.T.contiguous()
    obs_sq = (obs * obs).sum(-1)
    parts = [_chunk_neighbors(q[c0:c0 + chunk], obs_t, obs_sq, n_max, r2_cap)
             for c0 in range(0, b, chunk)]
    if not parts:
        return NeighborSet(
            idx=torch.zeros((0, n_max), dtype=torch.int64, device=q.device),
            r2=q.new_zeros((0, n_max)),
            mask=torch.zeros((0, n_max), dtype=torch.bool, device=q.device))
    return NeighborSet(*(torch.cat(x) for x in zip(*parts)))
