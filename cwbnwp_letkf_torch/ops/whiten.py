"""Per-observation statistics and QC, once per platform; the gathered
normal terms of the neighbor-search path.

Port of the JAX package's ``ops/whiten.py`` (letkf_yoyb,
module_letkf_core.f90:300-595).  The reference re-derives each observation's
ensemble statistics and rejection at every gridpoint that sees it; they
depend only on the observation, so they are computed once per platform
(:func:`platform_obs_stats`).  The per-gridpoint work of the gather path is
then a gather, a distance-weight multiply and two products
(:func:`accumulate_platform_terms`).  A masked slot (outside the radius,
padding, rejected, or not assimilated) contributes an exact zero.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..localization import obs_error_inv_weight
from .neighbors import NeighborSet


class ObsStats(NamedTuple):
    """Per-observation, gridpoint-independent quantities.

    Shapes (V = observed vars per record, R = records, K = members):
      omm:   [V, R]    obs minus ensemble-mean H(xb)
      bg:    [V, R, K] H(xb) perturbations
      err:   [V, R]    effective obs error (file error * err_muti)
      valid: [V, R]    QC gate and outlier rejection passed
    """

    omm: torch.Tensor
    bg: torch.Tensor
    err: torch.Tensor
    valid: torch.Tensor


def platform_obs_stats(
    obs: torch.Tensor,
    hdxb: torch.Tensor,
    error: torch.Tensor,
    qc: torch.Tensor,
    err_muti: Tuple[float, ...],
    err_rej: Tuple[float, ...],
    *,
    is_dbz: bool = False,
    norain_value: float = -5.0,
) -> ObsStats:
    """Vectorized per-obs statistics and QC.

    Args:
      obs/hdxb/error/qc: ``[V, R]`` / ``[V, R, K]`` / ``[V, R]`` / ``[V, R, K]``.
      err_muti/err_rej: per-observed-variable scalars (config.f90:17-18).
      is_dbz: the reflectivity no-rain rules (letkf_core.f90:504-510): no
        outlier rejection where ``obs == norain_value``, and the obs is
        dropped where both obs and ensemble mean equal ``norain_value``.
    """
    k = hdxb.shape[-1]
    dtype, dev = hdxb.dtype, hdxb.device
    mean = hdxb.mean(-1)
    bg = hdxb - mean[..., None]
    omm = obs - mean
    std = torch.sqrt((bg * bg).sum(-1) / (k - 1.0))
    err = error * torch.tensor(err_muti, dtype=dtype, device=dev)[:, None]
    rej = torch.tensor(err_rej, dtype=dtype, device=dev)[:, None]

    qc_ok = (qc >= 0).any(-1)   # any member qc >= 0 (letkf_core.f90:429)
    outlier = omm.abs() > torch.sqrt(std * std + err * err) * rej
    if is_dbz:
        norain = obs == norain_value
        rejected = (outlier & ~norain) | (norain & (mean == norain_value))
    else:
        rejected = outlier
    return ObsStats(omm=omm, bg=bg, err=err, valid=qc_ok & ~rejected)


def accumulate_platform_terms(
    nb: NeighborSet,
    stats: ObsStats,
    assim_v: Tuple[bool, ...],
    weight_function: int,
    *,
    solver_dtype=torch.float32,
):
    """Gather one platform's local obs and accumulate its normal terms.

    For ``B`` gridpoints with neighbor lists ``nb`` over this platform's
    records returns ``(a_obs [B, k, k], g [B, k], count [B] int32)``::

      a_obs = Yb' Yb'^T,   g = Yb' yo',   count = accepted obs

    with the whitened slots ``yo' = (obs - mean) * error_inv`` and
    ``yb' = bg * error_inv`` (letkf_core.f90:439-453), ``error_inv`` carrying
    the distance localization.  Accepted obs of zero weight still count
    (letkf_core.f90:455,542).  ``assim_v[v]`` switches off observed variables
    not assimilated into the analysis variable.  The active variables'
    slots are gathered with one flattened index ``v * R + idx``; indices of
    masked slots are clamped into range first and the slots zeroed after.
    """
    active = [v for v, a in enumerate(assim_v) if a]
    if not active:
        raise ValueError("accumulate_platform_terms called with no active vars")
    idx = nb.idx
    b, n = idx.shape
    r = stats.omm.shape[-1]
    k = stats.bg.shape[-1]
    av = torch.tensor(active, dtype=torch.int64, device=idx.device)
    idx_f = (av[None, :, None] * r
             + idx.clamp(0, r - 1)[:, None, :]).reshape(b, len(active) * n)
    omm = stats.omm.reshape(-1)[idx_f]                         # [B, Vn]
    err = stats.err.reshape(-1)[idx_f]
    val = stats.valid.reshape(-1)[idx_f] & nb.mask.repeat(1, len(active))
    bg = stats.bg.reshape(-1, k)[idx_f]                        # [B, Vn, k]
    einv = obs_error_inv_weight(nb.r2.repeat(1, len(active)), err,
                                weight_function)
    einv = torch.where(val, einv, 0.0).to(solver_dtype)
    yo = omm.to(solver_dtype) * einv
    yb = bg.to(solver_dtype) * einv[..., None]
    a_obs = torch.einsum("bnk,bnl->bkl", yb, yb)
    g = torch.einsum("bnk,bn->bk", yb, yo)
    return a_obs, g, val.sum(-1, dtype=torch.int32)
