"""Per-observation statistics and QC, once per platform.

Port of ``ObsStats`` and ``platform_obs_stats`` of
the JAX package's ``ops/whiten.py`` (letkf_yoyb, module_letkf_core.f90:
429-437,497-510).  The reference re-derives each observation's ensemble
statistics and rejection at every gridpoint that sees it; they depend only on
the observation, so they are computed once here.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


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
