"""Synthetic ensembles and observations for tests, benchmarks and dry runs.

Port of the JAX package's ``obs/synthetic.py`` (numpy and scipy, unchanged):
the same seed gives the same arrays in both packages.  Member perturbations
are spatially correlated (smooth random bumps), so the LETKF has real
covariance structure to work with.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..config import MAX_VARS
from .base import PlatformObs, PlatformStatic, make_platform_obs


def idealized_grid(nx: int, ny: int, nz: int, dx_m: float = 4e3,
                   dz_m: float = 500.0) -> np.ndarray:
    """Flattened [B, 3] Cartesian points for an idealized domain."""
    xs = (np.arange(nx) - nx / 2) * dx_m
    ys = (np.arange(ny) - ny / 2) * dx_m
    zs = np.arange(nz) * dz_m
    x, y, z = np.meshgrid(xs, ys, zs, indexing="ij")
    return np.stack([x.ravel(), y.ravel(), z.ravel()], 1).astype(np.float32)


def correlated_ensemble(
    rng: np.random.Generator,
    pts: np.ndarray,
    k: int,
    *,
    mean: float = 290.0,
    bias: float = -2.0,
    n_bumps: int = 12,
    length_m: float = 5e4,
    amp: float = 1.2,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (truth [B], xb [B, k]) with smooth member perturbations."""
    b = pts.shape[0]
    ext = np.abs(pts[:, :2]).max() + 1.0
    truth = mean + 5.0 * np.exp(
        -((pts[:, 0] / (0.4 * ext)) ** 2 + (pts[:, 1] / (0.4 * ext)) ** 2))
    members = []
    for _ in range(k):
        f = np.zeros(b)
        cx = rng.uniform(-ext, ext, n_bumps)
        cy = rng.uniform(-ext, ext, n_bumps)
        a = rng.normal(0, amp, n_bumps)
        for j in range(n_bumps):
            f += a[j] * np.exp(-(((pts[:, 0] - cx[j]) / length_m) ** 2
                                 + ((pts[:, 1] - cy[j]) / length_m) ** 2))
        members.append(truth + bias + f)
    return truth.astype(np.float32), np.stack(members, 1).astype(np.float32)


def synthetic_gts_platform(
    rng: np.random.Generator,
    pts: np.ndarray,
    truth: np.ndarray,
    xb: np.ndarray,
    *,
    name: str = "synop",
    nobs: int = 200,
    nvar: int = 1,
    obs_err: float = 0.5,
    hclr_km: float = 50.0,
    vclr_km: float = -1.0,
    max_lz_pts: int = 100,
    extent_frac: float = 0.5,
) -> Tuple[PlatformStatic, PlatformObs]:
    """Stations observing the truth; H(xb) = nearest-gridpoint member values."""
    ext = np.abs(pts[:, :2]).max() * extent_frac
    ox = rng.uniform(-ext, ext, nobs)
    oy = rng.uniform(-ext, ext, nobs)
    oz = rng.uniform(0.0, pts[:, 2].max() * 0.3 + 1.0, nobs)
    from scipy.spatial import cKDTree

    _, gi = cKDTree(pts).query(np.stack([ox, oy, oz], 1), k=1)
    obs = np.tile(truth[gi] + rng.normal(0, obs_err, nobs), (nvar, 1))
    hdxb = np.tile(xb[gi][None], (nvar, 1, 1))
    po = make_platform_obs(
        np.stack([ox, oy, oz], 1), obs, hdxb,
        error=np.full((nvar, nobs), obs_err),
        qc=np.zeros((nvar, nobs, xb.shape[1])))
    st = PlatformStatic(
        name=name, kind="gts", nvar=nvar, max_lz_pts=max_lz_pts,
        hclr=tuple([hclr_km] * MAX_VARS), vclr=tuple([vclr_km] * MAX_VARS),
        err_muti=tuple([1.0] * nvar), err_rej=tuple([5.0] * nvar),
        is_assim=tuple(tuple([True] * MAX_VARS) for _ in range(nvar)))
    return st, po
