"""Vertical/horizontal analysis coordinates per stagger class.

Port of the JAX package's ``models/vcoord.py`` (numpy): the reference's
``letkf_scatter_vcoord`` / ``letkf_scatter_hcoord``
(module_mpi_util.f90:360-580) without the MPI scatter: the
altitude of every analysis point comes from the **ensemble-mean full
geopotential / g** (mpi_util.f90:529-530), at w-levels for W/PH (stagger 1)
or averaged to mass levels otherwise (mpi_util.f90:534-539); MU uses the
terrain height (stagger -1, mpi_util.f90:542-578).

Stagger quirk (replicated by default, see config.replicate_stagger_quirk):
the reference analyzes U/V only over the *unstaggered* local extent and
reuses the unstaggered column's altitude (letkf_core.f90:188-206,209-210) —
the extra staggered column/row keeps its background.  The clean mode updates
every staggered point, using the nearest unstaggered column's altitude.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..constants import GRAVITY
from .state import WrfEnsemble


def mean_geopotential_height(ens: WrfEnsemble) -> np.ndarray:
    """Ensemble-mean z at w-levels: mean(ph_full)/g  [nx, ny, nz+1].

    Works for both the eager :class:`.state.WrfEnsemble` and the
    streaming variant, which takes the same float32 mean at open.
    """
    return (ens.mean_ph() / GRAVITY).astype(np.float32)


def mass_level_height(z_w: np.ndarray) -> np.ndarray:
    """Adjacent-average to mass levels (mpi_util.f90:538)  [nx, ny, nz]."""
    return (0.5 * (z_w[:, :, 1:] + z_w[:, :, :-1])).astype(np.float32)


def analysis_points(
    ens: WrfEnsemble,
    proj,
    hstag: int,
    vstag: int,
    z_w: np.ndarray,
    *,
    quirk: bool = True,
) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """Flattened [B, 3] (x, y, alt) points for one variable's update region.

    Returns (points, (ux, uy, uz)) where the u* are the extents of the
    updated region in the variable's own array (C-order flattening over
    (x, y, z), z fastest).  With the stagger quirk on, U/V update only
    (nx, ny) of their (nx+1, ny)/(nx, ny+1) arrays (letkf_core.f90:209-210).
    """
    nx, ny, nz = ens.nx, ens.ny, ens.nz

    if hstag == 1:
        lat, lon = ens.xlat_u, ens.xlon_u
    elif hstag == 2:
        lat, lon = ens.xlat_v, ens.xlon_v
    else:
        lat, lon = ens.xlat, ens.xlon

    if vstag == 1:
        alt = z_w                          # [nx, ny, nz+1]
        uz = nz + 1
    elif vstag == -1:
        alt = ens.hgt[:, :, None]          # [nx, ny, 1] terrain
        uz = 1
    else:
        alt = mass_level_height(z_w)       # [nx, ny, nz]
        uz = nz

    if hstag == 1:
        if quirk:
            lat, lon = lat[:nx, :], lon[:nx, :]
            ux, uy = nx, ny
        else:
            alt = np.concatenate([alt, alt[-1:, :, :]], axis=0)
            ux, uy = nx + 1, ny
    elif hstag == 2:
        if quirk:
            lat, lon = lat[:, :ny], lon[:, :ny]
            ux, uy = nx, ny
        else:
            alt = np.concatenate([alt, alt[:, -1:, :]], axis=1)
            ux, uy = nx, ny + 1
    else:
        ux, uy = nx, ny

    x, y = proj.lonlat_to_xy(lon, lat)   # float32, as the fields are
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)

    pts = np.empty((ux, uy, uz, 3), np.float32)
    pts[..., 0] = x[:, :, None]
    pts[..., 1] = y[:, :, None]
    pts[..., 2] = alt
    return pts.reshape(-1, 3), (ux, uy, uz)
