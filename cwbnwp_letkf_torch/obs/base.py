"""Observation containers shared by every platform (numpy, host side).

Port of the JAX package's ``obs/base.py``.  GTS platforms and radar volumes
both become sets of *records* (station or gate locations: the unit the
localization search and the ``max_lz_pts`` cap apply to), each carrying
``nvar`` observed quantities.  Radar has ``nvar = 1``, ``error = 1`` and
``qc = 0``; its configured error enters through ``err_muti``.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import NamedTuple, Optional, Tuple

import numpy as np

#: GTS platform families assimilated by the solver and their observed
#: variables in file/column order (module_letkf_core.f90:338-418).
GTS_FAMILY_VARS = {
    "synop": ("u", "v", "t", "p", "q"),
    "ships": ("u", "v", "t", "p", "q"),
    "metar": ("u", "v", "t", "p", "q"),
    "sound": ("u", "v", "t", "q"),
    "gpspw": ("tpw",),
}

RADAR_VARS = ("dbz", "vr", "zdr", "kdp")


class PlatformObs(NamedTuple):
    """Flat host arrays for one obs platform.

    Shapes (R = records, V = observed vars per record, K = ensemble size):
      xyz:   [R, 3]     projected x, y (meters) and altitude
      obs:   [V, R]     observed values
      error: [V, R]     file-supplied obs error (1.0 for radar)
      qc:    [V, R, K]  per-member QC flags (>= 0 is good; 0 for radar)
      hdxb:  [V, R, K]  per-member H(xb)
    """

    xyz: np.ndarray
    obs: np.ndarray
    error: np.ndarray
    qc: np.ndarray
    hdxb: np.ndarray

    @property
    def nrec(self) -> int:
        return self.xyz.shape[0]

    @property
    def nvar(self) -> int:
        return self.obs.shape[0]


@dataclass(frozen=True)
class PlatformStatic:
    """Hashable per-platform configuration for one LETKF run.

    Per-analysis-variable tuples are indexed by the position of the variable
    in ``var_update`` (config.f90:59-68).
    """

    name: str                      # 'synop' | ... | 'dbz' | 'vr' | ...
    kind: str                      # 'gts' | 'radar'
    nvar: int                      # observed quantities per record
    max_lz_pts: int                # localization cap (config.f90:9,30)
    hclr: Tuple[float, ...]        # [MAX_VARS] km, <=0 -> not assimilated
    vclr: Tuple[float, ...]        # [MAX_VARS] km, <=0 -> 2-D localization
    err_muti: Tuple[float, ...]    # [nvar] error multipliers
    err_rej: Tuple[float, ...]     # [nvar] rejection thresholds
    is_assim: Tuple[Tuple[bool, ...], ...]  # [nvar][MAX_VARS]
    is_dbz: bool = False           # reflectivity no-rain special cases

    def assim_mask(self, ivar: int) -> Tuple[bool, ...]:
        """Which observed variables feed analysis variable ``ivar``.

        A platform contributes only where ``hclr(ivar) > 0``
        (module_localization.f90:74) and ``is_assim(ivar)`` is set.
        """
        if self.hclr[ivar] <= 0.0:
            return tuple(False for _ in range(self.nvar))
        return tuple(self.is_assim[v][ivar] for v in range(self.nvar))

    def active(self, ivar: int) -> bool:
        return any(self.assim_mask(ivar))


def make_platform_obs(
    xyz: np.ndarray,
    obs: np.ndarray,
    hdxb: np.ndarray,
    error: Optional[np.ndarray] = None,
    qc: Optional[np.ndarray] = None,
    dtype=np.float32,
) -> PlatformObs:
    """Assemble a :class:`PlatformObs`, filling radar-style defaults."""
    obs = np.asarray(obs, dtype)
    if obs.ndim == 1:
        obs = obs[None, :]
    hdxb = np.asarray(hdxb, dtype)
    if hdxb.ndim == 2:
        hdxb = hdxb[None, :, :]
    v, r = obs.shape
    k = hdxb.shape[-1]
    if error is None:
        error = np.ones((v, r), dtype)
    else:
        error = np.asarray(error, dtype)
        if error.ndim == 1:
            error = error[None, :]
    if qc is None:
        qc = np.zeros((v, r, k), dtype)
    else:
        qc = np.asarray(qc, dtype)
        if qc.ndim == 2:
            qc = qc[None, :, :]
    return PlatformObs(
        xyz=np.asarray(xyz, dtype), obs=obs, error=error, qc=qc, hdxb=hdxb)


def _tuples(x):
    return tuple(_tuples(v) for v in x) if isinstance(x, (list, tuple)) else x


def from_reference(static_fields: dict, obs_arrays: dict):
    """The port's ``(PlatformStatic, PlatformObs)`` from the JAX package's.

    ``static_fields`` is ``dataclasses.asdict`` of a JAX-package
    ``PlatformStatic``; ``obs_arrays`` is ``PlatformObs._asdict()``.  Plain
    dicts in, so this module never imports the JAX package.
    """
    names = {f.name for f in fields(PlatformStatic)}
    if set(static_fields) != names:
        raise ValueError(f"static fields {sorted(static_fields)} != "
                         f"{sorted(names)}")
    static = PlatformStatic(**{n: _tuples(v) for n, v in static_fields.items()})
    obs = PlatformObs(**{n: np.asarray(obs_arrays[n])
                         for n in PlatformObs._fields})
    return static, obs
