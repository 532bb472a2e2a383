"""Where a WRF ensemble's analysis points are: the reference's own reckoning.

From the grids of longitude and latitude and the members' geopotential that
the benchmark generated, as the reference system places them
(module_mpi_util.f90:360-580, module_letkf_core.f90:188-210): the Lambert
conformal projection of each stagger's longitude and latitude
(module_projection.f90:21-50), the height of the members' mean full
geopotential over g at the w levels, halved between them for mass levels,
the terrain for the surface field; U and V analysed over the mass grid's
extent only, their extra column or row left as it is.

The arithmetic is float32, as the WRF fields are.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import numpy as np

GRAVITY = 9.81
EARTH_RADIUS = 6.37122e6
D2R = math.pi / 180.0


class VarSpec(NamedTuple):
    field: str    # key of the ensemble's fields
    hstag: int    # 0 mass, 1 U (nx + 1), 2 V (ny + 1)
    vstag: int    # 0 mass levels, 1 w levels (nz + 1), -1 the surface
    moisture: bool


#: the analysis variables of the namelist's var_update
#: (module_letkf_core.f90:74-162, 243-291)
VARIABLES: Dict[str, VarSpec] = {
    "U": VarSpec("u", 1, 0, False), "V": VarSpec("v", 2, 0, False),
    "W": VarSpec("w", 0, 1, False), "T": VarSpec("t", 0, 0, False),
    "P": VarSpec("p", 0, 0, False), "PH": VarSpec("ph", 0, 1, False),
    "MU": VarSpec("mu", 0, -1, False), "QVAPOR": VarSpec("qv", 0, 0, True),
    "QRAIN": VarSpec("qr", 0, 0, True), "QSNOW": VarSpec("qs", 0, 0, True),
    "QGRAUP": VarSpec("qg", 0, 0, True), "QHAIL": VarSpec("qh", 0, 0, True),
    "QNRAIN": VarSpec("nqr", 0, 0, True),
    "QNSNOW": VarSpec("nqs", 0, 0, True),
    "QNGRAUPEL": VarSpec("nqg", 0, 0, True),
    "QNHAIL": VarSpec("nqh", 0, 0, True),
}


class Lambert(NamedTuple):
    lon0: float
    n: float
    f: float
    rh0: float

    @staticmethod
    def of(cen_lat, truelat1, truelat2, sta_lon, **_) -> "Lambert":
        lat0, lat1, lat2 = (v * D2R for v in (cen_lat, truelat1, truelat2))
        def t(lat):
            return math.tan(0.5 * (0.5 * math.pi + lat))

        n = math.log(math.cos(lat1) / math.cos(lat2)) / math.log(t(lat2)
                                                                 / t(lat1))
        f = math.cos(lat1) * t(lat1) ** n / n
        rh0 = EARTH_RADIUS * f / t(lat0) ** n
        return Lambert(lon0=sta_lon * D2R, n=n, f=f, rh0=rh0)

    def xy(self, lon: np.ndarray, lat: np.ndarray):
        """Meters east and north of the origin, in the arrays' dtype."""
        cot = 1.0 / np.tan(0.5 * (0.5 * math.pi + lat * D2R))
        rh = EARTH_RADIUS * self.f * np.exp(self.n * np.log(cot))
        dlon = self.n * (lon * D2R - self.lon0)
        return rh * np.sin(dlon), self.rh0 - rh * np.cos(dlon)


def extent(spec: VarSpec, nx: int, ny: int, nz: int) -> Tuple[int, int, int]:
    """The analysed extent of a variable's array (x, y, z)."""
    return nx, ny, {0: nz, 1: nz + 1, -1: 1}[spec.vstag]


def points(spec: VarSpec, flat: np.ndarray, geo: dict, z_w: np.ndarray,
           proj: Lambert) -> np.ndarray:
    """``[P, 3]`` float32 (x, y, height) of the analysis points ``flat``,
    indices into the variable's analysed extent in C order (x, y, z)."""
    nx, ny, nz = z_w.shape[0], z_w.shape[1], z_w.shape[2] - 1
    ux, uy, uz = extent(spec, nx, ny, nz)
    i, j, l = np.unravel_index(flat, (ux, uy, uz))
    sfx = {0: "", 1: "_u", 2: "_v"}[spec.hstag]
    x, y = proj.xy(geo["xlon" + sfx][i, j], geo["xlat" + sfx][i, j])
    if spec.vstag == 1:
        z = z_w[i, j, l]
    elif spec.vstag == -1:
        z = geo["hgt"][i, j]
    else:
        z = (np.float32(0.5) * (z_w[i, j, l + 1] + z_w[i, j, l]))
    return np.stack([x, y, z], 1).astype(np.float32)


def w_level_height(ph_full: np.ndarray) -> np.ndarray:
    """Height of the members' mean full geopotential, ``[nx, ny, nz + 1]``:
    ``mean(ph) / g`` (module_mpi_util.f90:529-530)."""
    return (ph_full.mean(axis=-1) / GRAVITY).astype(np.float32)
