"""Lambert conformal conic projection, vectorized over numpy arrays.

Port of the JAX package's ``projection.py`` (module_projection.f90:21-50).
The map takes (lon, lat) in degrees to planar meters so grid points and
observations share one Cartesian frame for the localization distances.
With two standard parallels lat1, lat2, standard longitude lon0 and origin
latitude lat0 (the ``projection`` namelist):

    n   = ln(cos lat1 / cos lat2) / ln(tan(pi/4 + lat2/2) / tan(pi/4 + lat1/2))
    F   = cos(lat1) * tan(pi/4 + lat1/2)^n / n
    rh0 = R * F / tan(pi/4 + lat0/2)^n
    rh  = R * F / tan(pi/4 + lat/2)^n
    x   = rh * sin(n * (lon - lon0))
    y   = rh0 - rh * cos(n * (lon - lon0))

The arithmetic runs in the inputs' dtype: float32 for the WRF ``XLAT`` /
``XLONG`` fields, as in the JAX package.  numpy's float32 sine, cosine, exp
and log are not XLA's, so x and y may differ from the JAX package's by a few
float32 ulps (well under a meter at 1e6 m).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

from .config import ProjectionConfig
from .constants import D2R, EARTH_RADIUS


class LambertProjection(NamedTuple):
    """Precomputed projection constants (proj_init, projection.f90:21-35)."""

    lon0: float
    n: float
    f: float
    rh0: float

    @staticmethod
    def from_config(cfg: ProjectionConfig) -> "LambertProjection":
        lat0 = cfg.cen_lat * D2R
        lat1 = cfg.truelat1 * D2R
        lat2 = cfg.truelat2 * D2R
        lon0 = cfg.sta_lon * D2R
        n = math.log(math.cos(lat1) / math.cos(lat2)) / math.log(
            math.tan(0.5 * (0.5 * math.pi + lat2))
            / math.tan(0.5 * (0.5 * math.pi + lat1)))
        f = math.cos(lat1) * math.tan(0.5 * (0.5 * math.pi + lat1)) ** n / n
        rh0 = EARTH_RADIUS * f / math.tan(0.5 * (0.5 * math.pi + lat0)) ** n
        return LambertProjection(lon0=lon0, n=n, f=f, rh0=rh0)

    def lonlat_to_xy(self, lon, lat):
        """Map lon/lat (degrees, broadcastable arrays) -> (x, y) meters.

        Mirrors lonlat_to_xy (projection.f90:37-50).  Python-float
        constants keep the arrays' dtype.
        """
        lon = np.asarray(lon)
        lat = np.asarray(lat)
        lat_r = lat * D2R
        # rh = R * F * cotan(pi/4 + lat/2)^n, via exp/log like the reference
        cot = 1.0 / np.tan(0.5 * (0.5 * math.pi + lat_r))
        rh = EARTH_RADIUS * self.f * np.exp(self.n * np.log(cot))
        dlon = self.n * (lon * D2R - self.lon0)
        x = rh * np.sin(dlon)
        y = self.rh0 - rh * np.cos(dlon)
        return x, y
