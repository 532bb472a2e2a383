"""Synthetic miniature WRF ensembles on disk, for the drives.

The port's copy of the JAX package's test fixture (tests/wrf_fixtures.py):
classic NetCDF member files written with ``scipy.io.netcdf_file``, WSM5
microphysics by default; the same seed writes the same bytes.
"""
from __future__ import annotations

import numpy as np


def make_wrf_member(path, rng, nx=8, ny=7, nz=5, cen_lon=120.0, cen_lat=23.7,
                    dlat=0.05, mp_vars=("QRAIN", "QSNOW")):
    """Write one WRF-like member file (classic NetCDF, WSM5-compatible)."""
    from scipy.io import netcdf_file

    f = netcdf_file(path, "w", version=2)
    f.TITLE = "SYNTHETIC WRF"
    f.createDimension("Time", None)
    f.createDimension("DateStrLen", 19)
    f.createDimension("west_east", nx)
    f.createDimension("west_east_stag", nx + 1)
    f.createDimension("south_north", ny)
    f.createDimension("south_north_stag", ny + 1)
    f.createDimension("bottom_top", nz)
    f.createDimension("bottom_top_stag", nz + 1)

    times = f.createVariable("Times", "S1", ("Time", "DateStrLen"))
    times[0] = np.frombuffer(b"2026-08-17_00:00:00", dtype="S1")

    def mk(name, dims, data):
        v = f.createVariable(name, np.float32, ("Time",) + dims)
        v[:] = data[None].astype(np.float32)
        v.units = ""
        return v

    d2 = ("south_north", "west_east")
    d2u = ("south_north", "west_east_stag")
    d2v = ("south_north_stag", "west_east")
    d3 = ("bottom_top",) + d2
    d3w = ("bottom_top_stag",) + d2
    d3u = ("bottom_top",) + d2u
    d3v = ("bottom_top",) + d2v

    lons = cen_lon + (np.arange(nx) - nx / 2) * dlat
    lats = cen_lat + (np.arange(ny) - ny / 2) * dlat
    lon2, lat2 = np.meshgrid(lons, lats)  # [ny, nx]
    lons_u = cen_lon + (np.arange(nx + 1) - 0.5 - nx / 2) * dlat
    lats_v = cen_lat + (np.arange(ny + 1) - 0.5 - ny / 2) * dlat
    lon2u, lat2u = np.meshgrid(lons_u, lats)
    lon2v, lat2v = np.meshgrid(lons, lats_v)

    mk("XLONG", d2, lon2)
    mk("XLAT", d2, lat2)
    mk("XLONG_U", d2u, lon2u)
    mk("XLAT_U", d2u, lat2u)
    mk("XLONG_V", d2v, lon2v)
    mk("XLAT_V", d2v, lat2v)
    mk("HGT", d2, np.zeros((ny, nx)) + 50.0)
    mk("PSFC", d2, 1.0e5 + rng.normal(0, 100, (ny, nx)))
    mk("MU", d2, rng.normal(0, 50, (ny, nx)))
    mk("MUB", d2, np.full((ny, nx), 9.5e4))

    # base-state geopotential: z ~ 500 m levels
    zlev = np.arange(nz + 1) * 500.0 * 9.81
    phb = np.tile(zlev[:, None, None], (1, ny, nx))
    mk("PHB", d3w, phb)
    mk("PH", d3w, rng.normal(0, 20, (nz + 1, ny, nx)))
    mk("W", d3w, rng.normal(0, 0.5, (nz + 1, ny, nx)))
    mk("U", d3u, 5 + rng.normal(0, 2, (nz, ny, nx + 1)))
    mk("V", d3v, -3 + rng.normal(0, 2, (nz, ny + 1, nx)))
    mk("T", d3, 300 + rng.normal(0, 1, (nz, ny, nx)))
    pb = np.tile((1e5 - np.arange(nz) * 8e3)[:, None, None], (1, ny, nx))
    mk("PB", d3, pb)
    mk("P", d3, rng.normal(0, 50, (nz, ny, nx)))
    mk("QVAPOR", d3, np.abs(rng.normal(8e-3, 2e-3, (nz, ny, nx))))
    for q in mp_vars:
        mk(q, d3, rng.normal(1e-4, 3e-4, (nz, ny, nx)))  # some negatives

    f.flush()
    f.close()


def make_wrf_ensemble(tmpdir, k, seed=0, **kw):
    """``k`` members ``wrfinput_nc_###`` in ``tmpdir``; returns their paths."""
    rng = np.random.default_rng(seed)
    paths = []
    for m in range(k):
        p = f"{tmpdir}/wrfinput_nc_{m+1:03d}"
        make_wrf_member(p, rng, **kw)
        paths.append(p)
    return paths
