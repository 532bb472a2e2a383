"""Synthetic full-cycle case generator: a complete input directory on disk.

Port of the JAX package's ``synthetic_case.py`` (numpy and scipy only): with
the same arguments and seed it writes the same files, byte for byte.

Produces everything the CLI pipeline consumes (the reference's file layout,
cwb_letkf.f90:26,42,49-51): WRF-like member NetCDF files, ``input.nml``,
per-member GTS omboma files, and optional radar retrieval files — built
around a known truth so the analysis can be scored (RMSE vs truth must drop
near observations).

This is the no-real-data stand-in for BASELINE.json config #1 (idealized
grid + synthetic conventional obs); see examples/run_synthetic_cycle.py for
the end-to-end drive.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class SyntheticCase:
    input_dir: str
    k: int
    nx: int
    ny: int
    nz: int
    truth_t: np.ndarray        # [nz, ny, nx] truth temperature field
    obs_lon: np.ndarray
    obs_lat: np.ndarray


def _smooth(rng, ny, nx, n_bumps=6, scale=1.0, radius=0.25):
    """Sum of random Gaussian bumps — spatially correlated field."""
    y, x = np.mgrid[0:ny, 0:nx]
    f = np.zeros((ny, nx))
    for _ in range(n_bumps):
        cy, cx = rng.uniform(0, ny), rng.uniform(0, nx)
        amp = rng.normal(0, scale)
        r2 = ((y - cy) / (radius * ny)) ** 2 + ((x - cx) / (radius * nx)) ** 2
        f += amp * np.exp(-r2)
    return f


def _write_member(path, rng, nx, ny, nz, cen_lon, cen_lat, dlat, t_field):
    """One WRF-like member file; T perturbed by the given correlated field."""
    from scipy.io import netcdf_file

    f = netcdf_file(path, "w", version=2)
    f.TITLE = b"SYNTHETIC WRF"
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
        v.units = b""

    d2 = ("south_north", "west_east")
    d2u = ("south_north", "west_east_stag")
    d2v = ("south_north_stag", "west_east")
    d3 = ("bottom_top",) + d2
    d3w = ("bottom_top_stag",) + d2
    d3u = ("bottom_top",) + d2u
    d3v = ("bottom_top",) + d2v

    lons = cen_lon + (np.arange(nx) - nx / 2) * dlat
    lats = cen_lat + (np.arange(ny) - ny / 2) * dlat
    lon2, lat2 = np.meshgrid(lons, lats)
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

    zlev = np.arange(nz + 1) * 500.0 * 9.81
    mk("PHB", d3w, np.tile(zlev[:, None, None], (1, ny, nx)))
    mk("PH", d3w, rng.normal(0, 20, (nz + 1, ny, nx)))
    mk("W", d3w, rng.normal(0, 0.5, (nz + 1, ny, nx)))
    mk("U", d3u, 5 + rng.normal(0, 2, (nz, ny, nx + 1)))
    mk("V", d3v, -3 + rng.normal(0, 2, (nz, ny + 1, nx)))
    mk("T", d3, t_field)
    pb = np.tile((1e5 - np.arange(nz) * 8e3)[:, None, None], (1, ny, nx))
    mk("PB", d3, pb)
    mk("P", d3, rng.normal(0, 50, (nz, ny, nx)))
    mk("QVAPOR", d3, np.abs(rng.normal(8e-3, 2e-3, (nz, ny, nx))))
    mk("QRAIN", d3, rng.normal(1e-4, 3e-4, (nz, ny, nx)))
    mk("QSNOW", d3, rng.normal(1e-4, 3e-4, (nz, ny, nx)))
    f.flush()
    f.close()


_NML = """\
&control
 nmember          = {k}
 var_update       = 'T', 'QVAPOR'
 weight_function  = {wf}
 wrf_mp_physics   = 4
 write_analy_mean = T
/
&projection
 cen_lon  = {cen_lon}
 cen_lat  = {cen_lat}
 truelat1 = 10.0
 truelat2 = 40.0
 sta_lon  = {cen_lon}
/
&observations
 synop_nml %% use_it     = T
 synop_nml %% max_lz_pts = 60
 synop_nml %% hclr       = {hclr}., {hclr}.
 synop_nml %% vclr       = -1., -1.
 synop_nml %% t %% is_assim = T, F
 synop_nml %% q %% is_assim = F, T
 synop_nml %% t %% err_muti = 1.0
 synop_nml %% q %% err_muti = 1.0
/
&inflation
 multi_infl = 1.1, 1.1
 use_RTPS   = T, T
 RTPS       = 0.9, 0.9
 use_RTPP   = F, F
/
"""


def generate_case(
    input_dir: str,
    *,
    k: int = 8,
    nx: int = 24,
    ny: int = 20,
    nz: int = 6,
    n_obs: int = 40,
    seed: int = 0,
    cen_lon: float = 120.0,
    cen_lat: float = 23.7,
    dlat: float = 0.05,
    hclr_km: int = 30,
    weight_function: int = 0,
    bias: float = 1.5,
) -> SyntheticCase:
    """Write a complete synthetic input directory; returns the case record.

    Truth T = 300 K + a smooth anomaly; each member = truth + ``bias`` + a
    member-specific smooth perturbation (spatially correlated, so the
    ensemble covariance is informative).  Synop stations observe truth T
    (+0.2 K noise) at model level 0; per-member omb = obs - H(xb_m) with H =
    nearest-gridpoint sampling, exactly the file convention the GTS reader
    inverts (gts_omboma.f90:171).
    """
    from .obs.gts import GtsRecords, write_member_file

    os.makedirs(input_dir, exist_ok=True)
    rng = np.random.default_rng(seed)

    anomaly = _smooth(rng, ny, nx, scale=3.0)
    truth_t = 300.0 + np.tile(anomaly[None], (nz, 1, 1))
    members_t = []
    for m in range(k):
        pert = np.stack([_smooth(rng, ny, nx, scale=1.5)
                         for _ in range(nz)])
        members_t.append(truth_t + bias + pert)

    for m in range(k):
        _write_member(os.path.join(input_dir, f"wrfinput_nc_{m+1:03d}"),
                      rng, nx, ny, nz, cen_lon, cen_lat, dlat, members_t[m])

    with open(os.path.join(input_dir, "input.nml"), "w") as fh:
        fh.write(_NML.format(k=k, cen_lon=cen_lon, cen_lat=cen_lat,
                             hclr=hclr_km, wf=weight_function) % ())

    # stations on random interior gridpoints, observing truth at level 0
    ix = rng.integers(2, nx - 2, n_obs)
    iy = rng.integers(2, ny - 2, n_obs)
    lons = cen_lon + (ix - nx / 2) * dlat
    lats = cen_lat + (iy - ny / 2) * dlat
    t_obs = truth_t[0, iy, ix] + rng.normal(0, 0.2, n_obs)

    for m in range(k):
        rec = GtsRecords()
        hxb = members_t[m][0, iy, ix]
        for i in range(n_obs):
            rec.ids.append(f"S{i:03d}")
            rec.lat.append(float(lats[i]))
            rec.lon.append(float(lons[i]))
            rec.pre.append(1000.0)
            # synop vars (u, v, t, p, q): only T assimilated per namelist
            rec.obs.append([0.0, 0.0, float(t_obs[i]), 1000.0, 8e-3])
            rec.omb.append([0.0, 0.0, float(t_obs[i] - hxb[i]), 0.0, 0.0])
            rec.qc.append([0, 0, 0, 0, 0])
            rec.err.append([1.0, 1.0, 0.5, 1.0, 1e-3])
            rec.level.append(1)
        write_member_file(os.path.join(input_dir, f"gts_letkf_{m+1:03d}"),
                          {"synop": rec})

    return SyntheticCase(input_dir=input_dir, k=k, nx=nx, ny=ny, nz=nz,
                         truth_t=truth_t, obs_lon=lons, obs_lat=lats)


def score_case(case: SyntheticCase, output_dir: str) -> Dict[str, float]:
    """RMSE of prior-mean vs analysis-mean T against truth at level 0."""
    from .io.netcdf import NetcdfReader

    def mean_t0(paths):
        """Ensemble-mean T at model level 0, as [ny, nx]."""
        acc = None
        for p in paths:
            with NetcdfReader(p) as nc:
                t = nc.get_variable("T")        # [nx, ny, nz]
            acc = t if acc is None else acc + t
        return (acc / len(paths))[:, :, 0].T

    prior = mean_t0([os.path.join(case.input_dir, f"wrfinput_nc_{m+1:03d}")
                     for m in range(case.k)])
    analy = mean_t0([os.path.join(output_dir, f"wrfout_nc_{m+1:03d}")
                     for m in range(case.k)])
    t0 = case.truth_t[0]
    return {
        "rmse_prior": float(np.sqrt(((prior - t0) ** 2).mean())),
        "rmse_analysis": float(np.sqrt(((analy - t0) ** 2).mean())),
    }
