"""The inputs of a cell, made from its configuration, its traffic and the seed.

One generator for every configuration and traffic file: a WRF ensemble held
in memory (member files would read back as these arrays), a slab domain
made on the device, and observation records: surface stations placed from
the seed, and the gates of a radar network's volume scans.  The same seed gives the same
inputs; the sizes never depend on the seed.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .reference.geometry import Lambert

#: WRF's moisture species that its reader clamps at zero (grid.f90:362-365)
CLAMPED = ("qr", "qs", "qg", "qh")
#: kilometres a degree of latitude
KM_PER_DEG = 111.2
#: the base state's pressure falls by e over this height
SCALE_HEIGHT_M = 8000.0
#: a radar beam's path under standard refraction bends as over an earth of
#: 4/3 the real radius
EFFECTIVE_RADIUS_M = 4.0 / 3.0 * 6.371e6


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy stream of the seed, one for each purpose."""
    return np.random.default_rng([int(seed), stream])


def correlated_members(r, x, y, k, *, mean, bias, n_bumps, length_m, amp):
    """``(truth [B], xb [B, k])`` float32 over horizontal positions ``x``,
    ``y``: a smooth truth and members that are the truth, a bias and
    ``n_bumps`` Gaussian bumps of ``length_m`` each (the generator of the
    bench case, obs/synthetic.py's ``correlated_ensemble``)."""
    ext = max(np.abs(x).max(), np.abs(y).max()) + 1.0
    truth = mean + 5.0 * np.exp(-((x / (0.4 * ext)) ** 2
                                  + (y / (0.4 * ext)) ** 2))
    members = []
    for _ in range(k):
        f = np.zeros(x.shape[0])
        cx = r.uniform(-ext, ext, n_bumps)
        cy = r.uniform(-ext, ext, n_bumps)
        a = r.normal(0, amp, n_bumps)
        for j in range(n_bumps):
            f += a[j] * np.exp(-(((x - cx[j]) / length_m) ** 2
                                 + ((y - cy[j]) / length_m) ** 2))
        members.append(truth + bias + f)
    return truth.astype(np.float32), np.stack(members, 1).astype(np.float32)


def _lev(f2: np.ndarray, n: int) -> np.ndarray:
    """``[x, y, k]`` repeated over ``n`` levels: ``[x, y, n, k]``."""
    return np.ascontiguousarray(np.repeat(f2[:, :, None, :], n, axis=2))


def wrf_case(cfg: dict, seed: int) -> dict:
    """A Milbrandt WRF ensemble on the configuration's grid, in memory:
    ``geo`` (longitude, latitude of each stagger, terrain), ``fields`` (full
    p, ph and mu, the base states added, negative hydrometeors clamped, as
    a WRF reader gives them), the base states ``pb``, ``phb``, ``mub``, the
    truth of T ``[nx, ny]``, T's members at the surface ``[nx, ny, k]`` and
    the mass grid's projected x and y.

    The grid is ``dx_km`` apart in both directions around the projection's
    centre, its levels ``dz_m`` apart.  Every field is one smooth member
    perturbation ``dm`` on its own offset and scale; T is the members
    themselves, near 290 K.
    """
    g = cfg["grid"]
    nx, ny, nz, k = g["nx"], g["ny"], g["nz"], cfg["nmember"]
    dz = g["dz_m"]
    pj = cfg["projection"]
    dlat = g["dx_km"] / KM_PER_DEG
    dlon = dlat / np.cos(np.deg2rad(pj["cen_lat"]))
    lon = pj["cen_lon"] + (np.arange(nx) - nx / 2) * dlon
    lat = pj["cen_lat"] + (np.arange(ny) - ny / 2) * dlat
    lon_u = pj["cen_lon"] + (np.arange(nx + 1) - 0.5 - nx / 2) * dlon
    lat_v = pj["cen_lat"] + (np.arange(ny + 1) - 0.5 - ny / 2) * dlat
    geo = {}
    for sfx, (xs, ys) in (("", (lon, lat)), ("_u", (lon_u, lat)),
                          ("_v", (lon, lat_v))):
        lo, la = np.meshgrid(xs, ys, indexing="ij")
        geo["xlon" + sfx] = lo.astype(np.float32)
        geo["xlat" + sfx] = la.astype(np.float32)
    geo["hgt"] = np.zeros((nx, ny), np.float32)
    gx, gy = Lambert.of(**pj).xy(geo["xlon"], geo["xlat"])
    truth, xb = correlated_members(rng(seed, 0), gx.ravel().astype(np.float64),
                                   gy.ravel().astype(np.float64), k,
                                   **cfg["members"])
    t_xb = xb.reshape(nx, ny, k)
    dm = t_xb - np.float32(cfg["members"]["mean"])               # [nx, ny, k]
    lev = np.arange(nz + 1)
    pb = np.broadcast_to(
        (1e5 * np.exp(-dz * (lev[:nz] + 0.5) / SCALE_HEIGHT_M)).astype(
            np.float32), (nx, ny, nz)).copy()
    phb = np.broadcast_to((9.81 * dz * lev).astype(np.float32),
                          (nx, ny, nz + 1)).copy()
    mub = np.full((nx, ny), 9.5e4, np.float32)
    f = {
        "t": _lev(t_xb, nz),
        "u": _lev(np.concatenate([dm, dm[-1:]], 0), nz) + np.float32(5.0),
        "v": _lev(np.concatenate([dm, dm[:, -1:]], 1), nz) - np.float32(3.0),
        "w": _lev(np.float32(0.1) * dm, nz + 1),
        "ph": _lev(np.float32(2.0) * dm, nz + 1) + phb[..., None],
        "p": _lev(np.float32(50.0) * dm, nz) + pb[..., None],
        "mu": np.float32(50.0) * dm + mub[..., None],
        "psfc": np.float32(1e5) + np.float32(100.0) * dm,
        "qv": _lev(np.float32(8e-3) + np.float32(1e-3) * dm, nz),
    }
    for key in ("qr", "qs", "qg", "qh", "nqr", "nqs", "nqg", "nqh"):
        scale = np.float32(1e3 if key.startswith("n") else 1e-4)
        f[key] = _lev(scale * (np.float32(1.0) + np.float32(0.5) * dm), nz)
        if key in CLAMPED:
            np.clip(f[key], 0.0, None, out=f[key])
    return dict(geo=geo, fields=f, pb=pb, phb=phb, mub=mub,
                truth=truth.reshape(nx, ny), t_xb=t_xb, gx=gx, gy=gy)


def radar_gates(radar: dict, proj: Lambert, lo, hi, top: float):
    """``(xy [G, 2], height [G])`` of every gate of the network's volume
    scans whose centre lies over the box ``lo``-``hi`` (projected meters)
    and under ``top``: each site scans its elevations over azimuths
    ``beam_deg`` apart, with gates ``gate_km`` apart out to ``range_km``,
    along beams bent by standard refraction (4/3 of the earth's radius).
    The gates depend on the traffic file alone, never on the seed."""
    re = EFFECTIVE_RADIUS_M
    r = (np.arange(int(radar["range_km"] / radar["gate_km"])) + 0.5) \
        * radar["gate_km"] * 1e3
    az = np.deg2rad((np.arange(int(round(360.0 / radar["beam_deg"]))) + 0.5)
                    * radar["beam_deg"])
    xy, height = [], []
    for lon, lat, alt in radar["sites"]:
        sx, sy = proj.xy(np.float64(lon), np.float64(lat))
        for el in np.deg2rad(radar["elevations_deg"]):
            h = np.sqrt(r * r + re * re + 2.0 * r * re * np.sin(el)) - re
            s = re * np.arcsin(r * np.cos(el) / (re + h))      # along the ground
            x = sx + np.sin(az)[:, None] * s[None]
            y = sy + np.cos(az)[:, None] * s[None]
            z = np.broadcast_to(h + alt, x.shape)
            keep = ((x >= lo[0]) & (x <= hi[0]) & (y >= lo[1]) & (y <= hi[1])
                    & (z < top))
            xy.append(np.stack([x[keep], y[keep]], 1))
            height.append(z[keep])
    return np.concatenate(xy), np.concatenate(height)


def reflectivity(t: np.ndarray, rain: dict, edge: float,
                 norain_value: float) -> np.ndarray:
    """dBZ of a column whose T is ``t``: ``norain_value`` below the rain
    area's edge ``edge``, else ``dbz_at_edge`` rising ``dbz_per_k`` a
    kelvin above it."""
    z = rain["dbz_at_edge"] + rain["dbz_per_k"] * (t - edge)
    return np.where(t >= edge, z, norain_value).astype(np.float32)


def column_obs(cfg: dict, traffic: dict, case: dict, seed: int) -> Dict[str, dict]:
    """Each traffic platform's records over the projected domain, as a
    platform's parsed records: ``xyz [R, 3]``, ``obs``, ``error`` ``[V, R]``,
    ``qc``, ``hdxb`` ``[V, R, k]``.

    A ``stations`` platform has ``per_10000_km2`` stations of the domain's
    area at heights ``alt_m``, placed from the seed.  A ``radar`` platform
    has the gates of the traffic's ``radar`` network (:func:`radar_gates`):
    all of them (``gates: "all"``) or those in rain (``"echo"``).  Rain
    falls where T's truth is in the top ``echo_share`` of the domain's
    columns.  Every record observes the nearest column: T's truth with the
    platform's error, H(xb) T's members there; reflectivity observes and
    maps both by :func:`reflectivity`, ``norain_value`` exactly where no
    rain falls.  The records' places and number never depend on the seed's
    values: only stations' places and every observation error do."""
    from scipy.spatial import cKDTree

    g = cfg["grid"]
    k = cfg["nmember"]
    gx, gy = case["gx"], case["gy"]
    truth = case["truth"].ravel()
    members = case["t_xb"].reshape(-1, k)
    tree = cKDTree(np.stack([gx.ravel(), gy.ravel()], 1))
    lo = np.array([gx.min(), gy.min()], np.float64)
    hi = np.array([gx.max(), gy.max()], np.float64)
    top = g["nz"] * g["dz_m"]
    rain = traffic.get("rain")
    edge = (np.quantile(truth, 1.0 - rain["echo_share"]) if rain else None)
    out = {}
    for i, (name, want) in enumerate(sorted(traffic["platforms"].items())):
        p = cfg["platforms"][name]
        r = rng(seed, 10 + i)
        nvar = len(p["vars"]) if p["kind"] == "gts" else 1
        if want["layout"] == "stations":
            area_km2 = float(np.prod(hi - lo)) * 1e-6
            n = int(round(want["per_10000_km2"] * area_km2 / 1e4))
            xy = r.uniform(lo, hi, (n, 2))
            alt = np.full(n, float(want["alt_m"]))
        else:
            xy, alt = radar_gates(traffic["radar"],
                                  Lambert.of(**cfg["projection"]), lo, hi, top)
        _, gi = tree.query(xy, k=1)
        if want["layout"] == "radar" and want["gates"] == "echo":
            wet = truth[gi] >= edge
            xy, alt, gi = xy[wet], alt[wet], gi[wet]
        n = gi.shape[0]
        noise = r.normal(0.0, p["error"], (nvar, n))
        if name == "dbz":
            norain = cfg["norain_value"]
            obs = reflectivity(truth[gi], rain, edge, norain)[None]
            obs = np.where(obs == norain, obs, obs + noise)
            hdxb = reflectivity(members[gi], rain, edge, norain)
        else:
            obs = truth[gi][None] + noise
            hdxb = members[gi]
        error = (np.full((nvar, n), p["error"]) if p["kind"] == "gts"
                 else np.ones((nvar, n)))
        out[name] = dict(
            xyz=np.column_stack([xy, alt]).astype(np.float32),
            obs=obs.astype(np.float32), error=error.astype(np.float32),
            qc=np.zeros((nvar, n, k), np.float32),
            hdxb=np.repeat(hdxb[None], nvar, 0))
    return out


def namelist(cfg: dict) -> str:
    """The configuration as a reference-format ``input.nml``: control,
    projection, every configured platform with its cap, radii, error and
    rejection threshold, and the inflation."""
    names = cfg["var_update"]
    nv = len(names)

    def row(vals):
        return ", ".join(f"{v:g}" for v in vals)

    lines = ["&control", f" nmember = {cfg['nmember']}",
             " var_update = " + ", ".join(f"'{v}'" for v in names),
             f" weight_function = {cfg['weight_function']}",
             f" wrf_mp_physics = {cfg['wrf_mp_physics']}",
             f" norain_value = {cfg['norain_value']}",
             " write_analy_mean = T", "/", "&projection"]
    lines += [f" {key} = {val}" for key, val in cfg["projection"].items()]
    lines += ["/", "&observations"]
    for name, p in sorted(cfg["platforms"].items()):
        h, v = radii(cfg, name)
        nml = f"radar_nml % {name}" if p["kind"] == "radar" else f"{name}_nml"
        lines += [f" {nml} % use_it = T", f" {nml} % max_lz_pts = {p['max_lz_pts']}",
                  f" {nml} % hclr = {row(h)}", f" {nml} % vclr = {row(v)}"]
        if p["kind"] == "radar":
            lines += [f" {nml} % error = {p['error']}",
                      f" {nml} % err_rej = {p['err_rej']}"]
        else:
            for var in p["vars"]:
                lines += [f" {nml} % {var} % is_assim = {nv}*T",
                          f" {nml} % {var} % err_muti = {p['err_muti']}",
                          f" {nml} % {var} % err_rej = {p['err_rej']}"]
    infl = cfg["inflation"]
    lines += ["/", "&inflation", f" multi_infl = {row(infl['multi_infl'])}",
              f" use_rtpp = {nv}*T", f" rtpp_alpha = {nv}*{infl['rtpp_alpha']}",
              f" use_rtps = {nv}*T", f" rtps_alpha = {nv}*{infl['rtps_alpha']}",
              "/", ""]
    return "\n".join(lines)


def radii(cfg: dict, platform: str):
    """``(hclr, vclr)`` km per analysis variable of one platform; -1 where
    the platform does not update the variable."""
    names = cfg["var_update"]
    h, v = [-1.0] * len(names), [-1.0] * len(names)
    for group in cfg["localization"]:
        if platform in group["radii_km"]:
            for name in group["vars"]:
                h[names.index(name)], v[names.index(name)] = \
                    group["radii_km"][platform]
    return h, v


def reference_platforms(cfg: dict, records: Dict[str, dict], device):
    """The reference's view of each platform's records: the raw arrays with
    the errors, rejection thresholds, caps and radii the configuration
    states (a radar's error is its multiplier on unit file errors)."""
    from .reference import letkf as ref

    out = []
    for name, r in sorted(records.items()):
        p = cfg["platforms"][name]
        h, v = radii(cfg, name)
        nvar = r["obs"].shape[0]
        out.append(ref.platform(
            name, r["xyz"], r["obs"], r["error"], r["qc"], r["hdxb"],
            err_muti=[p["err_muti"] if p["kind"] == "gts" else p["error"]]
            * nvar, err_rej=[p["err_rej"]] * nvar,
            max_lz_pts=p["max_lz_pts"], hclr=h, vclr=v,
            assim=[[True] * len(h)] * nvar, is_dbz=name == "dbz",
            norain_value=cfg["norain_value"], device=device))
    return out


def slab_case(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The slab configuration's domain on ``device``: its grid points
    ``pts [B, 3]`` (x slowest, height fastest), the members ``xb [B, k]``
    (:func:`correlated_members`' field over the columns, the same at every
    height) and each traffic platform's records at grid points drawn from
    the seed, moved by Gaussian ``jitter_m``; H(xb) is that point's members.
    Everything in float32, made on the device by one generator."""
    g = cfg["grid"]
    nx, ny, nz, k = g["nx"], g["ny"], g["nz"], cfg["nmember"]
    m = cfg["members"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    f32 = dict(dtype=torch.float32, device=device)
    xs = (torch.arange(nx, **f32) - nx / 2) * g["dx_m"]
    ys = (torch.arange(ny, **f32) - ny / 2) * g["dx_m"]
    zs = torch.arange(nz, **f32) * g["dz_m"]
    pts = torch.stack(torch.meshgrid(xs, ys, zs, indexing="ij"), -1).reshape(-1, 3)
    cx, cy = (c.reshape(-1) for c in torch.meshgrid(xs, ys, indexing="ij"))
    ext = float(max(xs.abs().max(), ys.abs().max())) + 1.0
    truth = m["mean"] + 5.0 * torch.exp(-((cx / (0.4 * ext)) ** 2
                                          + (cy / (0.4 * ext)) ** 2))
    bx = (torch.rand((m["n_bumps"], k), generator=gen, **f32) * 2 - 1) * ext
    by = (torch.rand((m["n_bumps"], k), generator=gen, **f32) * 2 - 1) * ext
    amp = torch.randn((m["n_bumps"], k), generator=gen, **f32) * m["amp"]
    cols = truth[:, None] + m["bias"]                          # [C, k]
    for j in range(m["n_bumps"]):
        cols = cols + amp[j] * torch.exp(
            -(((cx[:, None] - bx[j]) / m["length_m"]) ** 2
              + ((cy[:, None] - by[j]) / m["length_m"]) ** 2))
    xb = cols.repeat_interleave(nz, dim=0)                     # [B, k]
    recs = {}
    for name, want in sorted(traffic["platforms"].items()):
        p = cfg["platforms"][name]
        n = want["records"]
        gi = torch.randint(0, pts.shape[0], (n,), generator=gen, device=device)
        xyz = pts[gi] + torch.randn((n, 3), generator=gen, **f32) * want["jitter_m"]
        obs = truth[gi // nz] + torch.randn(n, generator=gen, **f32) * p["error"]
        recs[name] = dict(xyz=xyz, obs=obs[None], error=torch.ones((1, n), **f32),
                          qc=torch.zeros((1, n, k), **f32), hdxb=xb[gi][None])
    return dict(pts=pts, xb=xb, records=recs)
