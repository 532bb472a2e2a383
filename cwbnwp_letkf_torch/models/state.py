"""WRF ensemble state: container + reader/writer + microphysics table.

Port of the JAX package's ``models/state.py`` (numpy, unchanged): the
reference's ``module_grid.f90``.  The reference holds one member per MPI rank and transposes to
domain layout with ``mpi_alltoallv``; here the whole ensemble lives in
``[x, y, z, k]`` host arrays (members read concurrently by a thread pool)
that feed the device-resident sharded update directly.

Semantics preserved:
* full fields formed on read: ``p = P + PB``, ``ph = PH + PHB``,
  ``mu = MU + MUB`` (grid.f90:500-502); subtracted back on write
  (grid.f90:521-523);
* negative hydrometeors clamped to zero on read (grid.f90:362-365);
* microphysics-scheme capability table (which hydrometeor species and
  moments exist per WRF ``mp_physics`` option, grid.f90:61-224);
* dry-air density derivation for 2-moment schemes via the hypsometric
  relation, opts 1 and 2 (grid.f90:369-494);
* member analysis files clone the input header and byte-copy untouched
  variables (grid.f90:506-658); optional ensemble-mean file (grid.f90:660-927).
"""
from __future__ import annotations

import concurrent.futures as cf
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import LetkfConfig
from ..constants import (
    CP,
    CVPM,
    P1000MB,
    R_D,
    WRF_MP_GSFCGCE,
    WRF_MP_LIN,
    WRF_MP_MILBRANDT,
    WRF_MP_MORR,
    WRF_MP_THOMPSON,
    WRF_MP_WDM5,
    WRF_MP_WDM6,
    WRF_MP_WSM5,
    WRF_MP_WSM6,
)
from ..io.netcdf import NetcdfReader, NetcdfWriter


@dataclass(frozen=True)
class MpScheme:
    """Microphysics capability flags (define_wrf_mp_physics, grid.f90:61-224)."""

    graupel: bool
    hail: bool
    moment_r: int = 1
    moment_s: int = 1
    moment_g: int = 1
    moment_h: int = 1

    @property
    def any_double_moment(self) -> bool:
        return max(self.moment_r, self.moment_s,
                   self.moment_g, self.moment_h) >= 2

    @staticmethod
    def from_option(mp_physics: int, hail_opt: int = 0) -> "MpScheme":
        g_or_h = (hail_opt == 0, hail_opt != 0)  # (graupel, hail)
        table = {
            WRF_MP_LIN: MpScheme(True, False),
            WRF_MP_WSM5: MpScheme(False, False),
            WRF_MP_WSM6: MpScheme(*g_or_h),
            WRF_MP_GSFCGCE: MpScheme(*g_or_h),
            WRF_MP_THOMPSON: MpScheme(True, False, moment_r=2),
            WRF_MP_MILBRANDT: MpScheme(True, True, 2, 2, 2, 2),
            WRF_MP_MORR: MpScheme(*g_or_h, 2, 2, 2, 2),
            WRF_MP_WDM5: MpScheme(False, False, moment_r=2),
            WRF_MP_WDM6: MpScheme(*g_or_h, moment_r=2),
        }
        if mp_physics not in table:
            raise ValueError(
                f"unsupported wrf_mp_physics={mp_physics}; supported: "
                f"{sorted(table)} (grid.f90:218-222 aborts likewise)")
        return table[mp_physics]

    def field_names(self) -> List[str]:
        """3-D hydrometeor/moment fields present for this scheme."""
        out = ["qr", "qs"]
        if self.graupel:
            out.append("qg")
        if self.hail:
            out.append("qh")
        if self.moment_r >= 2:
            out.append("nqr")
        if self.moment_s >= 2:
            out.append("nqs")
        if self.graupel and self.moment_g >= 2:
            out.append("nqg")
        if self.hail and self.moment_h >= 2:
            out.append("nqh")
        return out


#: field key -> WRF NetCDF variable name
FIELD_TO_NC = {
    "u": "U", "v": "V", "w": "W", "t": "T", "p": "P", "ph": "PH",
    "mu": "MU", "qv": "QVAPOR", "qr": "QRAIN", "qs": "QSNOW",
    "qg": "QGRAUP", "qh": "QHAIL", "nqr": "QNRAIN", "nqs": "QNSNOW",
    "nqg": "QNGRAUPEL", "nqh": "QNHAIL", "psfc": "PSFC",
}


@dataclass
class WrfEnsemble:
    """Full-domain ensemble state, member axis last.

    ``fields``: per-field ``[X, Y, (Z,) k]`` float32 arrays holding *full*
    p/ph/mu (base state added).  ``pb/phb/mub`` are the (member-1) base
    states needed to convert back on write.
    """

    nx: int
    ny: int
    nz: int
    k: int
    mp: MpScheme
    fields: Dict[str, np.ndarray]
    pb: np.ndarray            # [nx, ny, nz]
    phb: np.ndarray           # [nx, ny, nz+1]
    mub: np.ndarray           # [nx, ny]
    xlat: np.ndarray          # [nx, ny]
    xlon: np.ndarray
    xlat_u: np.ndarray        # [nx+1, ny]
    xlon_u: np.ndarray
    xlat_v: np.ndarray        # [nx, ny+1]
    xlon_v: np.ndarray
    hgt: np.ndarray           # [nx, ny] terrain height
    rhoa: Optional[np.ndarray] = None   # [nx, ny, nz, k] dry-air density
    member_paths: Tuple[str, ...] = ()

    def field(self, key: str) -> np.ndarray:
        return self.fields[key]

    def mean(self, key: str) -> np.ndarray:
        return self.fields[key].mean(axis=-1)

    def mean_ph(self) -> np.ndarray:
        """Ensemble-mean full geopotential [nx, ny, nz+1]."""
        return self.fields["ph"].mean(axis=-1)

    # -- group load/store (the driver's only state access) ------------------
    def load_group(self, specs, ux: int, uy: int, uz: int) -> np.ndarray:
        """Background for one variable group as one ``[B, V, k]`` staging
        buffer (B = ux*uy*uz) — a single host array, one device transfer."""
        xb = np.empty((ux * uy * uz, len(specs), self.k), np.float32)
        for vi, spec in enumerate(specs):
            full = self.fields[spec.field]
            if full.ndim == 3:  # MU: [nx, ny, k] -> one level
                region = full[:ux, :uy, None, :]
            else:
                region = full[:ux, :uy, :uz, :]
            xb[:, vi, :] = region.reshape(-1, self.k)
        return xb

    def store_group(self, specs, xa: np.ndarray, ux: int, uy: int,
                    uz: int) -> None:
        """Write one group's analysis ``[B, V, k]`` back into the state."""
        for vi, spec in enumerate(specs):
            full = self.fields[spec.field]
            a = xa[:, vi, :].reshape(ux, uy, uz, self.k).astype(
                full.dtype, copy=False)
            if full.ndim == 3:
                full[:ux, :uy, :] = a[:, :, 0, :]
            else:
                full[:ux, :uy, :uz, :] = a

    def finish(self) -> None:
        """No-op (streaming variant flushes its sinks here)."""


def _read_member(path: str, mp: MpScheme, hypsometric_opt: int,
                 want_rhoa: bool):
    """One member's prognostic fields (read_model, grid.f90:226-504)."""
    out: Dict[str, np.ndarray] = {}
    with NetcdfReader(path) as nc:
        for key in ["psfc", "mu", "u", "v", "w", "ph", "t", "p", "qv"]:
            out[key] = nc.get_variable(FIELD_TO_NC[key])
        pb = nc.get_variable("PB")
        phb = nc.get_variable("PHB")
        mub = nc.get_variable("MUB")
        for key in mp.field_names():
            out[key] = nc.get_variable(FIELD_TO_NC[key])
        # clamp negative hydrometeors (grid.f90:362-365)
        for key in ("qr", "qs", "qg", "qh"):
            if key in out:
                np.clip(out[key], 0.0, None, out=out[key])
        rhoa = None
        if want_rhoa and mp.any_double_moment:
            rhoa = _derive_rhoa(nc, out, pb, phb, mub, hypsometric_opt)
    # full fields (grid.f90:500-502)
    out["ph"] = out["ph"] + phb
    out["p"] = out["p"] + pb
    out["mu"] = out["mu"] + mub
    return out, pb, phb, mub, rhoa


def _derive_rhoa(nc: NetcdfReader, fields, pb, phb, mub,
                 hypsometric_opt: int) -> np.ndarray:
    """Dry-air density for 2-moment schemes (grid.f90:369-441).

    Note: at this point ``fields['ph']``/``fields['mu']`` are still
    *perturbations* (base state not yet added), matching the reference
    where this runs before the saxpy at grid.f90:500-502.
    """
    t00 = nc.get_scalar("T00")
    p00 = nc.get_scalar("P00")
    tlp = nc.get_scalar("TLP")
    tiso = nc.get_scalar("TISO")
    p_strat = nc.get_scalar("P_STRAT")
    tlp_strat = nc.get_scalar("TLP_STRAT")

    temp = np.maximum(tiso, t00 + tlp * np.log(pb / p00))
    with np.errstate(divide="ignore", invalid="ignore"):
        strat = tiso + tlp_strat * np.log(
            pb / p_strat if p_strat > 0 else np.inf)
    temp = np.where(pb < p_strat, strat, temp)
    t_init = temp * (p00 / pb) ** (R_D / CP)
    mu_full = mub + fields["mu"]
    ph = fields["ph"]
    nz = pb.shape[2]
    rhoa = np.empty_like(pb)

    alb = (R_D / P1000MB) * t_init * (pb / P1000MB) ** CVPM  # [nx,ny,nz]
    if hypsometric_opt == 1:
        rdnw = np.asarray(nc.get_variable("RDNW"), np.float64).ravel()
        for kk in range(nz):
            al = (-1.0 / mu_full) * (alb[:, :, kk] * fields["mu"]
                                     + rdnw[kk] * (ph[:, :, kk + 1] - ph[:, :, kk]))
            rhoa[:, :, kk] = 1.0 / (alb[:, :, kk] + al)
    elif hypsometric_opt == 2:
        p_top = nc.get_scalar("P_TOP")
        znw = np.asarray(nc.get_variable("ZNW"), np.float64).ravel()
        znu = np.asarray(nc.get_variable("ZNU"), np.float64).ravel()
        for kk in range(nz):
            pfu = mu_full * znw[kk + 1] + p_top
            pfd = mu_full * znw[kk] + p_top
            phm = mu_full * znu[kk] + p_top
            al = (ph[:, :, kk + 1] - ph[:, :, kk]
                  + phb[:, :, kk + 1] - phb[:, :, kk]) / (
                      phm * np.log(pfd / pfu)) - alb[:, :, kk]
            rhoa[:, :, kk] = 1.0 / (alb[:, :, kk] + al)
    else:
        raise ValueError(f"wrf_hypsometric_opt must be 1 or 2, got "
                         f"{hypsometric_opt}")
    return rhoa.astype(np.float32)


def read_ensemble(paths: Sequence[str], cfg: LetkfConfig, *,
                  max_workers: int = 8,
                  want_rhoa: bool = True,
                  allow_subset: bool = False) -> WrfEnsemble:
    """Read the given members concurrently (the reference's member-parallel
    ingest, cwb_letkf.f90:39-52, one rank per member -> one thread per
    member).  ``allow_subset=True`` permits reading fewer members than
    ``cfg.nmember``, as the multi-host member-sharded ingest does
    (``parallel.multihost.read_members_sharded``)."""
    mp = MpScheme.from_option(cfg.wrf_mp_physics, cfg.wrf_mp_hail_opt)
    k = len(paths)
    if not allow_subset and k != cfg.nmember:
        raise ValueError(f"{k} member files for nmember={cfg.nmember}")

    with NetcdfReader(paths[0]) as nc:
        nx = nc.get_dimension("west_east")
        ny = nc.get_dimension("south_north")
        nz = nc.get_dimension("bottom_top")
        geo = {n: nc.get_variable(v) for n, v in [
            ("xlat", "XLAT"), ("xlon", "XLONG"),
            ("xlat_u", "XLAT_U"), ("xlon_u", "XLONG_U"),
            ("xlat_v", "XLAT_V"), ("xlon_v", "XLONG_V"),
            ("hgt", "HGT")]}

    with cf.ThreadPoolExecutor(max_workers=max_workers) as ex:
        results = list(ex.map(
            lambda p: _read_member(p, mp, cfg.wrf_hypsometric_opt, want_rhoa),
            paths))

    pb, phb, mub = results[0][1], results[0][2], results[0][3]
    keys = list(results[0][0].keys())
    fields = {key: np.stack([r[0][key] for r in results], axis=-1)
              for key in keys}
    rhoa = None
    if results[0][4] is not None:
        rhoa = np.stack([r[4] for r in results], axis=-1)

    return WrfEnsemble(
        nx=nx, ny=ny, nz=nz, k=k, mp=mp, fields=fields,
        pb=pb, phb=phb, mub=mub, rhoa=rhoa,
        member_paths=tuple(paths), **geo)


#: fields written back to member analysis files (write_model, grid.f90:526-597)
_ANALYSIS_FIELDS = ["u", "v", "w", "t", "p", "ph", "mu", "qv", "qr", "qs",
                    "qg", "qh", "nqr", "nqs", "nqg", "nqh"]


def _member_out_fields(ens: WrfEnsemble, m: int) -> Dict[str, np.ndarray]:
    out = {}
    for key in _ANALYSIS_FIELDS:
        if key not in ens.fields:
            continue
        arr = ens.fields[key][..., m]
        if key == "p":
            arr = arr - ens.pb     # back to perturbation (grid.f90:521-523)
        elif key == "ph":
            arr = arr - ens.phb
        elif key == "mu":
            arr = arr - ens.mub
        out[FIELD_TO_NC[key]] = arr
    return out


def write_ensemble(ens: WrfEnsemble, out_paths: Sequence[str], *,
                   max_workers: int = 8) -> None:
    """Write per-member analysis files, cloning each input member's header."""
    assert len(out_paths) == ens.k

    def write_one(m):
        with NetcdfReader(ens.member_paths[m]) as src, \
                NetcdfWriter(out_paths[m]) as dst:
            dst.copy_header_from(src)
            for name, arr in _member_out_fields(ens, m).items():
                dst.write_variable(name, arr)
            dst.write_others(src)

    with cf.ThreadPoolExecutor(max_workers=max_workers) as ex:
        list(ex.map(write_one, range(ens.k)))


#: base-state conversion on write for the full-field variables
#: (grid.f90:521-523); everything else round-trips unchanged
_BASE_OF = {"p": "pb", "ph": "phb", "mu": "mub"}
#: hydrometeor fields clamped non-negative on read (grid.f90:362-365)
_CLAMP = ("qr", "qs", "qg", "qh")


class StreamingWrfEnsemble:
    """One-group-resident ensemble: the reference's variable pipelining.

    The reference deliberately holds ONE analysis variable in distributed
    memory at a time — scatter, update, gather, looped over <= 16 variables
    (module_letkf_core.f90:59-297, scatter at module_mpi_util.f90:190-267)
    — bounding per-rank memory.  :func:`read_ensemble` instead loads the
    whole ~20-field ensemble up front, which at production scale
    (450x450x52 x 96 members) is > 80 GB of host RAM.

    This class is the streaming counterpart, presenting the same
    ``load_group`` / ``store_group`` interface the driver uses:

    * __init__ reads ONLY geometry, the member-1 base states and the
      ensemble-mean geopotential (the members' PH held once, as one
      ``[nx, ny, nz+1, k]`` array, to take the eager path's float32 mean);
    * each analysis output file is pre-created as a byte copy of its prior
      member (untouched variables are thereby copied through, the
      header-clone semantics of netcdf_io.f90:177-374);
    * ``load_group`` reads exactly the group's variables, member by member,
      straight into the ``[B, V, k]`` staging buffer;
    * ``store_group`` overlays the analyzed region onto each member's prior
      field (the U/V stagger sliver keeps its background,
      letkf_core.f90:209-210), converts p/ph/mu back to perturbations and
      rewrites that one variable in the member's sink file in place.

    Peak host memory is therefore O(group staging) instead of O(20 full
    ensemble fields).
    """

    def __init__(self, paths: Sequence[str], cfg: LetkfConfig,
                 out_paths: Sequence[str], *, max_workers: int = 8,
                 members: Optional[slice] = None):
        """``members``: restrict THIS process to a member subset (multi-host
        composition, ``parallel.multihost.member_block``) — only those members
        are read by load_group, written by store_group, and get sink files;
        the mean geopotential still averages ALL members (every host reads
        one PH field per member — the vertical coordinate must be the
        global ensemble mean, mpi_util.f90:529-530).  ``k`` stays the FULL
        ensemble size; ``k_local`` is this process's column count."""
        from ..io.netcdf import clone_file

        assert len(out_paths) == len(paths)
        self.member_paths = tuple(paths)
        self.out_paths = tuple(out_paths)
        self.k = len(paths)
        self.members = members if members is not None else slice(0, self.k)
        self._local = list(range(self.k)[self.members])
        self.k_local = len(self._local)
        self.mp = MpScheme.from_option(cfg.wrf_mp_physics,
                                       cfg.wrf_mp_hail_opt)
        self._max_workers = max_workers

        with NetcdfReader(paths[0]) as nc:
            self.nx = nc.get_dimension("west_east")
            self.ny = nc.get_dimension("south_north")
            self.nz = nc.get_dimension("bottom_top")
            for name, v in [("xlat", "XLAT"), ("xlon", "XLONG"),
                            ("xlat_u", "XLAT_U"), ("xlon_u", "XLONG_U"),
                            ("xlat_v", "XLAT_V"), ("xlon_v", "XLONG_V"),
                            ("hgt", "HGT")]:
                setattr(self, name, nc.get_variable(v))
            self.pb = nc.get_variable("PB")
            self.phb = nc.get_variable("PHB")
            self.mub = nc.get_variable("MUB")

        # mean full geopotential: the eager path's float32 mean of PH + PHB
        # over the members, on its [nx, ny, nz+1, k] layout, so that both
        # modes place the analysis points at the same heights (the JAX
        # package's float64 mean of PH moves them by a float32 rounding,
        # which moves the analysis by up to ~2e-5 of its increment); the
        # buffer is one variable's staging, below a group's
        ph_full = np.empty(self.phb.shape + (self.k,), np.float32)

        def read_ph(m):
            with NetcdfReader(paths[m]) as nc:
                ph_full[..., m] = nc.get_variable("PH") + self.phb

        with cf.ThreadPoolExecutor(max_workers=max_workers) as ex:
            list(ex.map(read_ph, range(self.k)))
        self._mean_ph = ph_full.mean(axis=-1)
        del ph_full

        # pre-create sinks: full prior copies, later overwritten in place.
        # Hydrometeors are clamped non-negative IN the sink even when not
        # analyzed — the reference clamps on read and writes the clamped
        # array back whether or not the variable was updated
        # (grid.f90:362-365 + write_model grid.f90:526-597), and the eager
        # path inherits that; the byte-copy must match.
        clamp_nc = [FIELD_TO_NC[f] for f in self.mp.field_names()
                    if f in _CLAMP]

        def make_sink(src, dst):
            from ..io.netcdf import NetcdfAppender

            clone_file(src, dst)
            if not clamp_nc:
                return
            with NetcdfReader(dst) as r:
                arrs = {n: r.get_variable(n) for n in clamp_nc}
            with NetcdfAppender(dst) as w:
                for n, arr in arrs.items():
                    if (arr < 0).any():
                        w.write_variable(n, np.clip(arr, 0.0, None))

        local_io = [(paths[m], out_paths[m]) for m in self._local]
        with cf.ThreadPoolExecutor(max_workers=max_workers) as ex:
            list(ex.map(lambda io: make_sink(*io), local_io))

    def mean_ph(self) -> np.ndarray:
        return self._mean_ph

    def _region(self, arr, ux, uy, uz):
        if arr.ndim == 2:  # MU
            return arr[:ux, :uy, None]
        return arr[:ux, :uy, :uz]

    def _read_full(self, nc: NetcdfReader, key: str) -> np.ndarray:
        arr = nc.get_variable(FIELD_TO_NC[key])
        base = _BASE_OF.get(key)
        if base is not None:
            arr = arr + getattr(self, base)
        if key in _CLAMP:
            np.clip(arr, 0.0, None, out=arr)
        return arr

    def load_group(self, specs, ux: int, uy: int, uz: int) -> np.ndarray:
        xb = np.empty((ux * uy * uz, len(specs), self.k_local), np.float32)

        def read_member(ci):
            with NetcdfReader(self.member_paths[self._local[ci]]) as nc:
                for vi, spec in enumerate(specs):
                    arr = self._read_full(nc, spec.field)
                    xb[:, vi, ci] = self._region(arr, ux, uy, uz).ravel()

        with cf.ThreadPoolExecutor(max_workers=self._max_workers) as ex:
            list(ex.map(read_member, range(self.k_local)))
        return xb

    def store_group(self, specs, xa: np.ndarray, ux: int, uy: int,
                    uz: int) -> None:
        from ..io.netcdf import NetcdfAppender

        def write_member(ci):
            m = self._local[ci]
            with NetcdfReader(self.member_paths[m]) as src, \
                    NetcdfAppender(self.out_paths[m]) as dst:
                for vi, spec in enumerate(specs):
                    full = self._read_full(src, spec.field)
                    a = xa[:, vi, ci].reshape(ux, uy, uz)
                    region = self._region(full, ux, uy, uz)
                    region[...] = a.astype(full.dtype, copy=False)
                    base = _BASE_OF.get(spec.field)
                    if base is not None:
                        full = full - getattr(self, base)
                    dst.write_variable(FIELD_TO_NC[spec.field], full)

        with cf.ThreadPoolExecutor(max_workers=self._max_workers) as ex:
            list(ex.map(write_member, range(self.k_local)))

    def finish(self) -> None:
        """Sinks are flushed per store; nothing to do."""

    def write_mean(self, out_path: str) -> None:
        """Analysis-mean file from the sink files, one field at a time.

        The sinks already store perturbation p/ph/mu, so averaging their
        stored values directly equals write_mean's full-mean-minus-base
        (grid.f90:827-846); untouched variables come from the member-1
        header clone.
        """
        from ..io.netcdf import NetcdfWriter

        names = [FIELD_TO_NC[key] for key in _ANALYSIS_FIELDS + ["psfc"]]
        with NetcdfReader(self.out_paths[0]) as src:
            present = [n for n in names if n in src.variable_names()]
        with NetcdfReader(self.out_paths[0]) as src, \
                NetcdfWriter(out_path) as dst:
            dst.copy_header_from(src)
            for name in present:
                acc = None
                for p in self.out_paths:
                    with NetcdfReader(p) as nc:
                        arr = nc.get_variable(name)
                    acc = arr.astype(np.float64) if acc is None else acc + arr
                dst.write_variable(name, (acc / self.k).astype(np.float32))
            dst.write_others(src)


def write_mean(ens: WrfEnsemble, out_path: str) -> None:
    """Ensemble-mean analysis file (write_mean, grid.f90:660-927).

    Mean of every prognostic field (incl. psfc, pb/phb/mub pass through via
    the header clone); p/ph/mu converted back to perturbation means.
    """
    with NetcdfReader(ens.member_paths[0]) as src, \
            NetcdfWriter(out_path) as dst:
        dst.copy_header_from(src)
        for key in _ANALYSIS_FIELDS + ["psfc"]:
            if key not in ens.fields:
                continue
            arr = ens.fields[key].mean(axis=-1)
            if key == "p":
                arr = arr - ens.pb
            elif key == "ph":
                arr = arr - ens.phb
            elif key == "mu":
                arr = arr - ens.mub
            dst.write_variable(FIELD_TO_NC[key], arr.astype(np.float32))
        dst.write_others(src)
