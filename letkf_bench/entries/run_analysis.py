"""Entry ``run_analysis``: a step is one whole analysis of a WRF ensemble,
``cwbnwp_letkf_torch.driver.run_analysis`` on an in-memory ensemble and
in-memory records, every ``var_update`` field over its staggered points
(the driver, the plan, the fused cycle, the solve and the kernels; not the
command's file reads and writes).

The driver analyses the ensemble in place, so the background is put back
before each step: benchmark work, timed apart from the steps.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from .. import generate
from ..reference import geometry
from ..reference import letkf as ref


def updated(cfg: dict, traffic: dict):
    """The variables some platform of the traffic updates, in
    ``var_update`` order."""
    return [v for v in cfg["var_update"]
            if any(p in traffic["platforms"] and v in grp["vars"]
                   for grp in cfg["localization"] for p in grp["radii_km"])]


def var_points(cfg: dict, traffic: dict) -> int:
    """Grid points of every variable the analysis updates: what one step
    delivers."""
    g = cfg["grid"]
    return sum(math.prod(geometry.extent(geometry.VARIABLES[v], g["nx"], g["ny"],
                                         g["nz"]))
               for v in updated(cfg, traffic))


class Case:
    pass


def build(cfg: dict, traffic: dict, cell: dict, seed: int, device) -> Case:
    from cwbnwp_letkf_torch.config import LetkfConfig
    from cwbnwp_letkf_torch.models.state import MpScheme, WrfEnsemble
    from cwbnwp_letkf_torch.obs.base import make_platform_obs

    c = Case()
    c.cfg, c.traffic, c.device = cfg, traffic, device
    c.wrf = generate.wrf_case(cfg, seed)
    c.records = generate.column_obs(cfg, traffic, c.wrf, seed)
    c.config = LetkfConfig.from_namelist(generate.namelist(cfg))
    g, geo = cfg["grid"], c.wrf["geo"]
    c.ens = WrfEnsemble(
        nx=g["nx"], ny=g["ny"], nz=g["nz"], k=cfg["nmember"],
        mp=MpScheme.from_option(c.config.wrf_mp_physics,
                                c.config.wrf_mp_hail_opt),
        fields={key: a.copy() for key, a in c.wrf["fields"].items()},
        pb=c.wrf["pb"], phb=c.wrf["phb"], mub=c.wrf["mub"], **geo)
    c.obs = {name: make_platform_obs(r["xyz"], r["obs"], r["hdxb"],
                                     error=r["error"], qc=r["qc"])
             for name, r in c.records.items()}
    c.names = updated(cfg, traffic)
    c.var_points = var_points(cfg, traffic)
    # the points each variable is judged at: a sample of its point set,
    # drawn from the seed, shared by the variables on the same points
    c.sample: Dict[tuple, np.ndarray] = {}
    for v in c.names:
        spec = geometry.VARIABLES[v]
        key = (spec.hstag, spec.vstag)
        if key not in c.sample:
            n = math.prod(geometry.extent(spec, g["nx"], g["ny"], g["nz"]))
            c.sample[key] = np.sort(generate.rng(seed, 100 + len(c.sample))
                                    .choice(n, min(n, cell["sample_points"]),
                                            replace=False))
    c.answers = {v: [] for v in c.names}
    c.counters = {"driver.load_s": 0.0}
    return c


def _at(c: Case, field: np.ndarray, v: str) -> np.ndarray:
    """A field's ``[S, k]`` values at variable ``v``'s sampled points."""
    spec = geometry.VARIABLES[v]
    g = c.cfg["grid"]
    i, j, l = np.unravel_index(c.sample[(spec.hstag, spec.vstag)],
                               geometry.extent(spec, g["nx"], g["ny"], g["nz"]))
    return field[i, j, :] if field.ndim == 3 else field[i, j, l, :]


def before_step(c: Case, i: int) -> None:
    for key, background in c.wrf["fields"].items():
        np.copyto(c.ens.fields[key], background)


def step(c: Case, i: int) -> int:
    from cwbnwp_letkf_torch import driver
    from cwbnwp_letkf_torch.metrics import RunMetrics

    m = RunMetrics()
    driver.run_analysis(c.config, c.ens, c.obs, chunk=c.cfg["chunk"],
                        metrics=m, device=c.device)
    if c.device.type == "cuda":
        torch.cuda.synchronize(c.device)
    c.counters["driver.load_s"] += sum(grp.load_s for grp in m.groups)
    return c.var_points


def after_step(c: Case, i: int) -> None:
    for v in c.names:
        c.answers[v].append(_at(c, c.ens.fields[geometry.VARIABLES[v].field], v))


def spans(c: Case):
    """Program calls the traced run names its host time by."""
    from cwbnwp_letkf_torch import driver
    from cwbnwp_letkf_torch.ops import cycle

    return [(driver, "prepare_platforms", "driver.prepare"),
            (driver, "plan_cycle_budgets", "cycle.plan"),
            (driver, "update_points_cycle", "cycle.update"),
            (cycle, "letkf_solve_cycle_from_normal", "solver.solve"),
            (driver, "tune_q", "solver.tune_q"),
            (c.ens, "load_group", "driver.load"),
            (c.ens, "store_group", "driver.store")]


def free(c: Case) -> None:
    c.ens = c.obs = None


def check(c: Case, cell: dict, control: bool = False) -> Dict[str, list]:
    """The reference at the sampled points of every updated variable, and
    each step's answers against it: ``{number: [one value a step]}``
    (:func:`numbers`).
    ``control``: the answers are the reference's own in TF32 instead."""
    cfg, dev = c.cfg, c.device
    bg = c.wrf["fields"]
    z_w = geometry.w_level_height(bg["ph"])
    proj = geometry.Lambert.of(**cfg["projection"])
    plats = generate.reference_platforms(cfg, c.records, dev)
    chunk = max(1, int(4e6 // max(r["obs"].shape[1] for r in c.records.values())))
    infl = cfg["inflation"]
    terms_of: Dict[tuple, list] = {}
    compared = []

    def pts_of(v):
        spec = geometry.VARIABLES[v]
        return torch.from_numpy(geometry.points(
            spec, c.sample[(spec.hstag, spec.vstag)], c.wrf["geo"], z_w,
            proj)).to(dev, torch.float64)

    for v in c.names:
        spec = geometry.VARIABLES[v]
        ivar = cfg["var_update"].index(v)
        sig = (spec.hstag, spec.vstag) + tuple(
            (p.hclr[ivar], p.vclr[ivar]) for p in plats)
        if sig not in terms_of:
            pts = pts_of(v)
            terms = [ref.local_terms(pts[s:s + chunk], plats, ivar,
                                     cfg["weight_function"])
                     for s in range(0, pts.shape[0], chunk)]
            terms_of[sig] = [(t, ref.eigen(t)) for t in terms]
        xb = torch.from_numpy(_at(c, bg[spec.field], v))
        answers = torch.from_numpy(np.stack(c.answers[v]))
        if control:
            answers = torch.cat([ref.control(
                ref.local_terms(pts_of(v)[s:s + chunk], plats, ivar,
                                cfg["weight_function"], low=True),
                xb[s:s + chunk], multi_infl=infl["multi_infl"][ivar],
                rtpp_alpha=infl["rtpp_alpha"], rtps_alpha=infl["rtps_alpha"],
                moisture=spec.moisture)
                for s in range(0, xb.shape[0], chunk)])[None]
        parts = [ref.compare_points(
            t, xb[s:s + chunk], answers[:, s:s + chunk], eig=eig,
            multi_infl=infl["multi_infl"][ivar],
            rtpp_alpha=infl["rtpp_alpha"], rtps_alpha=infl["rtps_alpha"],
            moisture=spec.moisture)
            for (t, eig), s in zip(terms_of[sig], range(0, xb.shape[0], chunk))]
        compared.append(ref.merge(parts))
    ref.report(c.names, compared)
    return numbers(cell, c.names, compared)


def numbers(cell: dict, names, compared) -> Dict[str, list]:
    """The cell's numbers, each :func:`ref.xa_gap` over the variables its
    ``numbers`` entry names (every variable without one), of those this
    traffic updates; a number none of whose variables it updates is left
    out."""
    out = {}
    for name, wanted in cell.get("numbers", {"xa_gap": names}).items():
        mine = [cp for v, cp in zip(names, compared) if v in wanted]
        if mine:
            out[name] = ref.xa_gap(mine)
    return out
