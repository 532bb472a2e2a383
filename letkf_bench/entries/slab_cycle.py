"""Entry ``slab_cycle``: the production domain a slab at a time.

The platforms' records come Hilbert-presorted, as an operational
pre-processor would hand them over, and are prepared once; a step plans the
candidate budgets of one slab of points and runs the fused cycle on it
(``ops.cycle.plan_cycle_budgets``, then ``ops.cycle.update_points_cycle``
with ``obs_presorted=True``).  Slabs follow in domain order from one drawn
from the seed, wrapping around.  The warm-up slab builds the platform's
``R x k(k+1)`` table, which stays cached for the later slabs, as within one
analysis of the whole domain.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import generate
from ..reference import geometry
from ..reference import letkf as ref


class Case:
    pass


def build(cfg: dict, traffic: dict, cell: dict, seed: int, device) -> Case:
    from cwbnwp_letkf_torch.obs.base import PlatformObs, PlatformStatic
    from cwbnwp_letkf_torch.ops.bucketed import hilbert3
    from cwbnwp_letkf_torch.ops.cycle import CycleGroup
    from cwbnwp_letkf_torch.ops.neighbors import normalize_coords
    from cwbnwp_letkf_torch.ops.update import prepare_platform

    c = Case()
    c.cfg, c.device, c.seed = cfg, device, seed
    dom = generate.slab_case(cfg, traffic, seed, device)
    c.pts, c.xb, c.records = dom["pts"], dom["xb"], dom["records"]
    k = cfg["nmember"]
    infl = cfg["inflation"]
    c.groups = (CycleGroup(
        ivars=tuple(range(len(cfg["var_update"]))),
        inflats=tuple((k - 1) / m for m in infl["multi_infl"]),
        rtpp_alpha=(infl["rtpp_alpha"],) * len(cfg["var_update"]),
        rtps_alpha=(infl["rtps_alpha"],) * len(cfg["var_update"])),)
    c.platforms = []
    for name, r in sorted(c.records.items()):
        p = cfg["platforms"][name]
        h, v = generate.radii(cfg, name)
        order = torch.argsort(hilbert3(normalize_coords(r["xyz"], h[0], v[0])),
                              stable=True)
        po = PlatformObs(xyz=r["xyz"][order], obs=r["obs"][:, order],
                         error=r["error"][:, order], qc=r["qc"][:, order],
                         hdxb=r["hdxb"][:, order])
        st = PlatformStatic(
            name=name, kind="radar", nvar=1, max_lz_pts=p["max_lz_pts"],
            hclr=tuple(h), vclr=tuple(v), err_muti=(p["error"],),
            err_rej=(p["err_rej"],), is_assim=((True,) * len(h),),
            is_dbz=name == "dbz")
        c.platforms.append(prepare_platform(st, po, device=device,
                                            norain_value=cfg["norain_value"]))
    b = c.pts.shape[0]
    c.n_slabs = cfg["slabs"]
    c.slab = -(-b // c.n_slabs)
    c.first = int(generate.rng(seed, 1).integers(c.n_slabs))
    c.sample_points = cell["sample_points"]
    c.answers = []          # per step: (points, background, analysis) samples
    c.counters = {}
    return c


def _rows(c: Case, i: int) -> slice:
    s = (c.first + i) % c.n_slabs
    return slice(s * c.slab, min(c.pts.shape[0], (s + 1) * c.slab))


def before_step(c: Case, i: int) -> None:
    pass


def step(c: Case, i: int) -> int:
    from cwbnwp_letkf_torch.ops import cycle

    rows = _rows(c, i)
    chunk = c.cfg["chunk"]
    c.xa = None
    budgets = cycle.plan_cycle_budgets(
        c.pts[rows], c.platforms, c.groups, chunk=chunk, subchunk=chunk,
        obs_presorted=True)
    c.xa = cycle.update_points_cycle(
        c.xb[rows, None, :], c.pts[rows], c.platforms, c.groups,
        weight_function=c.cfg["weight_function"], chunk=chunk, subchunk=chunk,
        max_blocks=budgets, obs_presorted=True)
    if c.device.type == "cuda":
        torch.cuda.synchronize(c.device)
    return (rows.stop - rows.start) * len(c.cfg["var_update"])


def after_step(c: Case, i: int) -> None:
    rows = _rows(c, i)
    n = rows.stop - rows.start
    pick = np.sort(generate.rng(c.seed, 100 + i).choice(
        n, min(n, c.sample_points), replace=False))
    idx = torch.from_numpy(pick).to(c.device)
    c.answers.append((c.pts[rows][idx].cpu(), c.xb[rows][idx].cpu(),
                      c.xa[idx].cpu()))
    c.xa = None


def spans(c: Case):
    """Program calls the traced run names its host time by."""
    from cwbnwp_letkf_torch.ops import cycle

    return [(cycle, "plan_cycle_budgets", "cycle.plan"),
            (cycle, "update_points_cycle", "cycle.update"),
            (cycle, "_resolve_plans", "cycle.resolve"),
            (cycle, "letkf_solve_cycle_from_normal", "solver.solve")]


def free(c: Case) -> None:
    c.platforms = c.pts = c.xb = c.xa = None


def check(c: Case, cell: dict, control: bool = False) -> Dict[str, list]:
    """The reference at each step's sampled points, from the records in
    the order they were made: ``{"xa_gap": [one value a step]}``.
    ``control``: the answers are the reference's own in TF32 instead."""
    cfg, dev = c.cfg, c.device
    infl = cfg["inflation"]
    plats = generate.reference_platforms(cfg, c.records, dev)
    c.records = None
    chunk = max(1, int(4e6 // max(p.xyz.shape[0] for p in plats)))
    out = []
    for pts, xb, xa in c.answers:
        pts = pts.to(dev, torch.float64)
        per_var = []
        for ivar, name in enumerate(cfg["var_update"]):
            parts = []
            spec = dict(multi_infl=infl["multi_infl"][ivar],
                        rtpp_alpha=infl["rtpp_alpha"],
                        rtps_alpha=infl["rtps_alpha"],
                        moisture=geometry.VARIABLES[name].moisture)
            for s in range(0, pts.shape[0], chunk):
                t = ref.local_terms(pts[s:s + chunk], plats, ivar,
                                    cfg["weight_function"])
                answers = xa[None, s:s + chunk, ivar]
                if control:
                    answers = ref.control(ref.local_terms(
                        pts[s:s + chunk], plats, ivar, cfg["weight_function"],
                        low=True), xb[s:s + chunk], **spec)[None]
                parts.append(ref.compare_points(t, xb[s:s + chunk], answers,
                                                **spec))
            per_var.append(ref.merge(parts))
        ref.report(cfg["var_update"], per_var)
        out += ref.xa_gap(per_var)
    return {"xa_gap": out}
