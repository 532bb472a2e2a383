"""Top-level LETKF analysis driver: the reference's ``letkf_driver``.

Port of the JAX package's ``driver.py``.  It runs the per-variable update
loop of module_letkf_core.f90:21-298 over the gridded WRF ensemble: for each
``var_update`` entry the stagger dispatch, the analysis-point coordinates
(cached per stagger class, as check_coordinate does, letkf_core.f90:735-747),
the batched point update on the device, and the moisture positivity fix for
the Q* variables (letkf_core.f90:252-278).  The platforms' statistics are
prepared once per cycle, since they do not depend on the variable.

The analysis runs on ``device``, the card unless the caller asks for the
CPU; the ensemble and its files stay on the host.  With a ``mesh``
(:mod:`.parallel`) the points are sharded over its devices; with
``distributed`` each process holds only its own members and the fields
cross between the member and point layouts by two transposes.
"""
from __future__ import annotations

import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import tracing
from .config import LetkfConfig
from .metrics import RunMetrics
from .models.variables import VAR_TABLE
from .models.vcoord import analysis_points, mean_geopotential_height
from .obs.base import PlatformObs, platform_statics_from_config
from .ops.cycle import CycleGroup, plan_cycle_budgets, update_points_cycle
from .ops.dense import set_accum_precision
from .ops.solver import tune_q
from .ops.update import (DevicePlatform, plan_max_blocks, prepare_platform,
                         update_points)
from .parallel.mesh import shard_points
from .parallel.multihost import (member_group_to_points,
                                 points_to_member_columns)
from .parallel.update import (sharded_update_points,
                              sharded_update_points_cycle,
                              update_points_cycle_shards)
from .profiling import device_breakdown as _breakdown
from .projection import LambertProjection


class StageTimer:
    """Wall-clock stage log (the reference's timer(), mpi_util.f90:66-71)."""

    def __init__(self, log=print, enabled: bool = True):
        self.t0 = time.perf_counter()
        self.log = log
        self.enabled = enabled

    def stamp(self, msg: str):
        if self.enabled:
            self.log(f"{time.perf_counter() - self.t0:7.3f} sec ==========> "
                     f"{msg}")


@tracing.spanned("driver.prepare")
def prepare_platforms(
    cfg: LetkfConfig,
    obs_data: Dict[str, PlatformObs],
    device: torch.device | str = "cuda",
) -> List[DevicePlatform]:
    """Pair configured platform statics with their parsed obs arrays, on
    ``device``."""
    out = []
    for st in platform_statics_from_config(cfg):
        po = obs_data.get(st.name)
        if po is None or po.nrec == 0:
            continue
        if po.nvar != st.nvar:
            raise ValueError(
                f"platform {st.name}: expected {st.nvar} observed vars, "
                f"got {po.nvar}")
        out.append(prepare_platform(st, po, device=device,
                                    norain_value=cfg.norain_value))
    return out


def _group_variables(cfg, platforms):
    """Group ``var_update`` entries that can share one weight computation.

    Two variables fuse when they share (a) analysis points (identical
    stagger) and (b) the localization signature every active platform
    applies to them: ``(hclr, vclr, assim_mask)``.  Then their local obs
    sets and whitened normal terms are identical and ``A_v`` differs only by
    ``inflat_v * I`` (see ops/solver.letkf_solve_group_from_normal).  The
    reference has no such notion: it rebuilds trees and redoes every solve
    per variable (letkf_core.f90:59-297).

    Returns a list of groups ``[(key, [(ivar, vname, spec), ...]), ...]`` in
    first-appearance order; variables nothing assimilates are dropped
    (letkf_core.f90:66).
    """
    groups: Dict[tuple, list] = {}
    order = []
    for ivar, vname in enumerate(cfg.var_update):
        if not vname:
            break
        spec = VAR_TABLE.get(vname)
        if spec is None:
            raise ValueError(
                f"unknown analysis variable {vname!r} "
                "(letkf_core.f90:159-161 aborts likewise)")
        sig = []
        for dp in platforms:
            st = dp.static
            if st.active(ivar):
                sig.append((st.name, st.hclr[ivar], st.vclr[ivar],
                            st.assim_mask(ivar)))
        if not sig:
            continue
        key = (spec.hstag, spec.vstag, tuple(sig))
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append((ivar, vname, spec))
    return [(key, groups[key]) for key in order]


def _sync(device: torch.device) -> None:
    """Wait for the device, so a stage closed after it holds its own time."""
    if device.type == "cuda":
        tracing.count_sync()
        torch.cuda.synchronize(device)


@tracing.labelled("driver.analysis")
@torch.inference_mode()
def run_analysis(
    cfg: LetkfConfig,
    ens,
    obs_data: Dict[str, PlatformObs],
    *,
    mesh=None,
    chunk: int = 4096,
    timer: Optional[StageTimer] = None,
    fuse_variables: bool = True,
    metrics: Optional[RunMetrics] = None,
    device_breakdown: bool = False,
    distributed: bool = False,
    device: torch.device | str = "cuda",
):
    """In-place LETKF analysis of ``ens`` for every ``var_update`` variable.

    ``ens`` is a :class:`.models.state.WrfEnsemble` or a
    :class:`.models.state.StreamingWrfEnsemble`.  ``fuse_variables=True``
    (default) updates the variables that share their points in one
    :func:`.ops.cycle.update_points_cycle` call per point set, one solve per
    gridpoint per localization-signature group; ``False`` runs the
    reference-shaped one-variable-at-a-time loop through
    :func:`.ops.update.update_points` (the same analysis up to solver
    roundoff).

    The fused branch is a one-group-deep pipeline: the host reads point set
    g+1's fields into a ``[B, V, k]`` buffer, copies it to the device and
    queues its update while the device may still run point set g; then g's
    result comes back in one copy and is stored.  The read overlaps g's
    compute only as far as g's update returns before the device finishes
    it.

    Runs on ``device`` (the card by default; the CPU only when asked).
    Every ensemble size runs: on a card the float32 solves take K1 up to
    128 members and the batched ``torch.matmul`` iteration above, and the
    eigen factors K3/K4 up to 177 and ``torch.linalg.eigh`` above
    (``solver.ns_route``, ``solver.eigh_route``).  With
    ``device_breakdown`` the fused branch ends with
    :func:`.profiling.device_breakdown` on a sample of the first group's
    points (their analysis), into ``metrics.device_breakdown``.

    ``mesh`` (:func:`.parallel.make_mesh`) shards every update's points over
    its devices, with budgets planned per shard (``n_shards``); the
    platforms are prepared on ``device`` and copied to the mesh's devices.

    ``distributed=True`` runs the multi-process pipeline (the reference's
    multi-rank ``main``, cwb_letkf.f90:20-81) on a mesh over a process
    group: ``ens`` holds only THIS process's member block
    (``StreamingWrfEnsemble(members=member_block(k, mesh))``, whose ``k``
    stays the full ensemble size and whose mean geopotential is global),
    and every process passes the same obs.  Per point set: local member
    columns -> the member->point transpose (the reference's
    ``letkf_scatter_grid`` alltoallv, module_mpi_util.f90:190-267) -> the
    fused cycle on this process's point shard -> ``tune_q`` on the point
    layout, where each process holds every member of its points -> the
    inverse transpose -> this process stores its own members
    (``letkf_gather_grid``, mpi_util.f90:269-358).  Every process must call
    it, and they make the same collective calls in the same order.
    """
    k_ens = cfg.nmember
    if distributed:
        if mesh is None:
            raise ValueError("distributed=True requires a global mesh")
        if not fuse_variables:
            raise ValueError(
                "distributed mode supports the fused path only")
        if getattr(ens, "k", k_ens) != k_ens:
            raise ValueError(
                "distributed=True needs an ensemble whose k is the FULL "
                "member count with a local member block "
                "(StreamingWrfEnsemble(members=member_block(...)))")
        if device_breakdown:
            raise ValueError("device_breakdown samples one process's whole "
                             "ensemble; distributed=True holds a member "
                             "block")
    # the names only: both accumulate in full float32 on the port
    set_accum_precision(cfg.accum_precision)
    device = torch.device(device)
    timer = timer or StageTimer(enabled=False)
    metrics = metrics if metrics is not None else RunMetrics()
    proj = LambertProjection.from_config(cfg.projection)
    platforms = prepare_platforms(cfg, obs_data, device)
    for dp in platforms:
        metrics.add_platform(dp)
    _sync(device)
    metrics.stage("prepare_platforms")
    solver_dtype = (torch.float64 if cfg.solver_dtype == "float64"
                    else torch.float32)
    quirk = cfg.replicate_stagger_quirk
    if mesh is not None:
        metrics.record_mesh(mesh, ens.nx * ens.ny * ens.nz)
    n_shards = mesh.size if mesh is not None else 1

    z_w = mean_geopotential_height(ens)
    pts_cache: Dict[Tuple[int, int], Tuple[np.ndarray, Tuple[int, int, int]]] = {}
    infl = cfg.inflation

    def points_for(spec):
        key = (spec.hstag, spec.vstag)
        if key not in pts_cache:
            pts_cache[key] = analysis_points(
                ens, proj, spec.hstag, spec.vstag, z_w, quirk=quirk)
        return pts_cache[key]

    if not fuse_variables:
        for _, members in _group_variables(cfg, platforms):
            for ivar, vname, spec in members:
                timer.stamp(f"update {vname}")
                pts, (ux, uy, uz) = points_for(spec)
                with tracing.span("driver.load"):
                    xb_host = ens.load_group([spec], ux, uy, uz)[:, 0, :]
                with tracing.label("driver.h2d"):
                    xb = torch.from_numpy(xb_host).to(device)
                pts_d = torch.from_numpy(pts).to(device)
                kwargs = dict(
                    inflat=(k_ens - 1) / infl.multi_infl[ivar],
                    weight_function=cfg.weight_function,
                    use_rtpp=bool(infl.use_rtpp[ivar]),
                    rtpp_alpha=infl.rtpp_alpha[ivar],
                    use_rtps=bool(infl.use_rtps[ivar]),
                    rtps_alpha=infl.rtps_alpha[ivar],
                    solver_dtype=solver_dtype, chunk=chunk)
                if mesh is not None:
                    budgets = plan_max_blocks(
                        pts_d, platforms, ivar, chunk=chunk,
                        solver_dtype=solver_dtype, n_shards=n_shards)
                    xa = sharded_update_points(
                        mesh, xb, pts_d, platforms, ivar,
                        max_blocks=budgets or None, **kwargs)
                else:
                    xa = update_points(xb, pts_d, platforms, ivar, **kwargs)
                if spec.tune_q:
                    xa = tune_q(xa)  # letkf_core.f90:252-278
                with tracing.label("driver.d2h"):
                    xa_host = xa.cpu().numpy()[:, None, :]
                with tracing.span("driver.store"):
                    ens.store_group([spec], xa_host, ux, uy, uz)
        ens.finish()
        return ens

    # ---- plan one cycle per point set up front ---------------------------
    # Variable groups sharing their analysis points (same stagger) go into
    # ONE cycle call, which shares point ordering, candidate culling,
    # gathers and obs tables across the groups (ops/cycle.py).  Analysis
    # points and exact budgets take host round trips, so planning stays out
    # of the pipelined loop below.
    def _cycle_group(members):
        ivars = tuple(iv for iv, _, _ in members)
        return CycleGroup(
            ivars=ivars,
            inflats=tuple((k_ens - 1) / infl.multi_infl[iv] for iv in ivars),
            rtpp_alpha=tuple(infl.rtpp_alpha[iv] if infl.use_rtpp[iv]
                             else 0.0 for iv in ivars),
            rtps_alpha=tuple(infl.rtps_alpha[iv] if infl.use_rtps[iv]
                             else 0.0 for iv in ivars))

    by_pts: Dict[Tuple[int, int], list] = {}
    for _, members in _group_variables(cfg, platforms):
        spec0 = members[0][2]
        by_pts.setdefault((spec0.hstag, spec0.vstag), []).append(members)

    plans = []
    for members_lists in by_pts.values():
        pts, dims = points_for(members_lists[0][0][2])
        pts_d = torch.from_numpy(pts).to(device)
        cgroups = tuple(_cycle_group(members) for members in members_lists)
        budgets = plan_cycle_budgets(pts_d, platforms, cgroups, chunk=chunk,
                                     solver_dtype=solver_dtype,
                                     n_shards=n_shards)
        plans.append(dict(
            members=[mv for members in members_lists for mv in members],
            groups=cgroups, pts_d=pts_d, dims=dims, budgets=budgets,
            q_shards=shard_points(mesh, pts_d)[0] if distributed else None))
    _sync(device)
    metrics.stage("plan_groups")

    # ---- pipelined load -> compute -> store ------------------------------
    # The reference overlaps its obs broadcasts with compute (issued
    # cwb_letkf.f90:55-57, awaited letkf_core.f90:50); here the host reads
    # point set g+1's fields and queues their copy and update behind g's,
    # then fetches g's result.
    def launch(plan):
        specs = [spec for _, _, spec in plan["members"]]
        ux, uy, uz = plan["dims"]
        t0 = time.perf_counter()
        with tracing.span("driver.load"):
            xb_host = ens.load_group(specs, ux, uy, uz)   # [B, V, k or k_local]
        kwargs = dict(weight_function=cfg.weight_function,
                      solver_dtype=solver_dtype, chunk=chunk,
                      max_blocks=plan["budgets"] or None)
        if distributed:
            # this process's member columns -> its point shard, [B/n, V, k]
            xb = member_group_to_points(mesh, xb_host, k_ens)
            load_s = time.perf_counter() - t0
            xa, diag = update_points_cycle_shards(
                mesh, xb, plan["q_shards"], platforms, plan["groups"],
                **kwargs)
        else:
            with tracing.label("driver.h2d"):
                xb = torch.from_numpy(xb_host).to(device)
            load_s = time.perf_counter() - t0
            if mesh is not None:
                xa, diag = sharded_update_points_cycle(
                    mesh, xb, plan["pts_d"], platforms, plan["groups"],
                    return_diagnostics=True, **kwargs)
            else:
                xa, diag = update_points_cycle(
                    xb, plan["pts_d"], platforms, plan["groups"],
                    return_diagnostics=True, **kwargs)
        return xa, diag, load_s, time.perf_counter() - t0

    def drain(plan, launched):
        t0 = time.perf_counter()
        xa, diag, load_s, launch_s = launched
        members = plan["members"]
        names = [v for _, v, _ in members]
        specs = [spec for _, _, spec in members]
        tq = [vi for vi, spec in enumerate(specs) if spec.tune_q]
        b = int(plan["pts_d"].shape[0])
        # tune_q works over the member axis, whole on the point layout: in
        # the distributed branch it runs before the inverse transpose
        for x in (xa if distributed else [xa]):
            if tq:
                x[:, tq] = tune_q(x[:, tq])  # letkf_core.f90:252-278
        if distributed:
            xa_host = points_to_member_columns(mesh, xa, k_ens, b)
        else:
            with tracing.label("driver.d2h"):
                xa_host = xa.cpu().numpy()
        with tracing.span("driver.store"):
            ens.store_group(specs, xa_host, *plan["dims"])
        overflow = int(diag["bucket_overflow"])
        if overflow:
            # planned budgets make this impossible; reaching it means obs
            # were silently dropped
            warnings.warn(
                f"group {'+'.join(names)}: bucketed accumulation dropped "
                f"{overflow} candidate block(s); analysis is missing obs.",
                RuntimeWarning, stacklevel=2)
        # the group's own host seconds, its launch and its drain: the
        # update call may return only once the device is done, so the
        # seconds between the two belong to the next group's launch
        metrics.add_group(names, b, launch_s + time.perf_counter() - t0,
                          bucket_overflow=overflow,
                          ns_residual=float(diag["ns_residual"]),
                          load_s=load_s)

    inflight = None
    for gi, plan in enumerate(plans):
        timer.stamp("update " + "+".join(v for _, v, _ in plan["members"]))
        nxt = launch(plan)       # host read + copy behind g-1's compute
        if inflight is not None:
            drain(plans[gi - 1], inflight)
        inflight = nxt
    if inflight is not None:
        drain(plans[-1], inflight)
    ens.finish()
    _sync(device)
    metrics.stage("update")

    if device_breakdown:
        # per-stage device time on a sample of the first group's points;
        # the reference has whole-stage wall clocks only (mpi_util.f90:66-71)
        groups = _group_variables(cfg, platforms)
        if groups:
            ivar0, _, spec0 = groups[0][1][0]
            pts, (ux, uy, uz) = points_for(spec0)
            xb = ens.load_group([spec0], ux, uy, uz)[:, 0, :]
            metrics.device_breakdown = _breakdown(
                torch.from_numpy(xb).to(device),
                torch.from_numpy(pts).to(device), platforms, ivar0,
                weight_function=cfg.weight_function,
                inflat=(k_ens - 1) / infl.multi_infl[ivar0])
            metrics.stage("device_breakdown")
    return ens
