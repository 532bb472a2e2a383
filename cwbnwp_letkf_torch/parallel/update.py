"""Sharded LETKF updates over a device mesh.

Port of the JAX package's ``parallel/update.py``.  The point batch is split
over the mesh's ``"grid"`` axis and every shard runs the single-device
update (:mod:`..ops.update`, :mod:`..ops.cycle`) on its piece, with the obs
on every device.  This replaces the reference's scatter -> serial loop ->
gather pipeline (letkf_scatter_grid / letkf_gather_grid,
module_mpi_util.f90:190-358).

The public functions take the whole batch and return the whole analysis on
every process, as the JAX functions do: under a process group each rank
runs its own shard and the rows are assembled with an all-gather; an
in-process mesh runs its shards in turn (see :mod:`.mesh`).  The batch is
padded to a multiple of the mesh size with copies of the LAST REAL POINT
(background rows of zeros; those rows are dropped before returning): a far
sentinel coordinate would enter the last shard's Hilbert bounding box and
collapse every real point of it to one cell, which would turn its chunks
into raw grid order and defeat the bucketed block culling.

The diagnostics reduce over the shards: ``bucket_overflow`` summed,
``ns_residual`` maxed (all-reduce SUM / MAX under a process group).  Plan
the budgets with ``n_shards=mesh.size`` (``ops.update.plan_max_blocks``,
``ops.cycle.plan_cycle_budgets``): each shard orders and chunks its own
points, and budgets planned on the whole batch can undersize a shard.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist

from ..ops.cycle import update_points_cycle
from ..ops.update import (DevicePlatform, update_points,
                          update_points_group)
from .mesh import Mesh, pad_rows, padded_size, replicate

#: the all-gather into one tensor, under its newer name where torch has it
_all_gather = (getattr(dist, "all_gather_single", None)
               or dist.all_gather_into_tensor)


def reduce_diagnostics(mesh: Mesh, diags: Sequence[dict]) -> dict:
    """The shards' diagnostics over the whole mesh: overflow summed,
    residual maxed; 0-d tensors on the first local shard's device."""
    dev = diags[0]["bucket_overflow"].device
    ovf = torch.stack([d["bucket_overflow"].to(dev) for d in diags]).sum()
    resid = torch.stack([d["ns_residual"].to(dev) for d in diags]).amax()
    if mesh.group is not None:
        dist.all_reduce(ovf, op=dist.ReduceOp.SUM, group=mesh.group)
        dist.all_reduce(resid, op=dist.ReduceOp.MAX, group=mesh.group)
    return {"bucket_overflow": ovf, "ns_residual": resid}


def gather_rows(mesh: Mesh, shards: Sequence[torch.Tensor],
                device) -> torch.Tensor:
    """The whole padded batch from this process's row shards, on
    ``device``: concatenated in-process, all-gathered under a group."""
    if mesh.group is None:
        return torch.cat([s.to(device) for s in shards])
    local = shards[0].contiguous()
    out = local.new_empty((mesh.size * local.shape[0],) + local.shape[1:])
    _all_gather(out, local, group=mesh.group)
    return out.to(device)


def run_shards(mesh: Mesh, xb_shards: Sequence[torch.Tensor],
               q_shards: Sequence[torch.Tensor],
               platforms: Sequence[DevicePlatform],
               local: Callable) -> tuple:
    """``local(xb, q, platforms)`` -> ``(xa, diagnostics)`` on each of this
    process's shards, with the platforms on the shard's device; returns the
    analysis shards and the mesh-wide diagnostics.  Every rank of a group
    must call it, the same number of times in the same order."""
    outs, diags = [], []
    for (_, dev), plats, xb_l, q_l in zip(
            mesh.local_shards(), replicate(mesh, list(platforms)),
            xb_shards, q_shards):
        xa_l, diag = local(xb_l.to(dev), q_l.to(dev), plats)
        outs.append(xa_l)
        diags.append(diag)
    return outs, reduce_diagnostics(mesh, diags)


def _sharded(mesh: Mesh, xb: torch.Tensor, points_xyz: torch.Tensor,
             platforms, local: Callable, return_diagnostics: bool):
    """Pad, split, run ``local`` per shard, gather: the whole analysis."""
    b = xb.shape[0]
    if points_xyz.shape != (b, 3):
        raise ValueError(f"points_xyz must be [{b}, 3] to match xb "
                         f"{tuple(xb.shape)}, got {tuple(points_xyz.shape)}")
    b_pad = padded_size(b, mesh.size)
    per = b_pad // mesh.size
    xb_p = pad_rows(xb, b_pad, zeros=True)
    q_p = pad_rows(points_xyz, b_pad)
    rows = [slice(s * per, (s + 1) * per) for s, _ in mesh.local_shards()]
    outs, diag = run_shards(mesh, [xb_p[r] for r in rows],
                            [q_p[r] for r in rows], platforms, local)
    xa = gather_rows(mesh, outs, xb.device)[:b]
    if return_diagnostics:
        return xa, {key: v.to(xb.device) for key, v in diag.items()}
    return xa


def sharded_update_points(
    mesh: Mesh,
    xb: torch.Tensor,
    points_xyz: torch.Tensor,
    platforms: Sequence[DevicePlatform],
    ivar: int,
    *,
    inflat: float,
    weight_function: int,
    use_rtpp: bool = False,
    rtpp_alpha: float = 0.85,
    use_rtps: bool = False,
    rtps_alpha: float = 0.85,
    solver_dtype=torch.float32,
    chunk: int = 4096,
    method: str = "auto",
    max_blocks=None,
    point_order: str = "auto",
    return_diagnostics: bool = False,
):
    """:func:`..ops.update.update_points` over the mesh: ``xb [B, k]`` and
    ``points_xyz [B, 3]`` in, ``xa [B, k]`` (and the reduced diagnostics)
    out, on ``xb``'s device.  The same analysis as the single-device path
    up to float32 roundoff: only the shards' chunks differ."""
    def local(xb_l, q_l, plats):
        return update_points(
            xb_l, q_l, plats, ivar, inflat=inflat,
            weight_function=weight_function, use_rtpp=use_rtpp,
            rtpp_alpha=rtpp_alpha, use_rtps=use_rtps, rtps_alpha=rtps_alpha,
            solver_dtype=solver_dtype, chunk=chunk, method=method,
            max_blocks=max_blocks, point_order=point_order,
            return_diagnostics=True)

    return _sharded(mesh, xb, points_xyz, platforms, local,
                    return_diagnostics)


def update_points_cycle_shards(
    mesh: Mesh,
    xb_shards: Sequence[torch.Tensor],
    q_shards: Sequence[torch.Tensor],
    platforms: Sequence[DevicePlatform],
    groups,
    **kwargs,
) -> tuple:
    """The fused cycle on this process's point shards (``[B/n, V, k]`` and
    ``[B/n, 3]``, one per local shard, already padded): returns the
    analysis shards and the mesh-wide diagnostics.  ``run_analysis``'s
    distributed branch works on these between its two transposes;
    ``kwargs`` are :func:`..ops.cycle.update_points_cycle`'s."""
    def local(xb_l, q_l, plats):
        return update_points_cycle(xb_l, q_l, plats, groups,
                                   return_diagnostics=True, **kwargs)

    return run_shards(mesh, xb_shards, q_shards, platforms, local)


def sharded_update_points_cycle(
    mesh: Mesh,
    xb: torch.Tensor,
    points_xyz: torch.Tensor,
    platforms: Sequence[DevicePlatform],
    groups,
    *,
    weight_function: int,
    solver_dtype=torch.float32,
    chunk: int = 4096,
    subchunk: int = 512,
    method: str = "auto",
    max_blocks=None,
    point_order: str = "auto",
    return_diagnostics: bool = False,
):
    """:func:`..ops.cycle.update_points_cycle` over the mesh: ``xb
    [B, V_total, k]`` and ``points_xyz [B, 3]`` in, ``xa [B, V_total, k]``
    out.  Budgets from ``plan_cycle_budgets(..., n_shards=mesh.size)`` make
    bucketed overflow impossible."""
    def local(xb_l, q_l, plats):
        return update_points_cycle(
            xb_l, q_l, plats, groups, weight_function=weight_function,
            solver_dtype=solver_dtype, chunk=chunk, subchunk=subchunk,
            method=method, max_blocks=max_blocks, point_order=point_order,
            return_diagnostics=True)

    return _sharded(mesh, xb, points_xyz, platforms, local,
                    return_diagnostics)


def sharded_update_points_group(
    mesh: Mesh,
    xb: torch.Tensor,
    points_xyz: torch.Tensor,
    platforms: Sequence[DevicePlatform],
    ivars,
    *,
    inflats,
    weight_function: int,
    rtpp_alpha,
    rtps_alpha,
    solver_dtype=torch.float32,
    chunk: int = 4096,
    method: str = "auto",
    max_blocks=None,
    point_order: str = "auto",
    return_diagnostics: bool = False,
):
    """:func:`..ops.update.update_points_group` over the mesh: ``xb
    [B, V, k]`` and ``points_xyz [B, 3]`` in, ``xa [B, V, k]`` out."""
    def local(xb_l, q_l, plats):
        return update_points_group(
            xb_l, q_l, plats, ivars, inflats=inflats,
            weight_function=weight_function, rtpp_alpha=rtpp_alpha,
            rtps_alpha=rtps_alpha, solver_dtype=solver_dtype, chunk=chunk,
            method=method, max_blocks=max_blocks, point_order=point_order,
            return_diagnostics=True)

    return _sharded(mesh, xb, points_xyz, platforms, local,
                    return_diagnostics)
