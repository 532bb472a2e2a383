"""Multi-process orchestration: member-block ingest and the member/point
transposes over ``torch.distributed``.

Port of the JAX package's ``parallel/multihost.py``.  The reference binds
one MPI rank per member for I/O (rank r reads member r+1's wrfinput,
cwb_letkf.f90:39-52), then redistributes member-layout fields to domain
layout with ``mpi_alltoallv`` (letkf_scatter_grid,
module_mpi_util.f90:190-267) and back (letkf_gather_grid, :269-358).  Here
each process (one card each) reads the member block it owns, and the two
transposes are ``torch.distributed.all_to_all_single``: the member axis is
zero-padded to a multiple of the mesh size, each process sends every other
process that process's rows of its member columns, and the padding is
stripped after.  The obs are small and every process reads the same files,
so they are copied to each device, never sent.

On an in-process mesh (:mod:`.mesh`) the one process owns every member and
the transposes only split and join rows.  Ownership follows the layout:
:func:`member_block` gives each process ``kpp = pad(k, n) / n`` member
columns under a process group of ``n`` ranks.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, pad_rows, padded_size, replicate, shard_points


def _process() -> tuple:
    """``(rank, world size)`` of the default process group, or ``(0, 1)``."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def my_member_slice(k: int, process_index: Optional[int] = None,
                    process_count: Optional[int] = None) -> slice:
    """Members owned by this process: a contiguous balanced split of 0..k-1.

    (The reference's static rank->member binding, cwb_letkf.f90:39-52,
    without the nproc >= nmember restriction.)
    """
    rank, world = _process()
    pi = rank if process_index is None else process_index
    pc = world if process_count is None else process_count
    base, extra = divmod(k, pc)
    lo = pi * base + min(pi, extra)
    return slice(lo, lo + base + (1 if pi < extra else 0))


def _columns(k: int, mesh: Mesh) -> tuple:
    """``(k_pad, kpp)``: the padded member count and each process's
    columns."""
    k_pad = padded_size(k, mesh.size)
    return k_pad, k_pad // mesh.n_processes


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


def _pad_cols(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` zero-padded along its last (member) axis to ``width``."""
    if x.shape[-1] == width:
        return x
    return torch.cat([x, x.new_zeros(x.shape[:-1] + (width - x.shape[-1],))],
                     -1)


def member_block(k: int, mesh: Mesh) -> slice:
    """Members this process owns under the member-sharded layout:
    ``[rank * kpp, (rank + 1) * kpp) ∩ [0, k)`` with ``kpp = pad(k, n) / n``
    over ``n`` ranks, one card each; on an in-process mesh, all of them.

    Ownership must follow the layout the transposes use, so this, not the
    balanced :func:`my_member_slice`, decides what the distributed CLI
    reads.
    """
    _, kpp = _columns(k, mesh)
    lo = mesh.rank * kpp
    return slice(min(lo, k), min(lo + kpp, k))


def make_point_sharded(mesh: Mesh, arr, axis: int = 0) -> List[torch.Tensor]:
    """This process's shards of ``arr`` along the point axis ``axis``.

    In-process, ``arr`` is the whole array: it is padded with copies of its
    last row along ``axis`` and split into one shard per device.  Under a
    process group ``arr`` is already this process's rows (the rows it
    computed) and goes to its device.
    """
    a = _tensor(arr)
    if mesh.group is not None:
        return [a.to(mesh.devices[mesh.rank])]
    return [s.movedim(0, axis)
            for s in shard_points(mesh, a.movedim(axis, 0))[0]]


def replicate_obs(mesh: Mesh, tree) -> list:
    """Obs arrays on the device of each of this process's shards: every
    process reads the same obs files, so nothing is sent."""
    return replicate(mesh, tree)


def make_member_sharded(mesh: Mesh, local_cols, k: int) -> List[torch.Tensor]:
    """This process's member columns ``[B, ..., k_local]`` (those of
    :func:`member_block`; all ``k`` in-process), the product of
    member-parallel ingest (the reference's rank-per-member read,
    cwb_letkf.f90:39-52), as member blocks of ``pad(k, n) / n`` zero-padded
    columns, one per local shard on its device."""
    k_pad, kpp = _columns(k, mesh)
    x = _pad_cols(_tensor(local_cols), kpp)
    if mesh.group is not None:
        return [x.to(mesh.devices[mesh.rank])]
    width = k_pad // mesh.size
    return [x[..., s * width:(s + 1) * width].to(d)
            for s, d in mesh.local_shards()]


def member_group_to_points(mesh: Mesh, local, k: int) -> List[torch.Tensor]:
    """The member->point transpose: this process's member columns
    ``[B, ..., k_local]`` in, its point shards ``[B_pad / n, ..., k]`` out
    (one per local shard, on its device), the point axis padded with zero
    rows to a multiple of the mesh size as :mod:`.update` pads it.

    The reference's ``letkf_scatter_grid`` alltoallv
    (module_mpi_util.f90:190-267): under a process group one
    ``all_to_all_single`` sends rank ``r`` rows ``[r B_pad/n, (r+1)
    B_pad/n)`` of every process's ``kpp`` columns (zero-padded processes
    send zero columns).  Every rank must call it.
    """
    k_pad, kpp = _columns(k, mesh)
    x = _pad_cols(_tensor(local), kpp)
    n = mesh.size
    per = padded_size(x.shape[0], n) // n
    if mesh.group is None:
        x = pad_rows(x[..., :k], n * per, zeros=True)
        return [x[s * per:(s + 1) * per].to(d)
                for s, d in mesh.local_shards()]
    x = pad_rows(x.to(mesh.devices[mesh.rank]), n * per,
                 zeros=True).contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.group)
    # block s of ``out`` holds this rank's rows of rank s's member columns
    out = out.view(n, per, *x.shape[1:]).movedim(0, -2)
    return [out.reshape(per, *x.shape[1:-1], n * kpp)[..., :k]]


def members_to_points(mesh: Mesh, blocks: Sequence[torch.Tensor],
                      k: int) -> List[torch.Tensor]:
    """Member blocks (:func:`make_member_sharded`) to point shards: the
    single transpose between the ingest's layout and the update's, as
    :func:`member_group_to_points`."""
    if mesh.group is None:
        cols = torch.cat([b.to(blocks[0].device) for b in blocks], -1)
    else:
        cols = blocks[0]
    return member_group_to_points(mesh, cols, k)


def points_to_member_columns(mesh: Mesh, xa_shards: Sequence[torch.Tensor],
                             k: int, b: int) -> np.ndarray:
    """The inverse transpose: this process's point shards ``[B_pad / n,
    ..., k]`` in, its member columns of the first ``b`` points out, as one
    host array ``[b, ..., k_local]`` for the member file writes.

    The reference's ``letkf_gather_grid`` (module_mpi_util.f90:269-358).
    Every rank must call it.
    """
    if mesh.group is None:
        return torch.cat([s.cpu() for s in xa_shards])[:b, ..., :k].numpy()
    k_pad, kpp = _columns(k, mesh)
    n = mesh.size
    x = _pad_cols(xa_shards[0], k_pad)
    per, mid = x.shape[0], tuple(x.shape[1:-1])
    # [n, per, ..., kpp]: block s holds rank s's member columns
    x = x.reshape(per, *mid, n, kpp).movedim(-2, 0).contiguous()
    x = x.view(n * per, *mid, kpp)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.group)
    blk = member_block(k, mesh)
    return out[:b, ..., :blk.stop - blk.start].cpu().numpy()


def read_members_sharded(paths: Sequence[str], cfg, reader=None):
    """Member-parallel ingest: this process reads ONLY its member slice.

    Returns ``(ens_local, sl)``: the ensemble of the members of ``sl =
    my_member_slice(len(paths))`` (``ens_local.k`` is their count) and the
    slice.  The reference's rank-per-member read (cwb_letkf.f90:39-52).
    """
    if reader is None:
        from ..models.state import read_ensemble

        def reader(ps, c):
            return read_ensemble(ps, c, allow_subset=True)

    sl = my_member_slice(len(paths))
    local_paths = list(paths[sl])
    if not local_paths:
        raise ValueError(
            f"process owns no members ({len(paths)} members over "
            "more processes); use fewer processes or replicate")
    return reader(local_paths, cfg), sl
