"""Device mesh and point-batch sharding.

Port of the JAX package's ``parallel/mesh.py``.  One mesh axis, ``"grid"``,
shards the flattened analysis-point batch: the counterpart of the
reference's cyclic 2-D (x, y) rank decomposition
(module_mpi_util.f90:38-188).  Every shard runs the same update on an equal
contiguous piece of the padded batch, so contiguous shards serve as well as
the reference's interleaving.

A :class:`Mesh` takes one of two forms.

* **Process group.**  Under an initialized ``torch.distributed`` process
  group (NCCL on cards, gloo on the CPU) the mesh spans the group's ranks,
  one device per rank: each process holds and runs its own shard, so the
  shards run concurrently, one on each card.
* **In-process.**  Without a process group the mesh lies over the devices
  given, which may repeat (``[cpu] * 8`` for tests, ``[cuda:0, cuda:0]`` to
  shard on one card).  This one process runs its shards in turn, one after
  the other, so an in-process mesh over several cards is not faster than
  one card.

The collectives live in :mod:`.update` (the gathers and the diagnostics
reduction) and :mod:`.multihost` (the member/point transposes).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..ops.bucketed import pad_last
from ..ops.update import DevicePlatform
from ..ops.whiten import ObsStats

GRID_AXIS = "grid"


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``devices[s]`` runs shard ``s``.

    ``group`` is the process group (None: in-process) and ``rank`` this
    process's shard under it; ``kinds`` names each device's model.
    """

    devices: Tuple[torch.device, ...]
    kinds: Tuple[str, ...]
    group: Optional[object] = None
    rank: int = 0

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {GRID_AXIS: self.size}

    @property
    def n_processes(self) -> int:
        """Processes the mesh spans: its size under a group, else 1."""
        return self.size if self.group is not None else 1

    def local_shards(self) -> List[Tuple[int, torch.device]]:
        """``(shard, device)`` of every shard this process runs."""
        if self.group is None:
            return list(enumerate(self.devices))
        return [(self.rank, self.devices[self.rank])]


def device_kind(device: torch.device) -> str:
    """The device's model name (``torch.cuda.get_device_name``), or
    ``"cpu"``."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def _concrete(device) -> torch.device:
    """``device`` with its index: ``cuda`` becomes the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def process_device(group=None) -> torch.device:
    """This rank's device under the process group: the bound card under
    NCCL, the CPU under gloo."""
    if dist.get_backend(group) == "nccl":
        return _concrete("cuda")
    return torch.device("cpu")


def make_mesh(devices: Optional[Sequence] = None, *, group=None) -> Mesh:
    """A 1-D mesh, axis ``"grid"``.

    Under an initialized process group (or over ``group``, a subgroup that
    this rank belongs to; every member calls this together) it spans the
    group's ranks, one device per rank, and ``devices`` must be None.
    Otherwise it is an in-process mesh over ``devices``, by default every
    visible card; without a card the devices must be given.
    """
    if group is not None or (dist.is_available() and dist.is_initialized()):
        if devices is not None:
            raise ValueError("under a process group the mesh spans its ranks, "
                             "one device each; pass no devices")
        group = group if group is not None else dist.group.WORLD
        dev = process_device(group)
        pairs = [None] * dist.get_world_size(group)
        dist.all_gather_object(pairs, (str(dev), device_kind(dev)),
                               group=group)
        return Mesh(devices=tuple(torch.device(d) for d, _ in pairs),
                    kinds=tuple(kind for _, kind in pairs), group=group,
                    rank=dist.get_rank(group))
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices, e.g. "
                               "[torch.device('cpu')] * n, for a CPU mesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = tuple(_concrete(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devices=devs, kinds=tuple(device_kind(d) for d in devs))


def padded_size(b: int, n: int) -> int:
    """``b`` rounded up to a multiple of ``n``."""
    return -(-b // n) * n


def pad_rows(x: torch.Tensor, b_pad: int, *, zeros: bool = False):
    """``x`` padded to ``b_pad`` rows with copies of its last row (or
    zeros)."""
    pad = b_pad - x.shape[0]
    if not zeros:
        return pad_last(x, pad)
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))]) if pad \
        else x


def shard_points(mesh: Mesh, *arrays) -> tuple:
    """This process's shards of each array along its leading (point) axis.

    The axis is padded to a multiple of the mesh size with copies of its
    last row and split into equal contiguous shards; each array gives a list
    with one shard per :meth:`Mesh.local_shards` entry, on its device.
    """
    out = []
    for a in arrays:
        a = torch.as_tensor(a)
        a = pad_rows(a, padded_size(a.shape[0], mesh.size))
        per = a.shape[0] // mesh.size
        out.append([a[s * per:(s + 1) * per].to(d)
                    for s, d in mesh.local_shards()])
    return tuple(out)


def _to(tree, device: torch.device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, DevicePlatform):
        if tree.xyz.device == device:
            return tree                 # the same platform, its cache too
        return DevicePlatform(static=tree.static, xyz=tree.xyz.to(device),
                              stats=ObsStats(*(t.to(device)
                                               for t in tree.stats)),
                              cache={})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to(x, device) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(x, device) for x in tree)
    if isinstance(tree, dict):
        return {key: _to(x, device) for key, x in tree.items()}
    return tree


def replicate(mesh: Mesh, tree) -> list:
    """``tree`` (tensors in lists, tuples, dicts, or platforms) copied to
    the device of each of this process's shards, one copy per shard; a
    shard on the device the tree is on gets the tree itself."""
    return [_to(tree, d) for _, d in mesh.local_shards()]
