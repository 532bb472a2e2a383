"""Device-mesh parallelism: the counterpart of module_mpi_util.f90.

Port of the JAX package's ``parallel/``.  The reference's MPI machinery
(cyclic 2-D domain decomposition, the member-layout <-> domain-layout
``mpi_alltoallv`` transposes, the obs broadcast) becomes one layout:
analysis points sharded over the mesh, obs copied to every device.  The
LETKF update is independent per gridpoint (letkf_core.f90:209-240), so
nothing is exchanged inside the update; the collectives are the row
gathers, the diagnostics reduction and, for member-block ingest, the two
transposes.  One process per card under ``torch.distributed`` (NCCL on
cards, gloo on the CPU), or an in-process mesh whose shards run in turn
(:mod:`.mesh`).
"""

from .mesh import make_mesh, shard_points
from .update import sharded_update_points

__all__ = ["make_mesh", "shard_points", "sharded_update_points"]
