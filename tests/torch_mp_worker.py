"""Worker of tests/test_torch_multihost.py: one gloo process of the port.

Run as: python torch_mp_worker.py <mode> <rank> <world> <port> [<dir>]

``transpose``: member_block ownership, the member->point transpose and its
inverse against a global array made from a seed, exactly, for k=7 and k=8
(k=7 leaves zero-padded columns at the last ranks).  ``cycle``: the fused
cycle over a mesh of the process group against the single-process cycle on
the same case, within 3e-5.  Prints ``MP-OK <rank>`` on success.  Imports
only the port (no jax), as on the card's machine.
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cwbnwp_letkf_torch.parallel.mesh import make_mesh, shard_points  # noqa: E402
from cwbnwp_letkf_torch.parallel.multihost import (  # noqa: E402
    make_member_sharded, member_block, member_group_to_points,
    members_to_points, points_to_member_columns)

mode, rank, world, port = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                           sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
mesh = make_mesh()
assert mesh.size == world and mesh.rank == rank and mesh.kinds == ("cpu",) * world


def check_transposes():
    b = 101                              # not a multiple of any world size
    per = -(-b // world)
    for k in (7, 8):
        glob = np.random.default_rng(k).standard_normal(
            (b, 3, k)).astype(np.float32)
        blk = member_block(k, mesh)
        kpp = -(-k // world)
        assert blk == slice(min(rank * kpp, k), min((rank + 1) * kpp, k))
        shards = member_group_to_points(mesh, glob[..., blk], k)
        assert len(shards) == 1 and shards[0].shape == (per, 3, k)
        want = np.zeros((per * world, 3, k), np.float32)
        want[:b] = glob
        np.testing.assert_array_equal(shards[0].numpy(),
                                      want[rank * per:(rank + 1) * per])
        back = points_to_member_columns(mesh, shards, k, b)
        np.testing.assert_array_equal(back, glob[..., blk])
        # the two-step form: member blocks, then the transpose
        blocks = make_member_sharded(mesh, glob[:, 0, blk], k)
        assert blocks[0].shape == (b, kpp)
        pts = members_to_points(mesh, blocks, k)[0]
        np.testing.assert_array_equal(pts.numpy(), want[rank * per:(rank + 1)
                                                        * per, 0])


def check_cycle():
    from cwbnwp_letkf_torch.config import MAX_VARS
    from cwbnwp_letkf_torch.obs.base import PlatformStatic
    from cwbnwp_letkf_torch.obs.synthetic import (correlated_ensemble,
                                                  idealized_grid,
                                                  synthetic_gts_platform)
    from cwbnwp_letkf_torch.ops import cycle, update
    from cwbnwp_letkf_torch.parallel.update import (
        sharded_update_points_cycle, update_points_cycle_shards)

    rng = np.random.default_rng(0)
    pts = idealized_grid(16, 16, 4, dx_m=50e3)[:1000]
    truth, xb = correlated_ensemble(rng, pts, 8, n_bumps=6, length_m=2e5)
    plats = []
    for name, nobs, nvar, radii in (("synop", 300, 2, (50.0, 3.0)),
                                    ("vr", 9000, 1, (36.0, 3.0))):
        st, po = synthetic_gts_platform(rng, pts, truth, xb, name=name,
                                        nobs=nobs, nvar=nvar, max_lz_pts=40,
                                        extent_frac=1.0)
        st = PlatformStatic(
            name=name, kind=st.kind, nvar=nvar, max_lz_pts=40,
            hclr=(radii[0],) * MAX_VARS, vclr=(radii[1],) * MAX_VARS,
            err_muti=st.err_muti, err_rej=st.err_rej, is_assim=st.is_assim)
        plats.append(update.prepare_platform(st, po, device="cpu"))
    groups = [cycle.CycleGroup((0, 1), (7 / 1.6, 7 / 1.1), (0.9, 0.0),
                               (0.0, 0.95))]
    q = torch.from_numpy(pts)
    xb_v = torch.from_numpy(np.stack([xb, 1.5 * xb], 1))
    kw = dict(weight_function=0, chunk=256, subchunk=64)
    single, sdiag = cycle.update_points_cycle(
        xb_v, q, plats, groups, return_diagnostics=True,
        max_blocks=cycle.plan_cycle_budgets(q, plats, groups, chunk=256,
                                            subchunk=64), **kw)
    budgets = cycle.plan_cycle_budgets(q, plats, groups, chunk=256,
                                       subchunk=64, n_shards=world)
    xa, diag = sharded_update_points_cycle(
        mesh, xb_v, q, plats, groups, max_blocks=budgets,
        return_diagnostics=True, **kw)
    assert int(diag["bucket_overflow"]) == 0
    assert float(diag["ns_residual"]) <= 1e-4
    np.testing.assert_allclose(xa.numpy(), single.numpy(), rtol=3e-5,
                               atol=3e-5)
    # run_analysis's distributed form: local shards between the transposes
    shards, diag2 = update_points_cycle_shards(
        mesh, member_group_to_points(mesh, xb_v.numpy()[..., member_block(
            8, mesh)], 8), shard_points(mesh, q)[0], plats, groups,
        max_blocks=budgets, **kw)
    assert int(diag2["bucket_overflow"]) == 0
    back = points_to_member_columns(mesh, shards, 8, q.shape[0])
    np.testing.assert_array_equal(back, xa.numpy()[..., member_block(8, mesh)])
    # an undersized budget: every shard's dropped blocks, summed over ranks
    _, small = sharded_update_points_cycle(
        mesh, xb_v, q, plats, groups, max_blocks=1,
        return_diagnostics=True, **kw)
    per = -(-q.shape[0] // world)
    lo = rank * per
    mine = cycle.update_points_cycle(
        xb_v[lo:lo + per], q[lo:lo + per], plats, groups, max_blocks=1,
        return_diagnostics=True, **kw)[1]["bucket_overflow"].clone()
    dist.all_reduce(mine)
    assert int(small["bucket_overflow"]) == int(mine) > 0


{"transpose": check_transposes, "cycle": check_cycle}[mode]()
dist.barrier()
print(f"MP-OK {rank}", flush=True)
dist.destroy_process_group()
