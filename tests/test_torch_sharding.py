"""The port's sharded updates (``parallel/update.py``) against its
single-device path and the JAX package's sharded updates, on the CPU.

Mirrors tests/test_sharding.py on in-process meshes of eight and two CPU
shards (the JAX side on tests/conftest.py's eight virtual CPU devices),
with its tolerance, rtol = atol = 3e-5: the shards chunk their own points,
so float32 results differ from the single path at roundoff.  The inputs are
float32 and made from numpy seeds; JAX runs its Newton-Schulz solve with
full float32 accumulation, which the port reproduces.  Per-shard budgets
(``n_shards``) are held equal to JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cwbnwp_letkf_tpu.config import MAX_VARS
from cwbnwp_letkf_tpu.obs.base import PlatformStatic, make_platform_obs
from cwbnwp_letkf_tpu.ops import cycle as jcycle
from cwbnwp_letkf_tpu.ops import dense as jdense
from cwbnwp_letkf_tpu.ops import solver as jsolver
from cwbnwp_letkf_tpu.ops import update as jupdate
from cwbnwp_letkf_tpu.parallel import make_mesh as jmake_mesh
from cwbnwp_letkf_tpu.parallel import update as jparallel
from cwbnwp_letkf_torch.ops import cycle, update
from cwbnwp_letkf_torch.parallel import make_mesh, sharded_update_points
from cwbnwp_letkf_torch.parallel.update import (sharded_update_points_cycle,
                                                sharded_update_points_group)

from .torch_parity import (cycle_case, group_fields,  # noqa: F401
                           one_torch_thread, to_port)

K = 8
TOL = dict(rtol=3e-5, atol=3e-5)
#: the sharded cycle's chunk and subchunk
CHUNK, SUB = 128, 32
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _ns_full_f32():
    jsolver.set_eigh_backend("ns")
    jdense.set_accum_precision("highest")
    yield
    jsolver.set_eigh_backend("auto")
    jdense.set_accum_precision("high")


def _case(rng, nrec=70, b=100):
    """tests/test_sharding.py::_case, in float32."""
    f32 = np.float32
    xyz = np.stack([rng.uniform(-2e5, 2e5, nrec), rng.uniform(-2e5, 2e5, nrec),
                    rng.uniform(0, 1e4, nrec)], axis=1).astype(f32)
    obs = rng.normal(0, 2, (2, nrec)).astype(f32)
    hdxb = (obs[:, :, None] + rng.normal(0, 1, (2, nrec, K))).astype(f32)
    error = rng.uniform(0.5, 2, (2, nrec)).astype(f32)
    po = make_platform_obs(xyz, obs, hdxb, error, np.zeros((2, nrec, K), f32))
    st = PlatformStatic(
        name="synop", kind="gts", nvar=2, max_lz_pts=48,
        hclr=tuple([60.0] * MAX_VARS), vclr=tuple([3.0] * MAX_VARS),
        err_muti=(1.0, 0.9), err_rej=(5.0, 5.0),
        is_assim=tuple(tuple([True] * MAX_VARS) for _ in range(2)))
    pts = np.stack([rng.uniform(-2e5, 2e5, b), rng.uniform(-2e5, 2e5, b),
                    rng.uniform(0, 1e4, b)], axis=1).astype(f32)
    xb = rng.normal(5, 2, (b, K)).astype(f32)
    return st, po, pts, xb


def _both(st, po):
    """``(JAX platforms, port platforms)`` of one platform."""
    return ([jupdate.prepare_platform(st, po)],
            [update.prepare_platform(*to_port(st, po), device="cpu")])


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_eight_devices_match_single_device():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    rng = np.random.default_rng(31)
    st, po, pts, xb = _case(rng)
    jdev, dev = _both(st, po)
    kw = dict(inflat=(K - 1) / 1.2, weight_function=0, use_rtps=True,
              rtps_alpha=0.9, chunk=16)
    xb_t, q = _t(xb, pts)
    single = update.update_points(xb_t, q, dev, 0, **kw)
    mesh = make_mesh([CPU] * 8)
    # b=100 is not divisible by 8: the padding path too
    multi, diag = sharded_update_points(mesh, xb_t, q, dev, 0,
                                        return_diagnostics=True, **kw)
    assert multi.shape == (100, K) and int(diag["bucket_overflow"]) == 0
    np.testing.assert_allclose(multi.numpy(), single.numpy(), **TOL)
    jmulti = jparallel.sharded_update_points(
        jmake_mesh(), jnp.asarray(xb), jnp.asarray(pts), jdev, 0, **kw)
    np.testing.assert_allclose(multi.numpy(), np.asarray(jmulti), **TOL)


def test_two_device_submesh():
    rng = np.random.default_rng(32)
    st, po, pts, xb = _case(rng, b=64)
    jdev, dev = _both(st, po)
    kw = dict(inflat=(K - 1) / 1.0, weight_function=1, chunk=32)
    xb_t, q = _t(xb, pts)
    single = update.update_points(xb_t, q, dev, 0, **kw)
    multi = sharded_update_points(make_mesh([CPU] * 2), xb_t, q, dev, 0, **kw)
    np.testing.assert_allclose(multi.numpy(), single.numpy(), **TOL)
    jmulti = jparallel.sharded_update_points(
        jmake_mesh(jax.devices()[:2]), jnp.asarray(xb), jnp.asarray(pts),
        jdev, 0, **kw)
    np.testing.assert_allclose(multi.numpy(), np.asarray(jmulti), **TOL)


def test_sharded_bucketed_matches_single_device():
    """The bucketed branch: per-shard budgets equal JAX's, keep overflow at
    0, and the analysis equals the single-device bucketed update."""
    rng = np.random.default_rng(34)
    st, po, pts, _ = _case(rng, nrec=3000, b=500)
    jdev, dev = _both(st, po)
    xb = rng.normal(5, 2, (500, 2, K)).astype(np.float32)
    kw = dict(inflats=((K - 1) / 1.2, (K - 1) / 1.0),
              weight_function=0, rtpp_alpha=(0.0, 0.8),
              rtps_alpha=(0.9, 0.0), chunk=64, method="bucketed")
    xb_t, q = _t(xb, pts)
    single, sdiag = update.update_points_group(
        xb_t, q, dev, (0, 1), return_diagnostics=True, **kw)
    assert int(sdiag["bucket_overflow"]) == 0

    budgets = update.plan_max_blocks(q, dev, 0, chunk=64, method="bucketed",
                                     n_shards=8)
    assert budgets == jupdate.plan_max_blocks(
        jnp.asarray(pts), jdev, 0, chunk=64, method="bucketed", n_shards=8)
    multi, mdiag = sharded_update_points_group(
        make_mesh([CPU] * 8), xb_t, q, dev, (0, 1), max_blocks=budgets,
        return_diagnostics=True, **kw)
    assert int(mdiag["bucket_overflow"]) == 0
    np.testing.assert_allclose(multi.numpy(), single.numpy(), **TOL)


def test_ns_solver_under_shard_map():
    """The Newton-Schulz solve in every shard (the port's "auto"), against
    the single path and JAX's sharded NS solve."""
    rng = np.random.default_rng(36)
    st, po, pts, xb = _case(rng, b=64)
    jdev, dev = _both(st, po)
    kw = dict(inflat=(K - 1) / 1.2, weight_function=0, chunk=16)
    xb_t, q = _t(xb, pts)
    single = update.update_points(xb_t, q, dev, 0, **kw)
    multi, diag = sharded_update_points(make_mesh([CPU] * 8), xb_t, q, dev,
                                        0, return_diagnostics=True, **kw)
    assert 0 < float(diag["ns_residual"]) <= 1e-4
    np.testing.assert_allclose(multi.numpy(), single.numpy(), **TOL)
    jmulti = jparallel.sharded_update_points(
        jmake_mesh(), jnp.asarray(xb), jnp.asarray(pts), jdev, 0, **kw)
    np.testing.assert_allclose(multi.numpy(), np.asarray(jmulti), **TOL)


def test_shard_local_budget_exceeds_global_plan_when_needed():
    """n_shards-aware planning equals JAX's and can only grow the budgets
    against the global plan; the global plan undersizes some shard here,
    which the summed overflow shows."""
    rng = np.random.default_rng(35)
    st, po, pts, xb = _case(rng, nrec=3000, b=333)
    jdev, dev = _both(st, po)
    q = torch.from_numpy(pts)
    g1 = update.plan_max_blocks(q, dev, 0, chunk=64, method="bucketed")
    g8 = update.plan_max_blocks(q, dev, 0, chunk=64, method="bucketed",
                                n_shards=8)
    for n_shards, got in ((1, g1), (8, g8)):
        assert got == jupdate.plan_max_blocks(
            jnp.asarray(pts), jdev, 0, chunk=64, method="bucketed",
            n_shards=n_shards)
    assert set(g1) == set(g8) == {"synop"}
    assert g1["synop"].block_size == g8["synop"].block_size
    assert g8["synop"].max_blocks >= max(16, g1["synop"].max_blocks)
    kw = dict(inflat=(K - 1) / 1.2, weight_function=0, chunk=64,
              method="bucketed", return_diagnostics=True)
    mesh = make_mesh([CPU] * 8)
    _, diag = sharded_update_points(mesh, torch.from_numpy(xb), q, dev, 0,
                                    max_blocks=g8, **kw)
    assert int(diag["bucket_overflow"]) == 0
    small = {"synop": g1["synop"]._replace(max_blocks=1)}
    _, diag = sharded_update_points(mesh, torch.from_numpy(xb), q, dev, 0,
                                    max_blocks=small, **kw)
    per_shard = sum(int(update.update_points(
        torch.from_numpy(xb[s * 42:(s + 1) * 42]), q[s * 42:(s + 1) * 42],
        dev, 0, max_blocks=small, **kw)[1]["bucket_overflow"])
        for s in range(7))
    last = torch.cat([q[294:], q[-1:].expand(3, 3)])
    per_shard += int(update.update_points(
        torch.zeros((42, K)), last, dev, 0, max_blocks=small,
        **kw)[1]["bucket_overflow"])
    assert int(diag["bucket_overflow"]) == per_shard > 0


def test_sharded_group_matches_single_device_group():
    rng = np.random.default_rng(33)
    st, po, pts, _ = _case(rng, b=100)
    jdev, dev = _both(st, po)
    xb = rng.normal(5, 2, (100, 3, K)).astype(np.float32)
    kw = dict(inflats=((K - 1) / 1.2, (K - 1) / 1.0, (K - 1) / 1.5),
              weight_function=0, rtpp_alpha=(0.0, 0.8, 0.0),
              rtps_alpha=(0.9, 0.0, 0.0), chunk=16)
    xb_t, q = _t(xb, pts)
    single = update.update_points_group(xb_t, q, dev, (0, 1, 2), **kw)
    multi = sharded_update_points_group(make_mesh([CPU] * 8), xb_t, q, dev,
                                        (0, 1, 2), **kw)
    np.testing.assert_allclose(multi.numpy(), single.numpy(), **TOL)
    jmulti = jparallel.sharded_update_points_group(
        jmake_mesh(), jnp.asarray(xb), jnp.asarray(pts), jdev, (0, 1, 2),
        **kw)
    np.testing.assert_allclose(multi.numpy(), np.asarray(jmulti), **TOL)


@pytest.fixture(scope="module")
def cycle_inputs():
    """tests/test_torch_cycle.py's case on a 12x12x3 grid (432 points, four
    chunks of 128), its port platforms and groups, and the port's
    single-device cycle on it."""
    pts, xb_v, plats = cycle_case(nx=12, nz=3)
    tplats = [update.prepare_platform(*to_port(st, po), device="cpu")
              for st, po in plats]
    groups = [cycle.CycleGroup(*f) for f in group_fields()]
    q, xb = _t(pts, xb_v)
    single = cycle.update_points_cycle(
        xb, q, tplats, groups, weight_function=0, chunk=CHUNK, subchunk=SUB,
        max_blocks=cycle.plan_cycle_budgets(q, tplats, groups, chunk=CHUNK,
                                            subchunk=SUB))
    return pts, xb_v, plats, tplats, groups, single


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_cycle_matches_single_and_jax(cycle_inputs, n_shards):
    """The fused cycle (one dense and one bucketed platform, five groups)
    over n shards: budgets equal JAX's ``plan_cycle_budgets(n_shards=n)``,
    no overflow, within 3e-5 of the port's single cycle, which
    tests/test_torch_cycle.py holds against JAX's.  (JAX's sharded cycle
    takes about 100 s to compile on the CPU, so it is not run here.)"""
    pts, xb_v, plats, tplats, groups, single = cycle_inputs
    jplats = [jupdate.prepare_platform(st, po) for st, po in plats]
    jgroups = [jcycle.CycleGroup(*f) for f in group_fields()]
    q, xb = _t(pts, xb_v)
    budgets = cycle.plan_cycle_budgets(q, tplats, groups, chunk=CHUNK,
                                       subchunk=SUB, n_shards=n_shards)
    assert budgets == jcycle.plan_cycle_budgets(
        jnp.asarray(pts), jplats, jgroups, chunk=CHUNK, subchunk=SUB,
        n_shards=n_shards)
    multi, diag = sharded_update_points_cycle(
        make_mesh([CPU] * n_shards), xb, q, tplats, groups,
        weight_function=0, chunk=CHUNK, subchunk=SUB, max_blocks=budgets,
        return_diagnostics=True)
    assert int(diag["bucket_overflow"]) == 0
    assert float(diag["ns_residual"]) <= 1e-4
    np.testing.assert_allclose(multi.numpy(), single.numpy(), **TOL)
