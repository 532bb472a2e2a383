"""The port's per-variable and per-group updates against the JAX package.

Same float32 inputs into both packages: the case of tests/test_cycle.py at
16x16x4 points, one dense platform (synop, 300 records) and one bucketed
(vr, 9000 records), with equal candidate budgets.  JAX runs its
Newton-Schulz solve (the port's "auto") or eigh; the float64 runs are held
against the pure-Python oracle of tests/test_update.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cwbnwp_letkf_tpu.config import MAX_VARS
from cwbnwp_letkf_tpu.obs.base import PlatformStatic as JPlatformStatic
from cwbnwp_letkf_tpu.ops import dense as jdense
from cwbnwp_letkf_tpu.ops import solver as jsolver
from cwbnwp_letkf_tpu.ops import update as jupdate
from cwbnwp_letkf_torch.ops import eigh_kernel, solver, update

from .test_update import NORAIN, _mk_dbz_platform, _mk_gts_platform, _oracle
from .torch_parity import cycle_case, group_fields, to_port

CHUNK = 512


@pytest.fixture(scope="module")
def case():
    pts, xb_v, plats = cycle_case(nx=16, nz=4)
    assert plats[1][1].nrec >= update.BUCKET_MIN_RECORDS
    return pts, xb_v, plats


@pytest.fixture(autouse=True)
def _backends():
    jsolver.set_eigh_backend("ns")
    jdense.set_accum_precision("highest")
    yield
    jsolver.set_eigh_backend("auto")
    jdense.set_accum_precision("high")
    solver.set_eigh_backend("auto")


def _both(plats):
    return ([jupdate.prepare_platform(st, po) for st, po in plats],
            [update.prepare_platform(*to_port(st, po), device="cpu")
             for st, po in plats])


def _budgets(pts, jplats, tplats, ivar):
    jb = jupdate.plan_max_blocks(jnp.asarray(pts), jplats, ivar, chunk=CHUNK)
    tb = update.plan_max_blocks(torch.from_numpy(pts), tplats, ivar,
                                chunk=CHUNK)
    assert tb == jb and set(tb) == {"vr"}
    return jb, tb


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=5e-4 * np.abs(want).max())


@pytest.mark.parametrize("weight_function", [0, 1])
def test_update_points_matches_jax(case, weight_function):
    pts, xb_v, plats = case
    jplats, tplats = _both(plats)
    ivar, col = 3, 3                      # T: synop and vr at (24 km, 3 km)
    jb, tb = _budgets(pts, jplats, tplats, ivar)
    kw = dict(inflat=11 / 1.1, weight_function=weight_function, use_rtpp=True,
              rtpp_alpha=0.9, use_rtps=True, rtps_alpha=0.95, chunk=CHUNK,
              return_diagnostics=True)
    xa_j, diag_j = jupdate.update_points(
        jnp.asarray(xb_v[:, col]), jnp.asarray(pts), jplats, ivar,
        max_blocks=jb, **kw)
    xa, diag = update.update_points(
        torch.from_numpy(xb_v[:, col]), torch.from_numpy(pts), tplats, ivar,
        max_blocks=tb, **kw)
    assert int(diag["bucket_overflow"]) == 0 == int(diag_j["bucket_overflow"])
    assert float(diag["ns_residual"]) <= 1e-4
    _close(xa, xa_j)
    assert not np.array_equal(xa.numpy(), xb_v[:, col])


@pytest.mark.parametrize("weight_function", [0, 1])
def test_update_points_group_matches_jax(case, weight_function):
    pts, xb_v, plats = case
    jplats, tplats = _both(plats)
    ivars, inflats, rtpp, rtps = group_fields()[0]      # U, V
    jb, tb = _budgets(pts, jplats, tplats, ivars[0])
    kw = dict(inflats=inflats, weight_function=weight_function,
              rtpp_alpha=rtpp, rtps_alpha=rtps, chunk=CHUNK)
    xa_j = jupdate.update_points_group(
        jnp.asarray(xb_v[:, :2]), jnp.asarray(pts), jplats, ivars,
        max_blocks=jb, **kw)
    xa = update.update_points_group(
        torch.from_numpy(xb_v[:, :2]), torch.from_numpy(pts), tplats, ivars,
        max_blocks=tb, **kw)
    _close(xa, xa_j)


@pytest.mark.parametrize("k,kernel", [(12, "parallel"), (13, "cyclic")])
def test_jacobi_updates_match_jax_eigh(k, kernel):
    """Entries (b) and (c) of the eigen-solver path on the CPU: the group
    update at an even k and the per-variable update at an odd k, through
    the plain Jacobi versions, against JAX's eigh (no kernel is launched)."""
    pts, xb_v, plats = cycle_case(nx=12, nz=3, k=k)
    jplats, tplats = _both(plats)
    ivars, inflats, rtpp, rtps = group_fields(k)[0]
    solver.set_eigh_backend("jacobi")
    jsolver.set_eigh_backend("xla")
    before = dict(eigh_kernel.LAUNCHES)
    if kernel == "parallel":
        kw = dict(inflats=inflats, weight_function=0, rtpp_alpha=rtpp,
                  rtps_alpha=rtps, chunk=256)
        xa_j = jupdate.update_points_group(
            jnp.asarray(xb_v[:, :2]), jnp.asarray(pts), jplats, ivars, **kw)
        xa = update.update_points_group(
            torch.from_numpy(xb_v[:, :2]), torch.from_numpy(pts), tplats,
            ivars, **kw)
    else:
        kw = dict(inflat=inflats[0], weight_function=0, chunk=256)
        xa_j = jupdate.update_points(jnp.asarray(xb_v[:, 0]), jnp.asarray(pts),
                                     jplats, ivars[0], **kw)
        xa = update.update_points(torch.from_numpy(xb_v[:, 0]),
                                  torch.from_numpy(pts), tplats, ivars[0], **kw)
    assert eigh_kernel.LAUNCHES == before
    _close(xa, xa_j)


def _oracle_case(seed, nplat):
    rng = np.random.default_rng(seed)
    plats = [_mk_gts_platform(rng, 80, 3), _mk_dbz_platform(rng, 60)][:nplat]
    return rng, plats


@pytest.mark.parametrize("wf", [0, 1])
def test_update_points_float64_matches_oracle(wf):
    """tests/test_update.py:100-125 on the port: float64 solve, rtol 1e-8."""
    rng, plats = _oracle_case(21, 2)
    b = 40
    pts = np.stack([rng.uniform(-2e5, 2e5, b), rng.uniform(-2e5, 2e5, b),
                    rng.uniform(0.0, 1.5e4, b)], axis=1)
    pts[:5, 0] += 5e6   # far outside every localization ball: skipped
    xb = rng.normal(10.0, 3.0, (b, 6))
    inflat = 5 / 1.4
    dev = [update.prepare_platform(*to_port(st, po), device="cpu",
                                   norain_value=NORAIN) for st, po in plats]
    xa = update.update_points(
        torch.from_numpy(xb), torch.from_numpy(pts), dev, 2, inflat=inflat,
        weight_function=wf, solver_dtype=torch.float64, chunk=16)
    expected = _oracle(xb, pts, plats, 2, inflat, wf)
    np.testing.assert_allclose(xa.numpy(), expected, rtol=1e-8, atol=1e-10)
    changed = np.abs(xa.numpy() - xb).max(1) > 0
    assert changed.any() and (~changed).any()


def test_update_points_float64_rtpp_rtps_matches_oracle():
    """tests/test_update.py:128-142 on the port."""
    rng, plats = _oracle_case(22, 0)
    plats = [_mk_gts_platform(rng, 50, 2)]
    b = 12
    pts = np.stack([rng.uniform(-1e5, 1e5, b), rng.uniform(-1e5, 1e5, b),
                    rng.uniform(0, 1e4, b)], axis=1)
    xb = rng.normal(0.0, 1.0, (b, 6))
    flags = dict(use_rtpp=True, rtpp_alpha=0.9, use_rtps=True, rtps_alpha=0.7)
    dev = [update.prepare_platform(*to_port(st, po), device="cpu")
           for st, po in plats]
    xa = update.update_points(
        torch.from_numpy(xb), torch.from_numpy(pts), dev, 0, inflat=5.0,
        weight_function=0, solver_dtype=torch.float64, chunk=12, **flags)
    expected = _oracle(xb, pts, plats, 0, 5.0, 0, **flags)
    np.testing.assert_allclose(xa.numpy(), expected, rtol=1e-8, atol=1e-10)


def test_update_points_group_matches_per_variable():
    """tests/test_update.py:157-191 on the port: the fused group solve
    equals each variable's own, float64."""
    rng, _ = _oracle_case(24, 0)
    plats = [_mk_gts_platform(rng, 70, 3), _mk_dbz_platform(rng, 50)]
    b, v = 30, 3
    pts = np.stack([rng.uniform(-2e5, 2e5, b), rng.uniform(-2e5, 2e5, b),
                    rng.uniform(0, 1.4e4, b)], axis=1)
    xb = rng.normal(8.0, 2.0, (b, v, 6))
    ivars = (0, 2, 3)
    inflats = tuple(5 / rho for rho in (1.0, 1.4, 1.1))
    rtpp = (0.0, 0.9, 0.0)
    rtps = (0.7, 0.0, 0.0)
    dev = [update.prepare_platform(*to_port(st, po), device="cpu",
                                   norain_value=NORAIN) for st, po in plats]
    q = torch.from_numpy(pts)
    grouped = update.update_points_group(
        torch.from_numpy(xb), q, dev, ivars, inflats=inflats,
        weight_function=0, rtpp_alpha=rtpp, rtps_alpha=rtps,
        solver_dtype=torch.float64, chunk=16)
    for vi, ivar in enumerate(ivars):
        single = update.update_points(
            torch.from_numpy(xb[:, vi]), q, dev, ivar, inflat=inflats[vi],
            weight_function=0, use_rtpp=rtpp[vi] > 0, rtpp_alpha=rtpp[vi],
            use_rtps=rtps[vi] > 0, rtps_alpha=rtps[vi],
            solver_dtype=torch.float64, chunk=16)
        np.testing.assert_allclose(grouped[:, vi].numpy(), single.numpy(),
                                   rtol=1e-8, atol=1e-9)


def test_inactive_variable_keeps_background():
    rng = np.random.default_rng(23)
    st, po = _mk_gts_platform(rng, 30, 2)
    st_off = JPlatformStatic(**{**st.__dict__,
                                "hclr": tuple([-1.0] * MAX_VARS)})
    dev = [update.prepare_platform(*to_port(st_off, po), device="cpu")]
    xb = torch.from_numpy(rng.normal(size=(8, 2, 6)))
    q = torch.zeros((8, 3), dtype=torch.float64)
    xa, diag = update.update_points(xb[:, 0], q, dev, 0, inflat=5.0,
                                    weight_function=0, return_diagnostics=True)
    assert torch.equal(xa, xb[:, 0]) and int(diag["bucket_overflow"]) == 0
    xa = update.update_points_group(xb, q, dev, (0, 1), inflats=(5.0, 5.0),
                                    weight_function=0, rtpp_alpha=(0.0, 0.0),
                                    rtps_alpha=(0.0, 0.0))
    assert torch.equal(xa, xb)


def test_unported_options_raise(case):
    """An unknown method is refused; ``n_shards`` (once refused) plans the
    same platforms, shard by shard (its budgets are held equal to JAX's in
    tests/test_torch_sharding.py)."""
    pts, xb_v, plats = case
    _, tplats = _both(plats[:1])
    q = torch.from_numpy(pts)
    for n_shards in (2, 3):
        budgets = update.plan_max_blocks(q, tplats, 0, n_shards=n_shards)
        assert budgets.keys() == update.plan_max_blocks(q, tplats, 0).keys()
    with pytest.raises(ValueError):
        update.update_points(torch.from_numpy(xb_v[:, 0]), q, tplats, 0,
                             inflat=5.0, weight_function=0, method="kdtree")


class _Refused(Exception):
    pass


@pytest.mark.parametrize("entry", ["update_points", "update_points_group",
                                   "update_points_cycle"])
def test_entry_checks_ensemble_size_first(entry, monkeypatch):
    """No entry point refuses an ensemble size any more; the solve's branch
    is named from k before any launch (``solver.ns_route``).  With the
    card's routes (the CPU standing in for the card), each entry at
    ``ns_kernel.MAX_K`` = 128 members reaches K1, and a K1 that fails
    raises to the caller: the ``torch.matmul`` branch never stands in."""
    from cwbnwp_letkf_torch.ops import cycle, ns_kernel

    k = ns_kernel.MAX_K
    route = solver.ns_route
    seen = []

    def k1_fails(a_obs, inflat, **kwargs):
        seen.append(a_obs.shape[-1])
        raise _Refused

    monkeypatch.setattr(solver, "ns_route", lambda kk, device: route(kk, "cuda"))
    monkeypatch.setattr(ns_kernel, "ns_invsqrt_cuda", k1_fails)
    pts, xb_v, plats = cycle_case(nobs_vr=300, nx=4, nz=2, k=k)
    tplats = [update.prepare_platform(*to_port(st, po), device="cpu")
              for st, po in plats]
    q, xb = torch.from_numpy(pts), torch.from_numpy(xb_v)
    matmul = solver.LIBRARY_SOLVES["ns_matmul"]
    with pytest.raises(_Refused):
        if entry == "update_points":
            update.update_points(xb[:, 0], q, tplats, 0, inflat=k / 1.6,
                                 weight_function=0)
        elif entry == "update_points_group":
            update.update_points_group(xb[:, :2], q, tplats, [0, 1],
                                       inflats=[k / 1.6] * 2,
                                       weight_function=0,
                                       rtpp_alpha=[0.0] * 2,
                                       rtps_alpha=[0.0] * 2)
        else:
            groups = [cycle.CycleGroup(*f) for f in group_fields(k)]
            cycle.update_points_cycle(xb, q, tplats, groups,
                                      weight_function=0)
    assert seen == [k]
    assert solver.LIBRARY_SOLVES["ns_matmul"] == matmul
