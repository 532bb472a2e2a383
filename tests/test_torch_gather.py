"""The port's gather path against the JAX package's, on the CPU.

The neighbor search (``ops/neighbors.radius_neighbors``), the gathered
normal terms (``ops/whiten.accumulate_platform_terms``) and
``update_points`` / ``update_points_group`` with ``method="gather"``.  The
cases are those of tests/test_neighbors.py and tests/test_update.py; float64
cases compare exactly where the JAX tests do, the float32 ones allow what
float32 rounding can move (a record tied at the cap).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cwbnwp_letkf_tpu.constants import GC1999_SQ
from cwbnwp_letkf_tpu.ops import dense as jdense
from cwbnwp_letkf_tpu.ops import neighbors as jneighbors
from cwbnwp_letkf_tpu.ops import solver as jsolver
from cwbnwp_letkf_tpu.ops import update as jupdate
from cwbnwp_letkf_tpu.ops import whiten as jwhiten
from cwbnwp_letkf_torch.ops import neighbors, update, whiten

from . import reference_impl as ref
from .test_update import NORAIN, _mk_dbz_platform, _mk_gts_platform, _oracle
from .torch_parity import cycle_case, group_fields, to_port


@pytest.fixture(autouse=True)
def _backends():
    jsolver.set_eigh_backend("ns")
    jdense.set_accum_precision("highest")
    yield
    jsolver.set_eigh_backend("auto")
    jdense.set_accum_precision("high")


def _sets(nb, row):
    idx, mask = np.asarray(nb.idx[row]), np.asarray(nb.mask[row])
    return set(idx[mask].tolist())


def _neighbor_case(name):
    """``(query [B, 3], obs [N, 3], n_max, obs_valid or None)``, float64,
    the cases of tests/test_neighbors.py and one with N < n_max."""
    if name == "brute_3d":
        rng = np.random.default_rng(11)
        return (rng.uniform(-8, 8, (64, 3)), rng.uniform(-8, 8, (500, 3)),
                64, None)
    if name == "cap_nearest":
        rng = np.random.default_rng(12)
        return np.zeros((1, 3)), rng.uniform(-1, 1, (300, 3)), 10, None
    if name == "2d":
        rng = np.random.default_rng(13)

        def pts(n):
            return np.stack([rng.uniform(-2e5, 2e5, n),
                             rng.uniform(-2e5, 2e5, n),
                             rng.uniform(0, 2e4, n)], axis=1)
        obs_m, q_m = pts(40), pts(8)
        scale = np.array([1 / 50e3, 1 / 50e3, 0.0])
        return q_m * scale, obs_m * scale, 40, None
    if name == "obs_valid":
        rng = np.random.default_rng(14)
        valid = np.zeros(50, bool)
        valid[::7] = True
        return np.zeros((3, 3)), rng.uniform(-1, 1, (50, 3)), 16, valid
    if name == "empty":
        return np.zeros((3, 3)), np.zeros((0, 3)), 8, None
    rng = np.random.default_rng(15)           # fewer records than the cap
    return rng.uniform(-2, 2, (20, 3)), rng.uniform(-2, 2, (7, 3)), 16, None


@pytest.mark.parametrize("name", ["brute_3d", "cap_nearest", "2d",
                                  "obs_valid", "empty", "fewer_than_cap"])
def test_radius_neighbors_matches_jax(name):
    q, obs, n_max, valid = _neighbor_case(name)
    got = neighbors.radius_neighbors(
        torch.from_numpy(q), torch.from_numpy(obs), n_max=n_max, chunk=32,
        obs_valid=None if valid is None else torch.from_numpy(valid))
    want = jneighbors.radius_neighbors(
        jnp.asarray(q), jnp.asarray(obs), n_max=n_max, chunk=32,
        obs_valid=None if valid is None else jnp.asarray(valid))
    assert tuple(got.idx.shape) == (q.shape[0], n_max)
    assert np.array_equal(got.mask.sum(1).numpy(),
                          np.asarray(want.mask).sum(1))
    for i in range(q.shape[0]):
        assert _sets(got, i) == _sets(want, i)
        idx, brute_r2 = ref.radius_neighbors_brute(
            obs.T, q[i], GC1999_SQ) if obs.shape[0] else ([], [])
        if valid is not None:
            keep = valid[np.asarray(idx, int)]
            idx, brute_r2 = np.asarray(idx)[keep], np.asarray(brute_r2)[keep]
        assert _sets(got, i) == set(np.asarray(idx[:n_max]).tolist())
        m = got.mask[i].numpy()
        mj = np.asarray(want.mask[i])
        np.testing.assert_allclose(np.sort(got.r2[i].numpy()[m]),
                                   np.sort(np.asarray(want.r2[i])[mj]),
                                   rtol=1e-12, atol=0)
        assert np.isinf(got.r2[i].numpy()[~m]).all()
    if name == "empty":
        assert not got.mask.any()


def test_radius_neighbors_float32_ties_at_the_cap():
    """Float32 at a binding cap: the sets equal JAX's on every row but those
    whose n_max-th and (n_max+1)-th nearest r2 lie within 4 float32 ulps,
    where the two roundings may keep a different record."""
    rng = np.random.default_rng(16)
    q = rng.uniform(-3, 3, (256, 3)).astype(np.float32)
    obs = rng.uniform(-3, 3, (4000, 3)).astype(np.float32)
    n_max = 40
    got = neighbors.radius_neighbors(torch.from_numpy(q),
                                     torch.from_numpy(obs), n_max=n_max)
    want = jneighbors.radius_neighbors(jnp.asarray(q), jnp.asarray(obs),
                                       n_max=n_max)
    d2 = ((q[:, None, :].astype(np.float64) - obs[None]) ** 2).sum(-1)
    edge = np.sort(d2, axis=1)[:, n_max - 1:n_max + 1]
    tied = np.abs(edge[:, 1] - edge[:, 0]) <= 4 * np.spacing(
        edge[:, 0].astype(np.float32))
    differ = [i for i in range(q.shape[0]) if _sets(got, i) != _sets(want, i)]
    assert all(tied[i] for i in differ), differ
    assert len(differ) <= int(tied.sum())
    assert int(got.mask.sum(1).min()) == n_max   # the cap binds everywhere


@pytest.mark.parametrize("wf", [0, 1])
def test_accumulate_platform_terms_matches_jax(wf):
    """One neighbor set into both packages' gathers, float64, rtol 1e-10."""
    rng = np.random.default_rng(31)
    st, po = _mk_gts_platform(rng, 90, 3)
    q_m = np.stack([rng.uniform(-2e5, 2e5, 48), rng.uniform(-2e5, 2e5, 48),
                    rng.uniform(0, 1.5e4, 48)], axis=1)
    q_m[:4, 0] += 5e6                          # no neighbor at all
    ivar = 2
    jdp = jupdate.prepare_platform(st, po)
    tdp = update.prepare_platform(*to_port(st, po), device="cpu")
    on = jneighbors.normalize_coords(jnp.asarray(po.xyz), st.hclr[ivar],
                                     st.vclr[ivar])
    qn = jneighbors.normalize_coords(jnp.asarray(q_m), st.hclr[ivar],
                                     st.vclr[ivar])
    nb = jneighbors.radius_neighbors(qn, on, n_max=st.max_lz_pts)
    # masked slots may carry indices past the last record (sentinels): put
    # every one there, which JAX clips and the port must clamp
    mask = np.asarray(nb.mask)
    idx = np.where(mask, np.asarray(nb.idx), po.xyz.shape[0] + 5
                   + np.arange(mask.shape[1])).astype(np.int32)
    nb = nb._replace(idx=jnp.asarray(idx))
    want = jwhiten.accumulate_platform_terms(
        nb, jdp.stats, st.assim_mask(ivar), wf, solver_dtype=jnp.float64)
    tnb = neighbors.NeighborSet(
        idx=torch.from_numpy(idx).long(),
        r2=torch.from_numpy(np.array(nb.r2)),
        mask=torch.from_numpy(mask.copy()))
    got = whiten.accumulate_platform_terms(
        tnb, tdp.stats, st.assim_mask(ivar), wf, solver_dtype=torch.float64)
    for x, y in zip(got[:2], want[:2]):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-10,
                                   atol=1e-12 * np.abs(np.asarray(y)).max())
    assert got[2].dtype == torch.int32
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert (got[2][:4] == 0).all() and (got[2] > 0).any()
    with pytest.raises(ValueError, match="no active vars"):
        whiten.accumulate_platform_terms(tnb, tdp.stats, (False,) * 3, wf)


def _oracle_inputs(seed=21):
    rng = np.random.default_rng(seed)
    plats = [_mk_gts_platform(rng, 80, 3), _mk_dbz_platform(rng, 60)]
    b = 40
    pts = np.stack([rng.uniform(-2e5, 2e5, b), rng.uniform(-2e5, 2e5, b),
                    rng.uniform(0.0, 1.5e4, b)], axis=1)
    pts[:5, 0] += 5e6   # far outside every localization ball: skipped
    return rng, plats, pts


@pytest.mark.parametrize("wf", [0, 1])
def test_update_points_gather_matches_jax_and_oracle(wf):
    """tests/test_update.py:66-97 with method="gather", float64: the dbz
    platform holds fewer records (60) than its cap (128)."""
    rng, plats, pts = _oracle_inputs()
    xb = rng.normal(10.0, 3.0, (pts.shape[0], 6))
    ivar, inflat = 2, 5 / 1.4
    kw = dict(inflat=inflat, weight_function=wf, chunk=16, method="gather")
    tdev = [update.prepare_platform(*to_port(st, po), device="cpu",
                                    norain_value=NORAIN) for st, po in plats]
    jdev = [jupdate.prepare_platform(st, po, norain_value=NORAIN)
            for st, po in plats]
    xa = update.update_points(torch.from_numpy(xb), torch.from_numpy(pts),
                              tdev, ivar, solver_dtype=torch.float64, **kw)
    xa_j = jupdate.update_points(jnp.asarray(xb), jnp.asarray(pts), jdev,
                                 ivar, solver_dtype=jnp.float64, **kw)
    expected = _oracle(xb, pts, plats, ivar, inflat, wf)
    np.testing.assert_allclose(xa.numpy(), np.asarray(xa_j), rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(xa.numpy(), expected, rtol=1e-8, atol=1e-10)
    changed = np.abs(xa.numpy() - xb).max(1) > 0
    assert changed.any() and not changed[:5].any()


@pytest.mark.parametrize("wf", [0, 1])
def test_update_points_group_gather_matches_jax_and_oracle(wf):
    """The group update of two variables sharing their localization, with
    their own inflation and relaxation, against JAX and per variable
    against the oracle, float64."""
    rng, plats, pts = _oracle_inputs(25)
    b = pts.shape[0]
    xb = rng.normal(8.0, 2.0, (b, 2, 6))
    ivars, inflats = (0, 2), (5 / 1.0, 5 / 1.4)
    rtpp, rtps = (0.9, 0.0), (0.0, 0.7)
    kw = dict(inflats=inflats, weight_function=wf, rtpp_alpha=rtpp,
              rtps_alpha=rtps, chunk=16, method="gather")
    tdev = [update.prepare_platform(*to_port(st, po), device="cpu",
                                    norain_value=NORAIN) for st, po in plats]
    jdev = [jupdate.prepare_platform(st, po, norain_value=NORAIN)
            for st, po in plats]
    xa = update.update_points_group(
        torch.from_numpy(xb), torch.from_numpy(pts), tdev, ivars,
        solver_dtype=torch.float64, **kw)
    xa_j = jupdate.update_points_group(
        jnp.asarray(xb), jnp.asarray(pts), jdev, ivars,
        solver_dtype=jnp.float64, **kw)
    np.testing.assert_allclose(xa.numpy(), np.asarray(xa_j), rtol=1e-8,
                               atol=1e-10)
    for vi, ivar in enumerate(ivars):
        expected = _oracle(xb[:, vi], pts, plats, ivar, inflats[vi], wf,
                           use_rtpp=rtpp[vi] > 0, rtpp_alpha=rtpp[vi],
                           use_rtps=rtps[vi] > 0, rtps_alpha=rtps[vi])
        np.testing.assert_allclose(xa[:, vi].numpy(), expected, rtol=1e-8,
                                   atol=1e-10)


@pytest.mark.parametrize("entry", ["update_points", "update_points_group"])
def test_gather_float32_matches_jax_on_the_cycle_case(entry):
    """The cycle case (synop 300 records, vr 9000 with its cap binding) in
    float32 through both packages' gather and Newton-Schulz solve, at the
    5e-4 of tests/test_torch_update.py; and gather against dense, which
    keep different records only where the cap binds."""
    pts, xb_v, plats = cycle_case(nx=12, nz=3)
    tdev = [update.prepare_platform(*to_port(st, po), device="cpu")
            for st, po in plats]
    jdev = [jupdate.prepare_platform(st, po) for st, po in plats]
    ivars, inflats, rtpp, rtps = group_fields()[0]
    q, jq = torch.from_numpy(pts), jnp.asarray(pts)
    if entry == "update_points":
        kw = dict(inflat=inflats[0], weight_function=0, chunk=256)
        xa = update.update_points(torch.from_numpy(xb_v[:, 0]), q, tdev,
                                  ivars[0], method="gather", **kw)
        xa_j = jupdate.update_points(jnp.asarray(xb_v[:, 0]), jq, jdev,
                                     ivars[0], method="gather", **kw)
    else:
        kw = dict(inflats=inflats, weight_function=0, rtpp_alpha=rtpp,
                  rtps_alpha=rtps, chunk=256)
        xa = update.update_points_group(torch.from_numpy(xb_v[:, :2]), q,
                                        tdev, ivars, method="gather", **kw)
        xa_j = jupdate.update_points_group(jnp.asarray(xb_v[:, :2]), jq,
                                           jdev, ivars, method="gather", **kw)
    xa_j = np.asarray(xa_j)
    np.testing.assert_allclose(xa.numpy(), xa_j, rtol=0,
                               atol=5e-4 * np.abs(xa_j).max())
    xb = xb_v[:, 0] if entry == "update_points" else xb_v[:, :2]
    assert not np.array_equal(xa.numpy(), xb)


def test_plan_max_blocks_with_gather_platforms():
    """A gather platform gets no budget: planning takes only the bucketed
    ones, as in the JAX package."""
    pts, _, plats = cycle_case(nx=12, nz=3)
    tdev = [update.prepare_platform(*to_port(st, po), device="cpu")
            for st, po in plats]
    jdev = [jupdate.prepare_platform(st, po) for st, po in plats]
    q, jq = torch.from_numpy(pts), jnp.asarray(pts)
    for method in ("gather", "auto"):
        got = update.plan_max_blocks(q, tdev, 0, chunk=256, method=method)
        want = jupdate.plan_max_blocks(jq, jdev, 0, chunk=256, method=method)
        assert got == want
        assert set(got) == (set() if method == "gather" else {"vr"})
        if method == "gather":      # and builds no table
            assert not any(dp.cache for dp in tdev)
