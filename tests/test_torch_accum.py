"""The port's obs statistics, fused tables, cap and block keys against JAX.

Same float32 inputs into both packages.  Counts, masks and the space-filling
curve keys must match exactly: they decide which obs each point takes and the
order of points and records.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cwbnwp_letkf_tpu import localization as jloc
from cwbnwp_letkf_tpu.obs import synthetic as jsyn
from cwbnwp_letkf_tpu.ops import bucketed as jbucketed
from cwbnwp_letkf_tpu.ops import dense as jdense
from cwbnwp_letkf_tpu.ops import neighbors as jneighbors
from cwbnwp_letkf_tpu.ops import whiten as jwhiten
from cwbnwp_letkf_torch import localization
from cwbnwp_letkf_torch.obs import synthetic
from cwbnwp_letkf_torch.ops import bucketed, dense, neighbors, whiten

from .torch_parity import to_port


@pytest.fixture(autouse=True)
def _full_f32_accumulation():
    jdense.set_accum_precision("highest")
    yield
    jdense.set_accum_precision("high")


def _stats_inputs(rng, v, r, k, dbz=False):
    """Centered H(xb): the float32 mean of a large offset would differ between
    the packages by its summation order alone (see :func:`_stats_pair`)."""
    hdxb = rng.normal(0.0, 1.0, (v, r, k)).astype(np.float32)
    obs = (hdxb.mean(-1) + rng.normal(0.0, 2.0, (v, r))).astype(np.float32)
    error = rng.uniform(0.5, 2.0, (v, r)).astype(np.float32)
    qc = rng.integers(-1, 2, (v, r, k)).astype(np.float32)
    qc[:, :5] = -1                                   # QC-rejected records
    if dbz:
        hdxb[:, :40] = -5.0                          # no-rain, dropped
        obs[:, :60] = -5.0                           # no-rain obs
    return obs, hdxb, error, qc


@pytest.mark.parametrize("dbz", [False, True])
def test_platform_obs_stats_match_jax(dbz):
    rng = np.random.default_rng(1)
    v = 1 if dbz else 5
    args = _stats_inputs(rng, v, 500, 20, dbz=dbz)
    muti = tuple(np.linspace(0.8, 1.2, v))
    rej = tuple(np.linspace(2.0, 4.0, v))
    got = whiten.platform_obs_stats(*map(torch.from_numpy, args), muti, rej,
                                    is_dbz=dbz)
    want = jwhiten.platform_obs_stats(*map(jnp.asarray, args), muti, rej,
                                      is_dbz=dbz)
    for name in ("omm", "bg", "err"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert 0 < got.valid.sum() < got.valid.numel()


def _stats_pair(nobs=300, nvar=5, k=20, seed=2):
    """One synthetic platform's statistics, the same numbers in both packages.

    The background sits near 290 K, where the member mean loses about eight
    bits of the float32 deviations and its summation order shows at 1e-4;
    the table and term tests therefore start both packages from the JAX
    package's statistics.
    """
    rng = np.random.default_rng(seed)
    pts = jsyn.idealized_grid(12, 12, 4, dx_m=20e3)
    truth, xb = jsyn.correlated_ensemble(rng, pts, k, n_bumps=4)
    st, po = jsyn.synthetic_gts_platform(rng, pts, truth, xb, nobs=nobs,
                                         nvar=nvar, extent_frac=1.0)
    stats_j = jwhiten.platform_obs_stats(po.obs, po.hdxb, po.error, po.qc,
                                         st.err_muti, st.err_rej)
    stats_t = whiten.ObsStats(*(torch.tensor(np.asarray(x)) for x in stats_j))
    return stats_j, stats_t


@pytest.mark.parametrize("sliced", [False, True])
def test_fused_platform_table_matches_jax(monkeypatch, sliced):
    stats_j, stats_t = _stats_pair()
    if sliced:   # the row-sliced build, 300 records in slices of 64
        monkeypatch.setattr(dense, "_TABLE_ROW_SLICE", 64)
    mask = (True, False, True, True, False)
    order = np.random.default_rng(5).permutation(300)
    for kw_j, kw_t in (({}, {}),
                       (dict(order=jnp.asarray(order), pad_to=320),
                        dict(order=torch.from_numpy(order), pad_to=320))):
        f_j, nv_j = jdense.fused_platform_table(stats_j, mask, **kw_j)
        f_t, nv_t = dense.fused_platform_table(stats_t, mask, **kw_t)
        np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(f_j).max()))
        np.testing.assert_array_equal(nv_t.numpy(), np.asarray(nv_j))


@pytest.mark.parametrize("weight_function", [0, 1])
def test_cap_threshold_and_terms_match_jax(weight_function):
    """Many records within the radius, so the max_lz_pts cap binds."""
    stats_j, stats_t = _stats_pair(nobs=600, nvar=1)
    f_j, nv_j = jdense.fused_platform_table(stats_j, (True,))
    f_t, nv_t = dense.fused_platform_table(stats_t, (True,))
    rng = np.random.default_rng(8)
    r2 = (rng.random((96, 600)) * 20.0).astype(np.float32)
    row_mask = rng.random(600) > 0.1
    n_max = 60

    t_j = jdense._cap_threshold(jnp.asarray(r2), n_max, jdense.GC1999_SQ)
    t_t = dense._cap_threshold(torch.from_numpy(r2), n_max, dense.GC1999_SQ)
    # XLA fuses lo + frac * (hi - lo) into one rounding; over six rounds the
    # brackets drift a few ulps apart
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), rtol=1e-6, atol=0)

    a_j, g_j, c_j = jdense.terms_from_r2(
        jnp.asarray(r2), f_j, nv_j, n_max=n_max,
        weight_function=weight_function, row_mask=jnp.asarray(row_mask))
    a_t, g_t, c_t = dense.terms_from_r2(
        torch.from_numpy(r2), f_t, nv_t, n_max=n_max,
        weight_function=weight_function, row_mask=torch.from_numpy(row_mask))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    assert c_t.max() <= n_max and c_t.min() > 0
    for got, want in ((a_t, a_j), (g_t, g_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("fn", ["morton3", "hilbert3"])
def test_curve_keys_bit_exact(fn):
    rng = np.random.default_rng(3)
    xyz = (rng.normal(0.0, 1.0, (5000, 3)) * [4.0, 3.0, 0.2]).astype(np.float32)
    xyz[:100, 2] = 0.0
    got = getattr(bucketed, fn)(torch.from_numpy(xyz)).numpy()
    want = np.asarray(getattr(jbucketed, fn)(jnp.asarray(xyz)))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    np.testing.assert_array_equal(np.argsort(got, kind="stable"),
                                  np.asarray(jnp.argsort(jnp.asarray(want))))


def test_block_sizes_and_budgets_match_jax():
    rng = np.random.default_rng(4)
    for scale in (0.5, 3.0, 40.0):
        obs = (rng.normal(0.0, scale, (9000, 3)) * [1, 1, 0.1]).astype(np.float32)
        assert (bucketed.auto_block_size(torch.from_numpy(obs))
                == jbucketed.auto_block_size(jnp.asarray(obs)))
    q = rng.normal(0.0, 2.0, (6, 128, 3)).astype(np.float32)
    centers = rng.normal(0.0, 10.0, (200, 3)).astype(np.float32)
    radii = rng.uniform(0.1, 1.0, 200).astype(np.float32)
    got = bucketed.required_max_blocks(*map(torch.from_numpy, (q, centers, radii)))
    want = int(jbucketed.required_max_blocks(*map(jnp.asarray, (q, centers, radii))))
    assert got == want and 0 < got < 200
    for nb in (1, 100, 129, 1000):
        assert bucketed.default_max_blocks(nb) == jbucketed.default_max_blocks(nb)


def test_normalize_coords_and_localization_match_jax():
    rng = np.random.default_rng(6)
    xyz = rng.normal(0.0, 5e4, (300, 3)).astype(np.float32)
    for h, v in ((36.0, 3.0), (24.0, -1.0)):
        np.testing.assert_array_equal(
            neighbors.normalize_coords(torch.from_numpy(xyz), h, v).numpy(),
            np.asarray(jneighbors.normalize_coords(jnp.asarray(xyz), h, v)))
    r2 = (rng.random(1000) * 16.0).astype(np.float32)
    err = rng.uniform(0.5, 2.0, 1000).astype(np.float32)
    x = np.sqrt(r2)
    # GC's outer polynomial cancels to ~1e-6 absolute near its support end
    np.testing.assert_allclose(
        localization.gaspari_cohn_1999(torch.from_numpy(x)).numpy(),
        np.asarray(jloc.gaspari_cohn_1999(jnp.asarray(x))), rtol=1e-6,
        atol=1e-6)
    # ... and sqrt(GC) / err turns that into 1e-3 / err near zero
    for wf, atol in ((0, 1e-7), (1, 2e-3)):
        np.testing.assert_allclose(
            localization.obs_error_inv_weight(
                torch.from_numpy(r2), torch.from_numpy(err), wf).numpy(),
            np.asarray(jloc.obs_error_inv_weight(jnp.asarray(r2),
                                                 jnp.asarray(err), wf)),
            rtol=1e-6, atol=atol)
    d = rng.normal(0.0, 1e4, (3, 200)).astype(np.float32)
    hv = (np.float32(1 / 36e3), np.float32(1 / 3e3))
    np.testing.assert_allclose(
        localization.normalized_r2(*map(torch.from_numpy, d), *hv).numpy(),
        np.asarray(jloc.normalized_r2(*map(jnp.asarray, d), *hv)), rtol=1e-6)


def test_synthetic_case_identical_to_jax():
    """The port's generators give the JAX package's arrays from one seed."""
    pts = synthetic.idealized_grid(10, 8, 3, dx_m=20e3)
    np.testing.assert_array_equal(pts, jsyn.idealized_grid(10, 8, 3, dx_m=20e3))
    out = []
    for mod in (synthetic, jsyn):
        rng = np.random.default_rng(12)
        truth, xb = mod.correlated_ensemble(rng, pts, 6, n_bumps=3)
        st, po = mod.synthetic_gts_platform(rng, pts, truth, xb, nobs=40,
                                            nvar=2, extent_frac=1.0)
        out.append((truth, xb, st, po))
    (t0, x0, s0, p0), (t1, x1, s1, p1) = out
    np.testing.assert_array_equal(t0, t1)
    np.testing.assert_array_equal(x0, x1)
    s_conv, p_conv = to_port(s1, p1)
    assert s0 == s_conv
    for name in p0._fields:
        np.testing.assert_array_equal(getattr(p0, name), getattr(p_conv, name))
