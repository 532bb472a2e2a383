"""The port's Newton-Schulz solve against the JAX package, on the CPU.

Same float32 inputs into both packages; JAX forced onto its Newton-Schulz
backend (on the CPU it would otherwise eigendecompose).  Tolerances are the
JAX package's own for the same quantities (tests/test_ns_solver.py,
tests/test_cycle.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cwbnwp_letkf_tpu.ops import solver as jsolver
from cwbnwp_letkf_torch.ops import ns_kernel
from cwbnwp_letkf_torch.ops import solver

from .torch_parity import (assert_ns_close, ill_conditioned_case,
                           normal_case, zaz_residual)


@pytest.fixture(autouse=True)
def _ns_backend():
    jsolver.set_eigh_backend("ns")
    yield
    jsolver.set_eigh_backend("auto")


@pytest.mark.parametrize("k", [8, 21, 40, 96])
def test_ns_invsqrt_matches_jax(k):
    rng = np.random.default_rng(k)
    a_obs, _ = normal_case(rng, 12, k, 2 * k)
    inflat = (k - 1) / 1.1
    z, iters, err = solver.ns_invsqrt(torch.from_numpy(a_obs), inflat,
                                      return_info=True)
    z_j, iters_j, _ = jsolver.ns_invsqrt(jnp.asarray(a_obs), inflat,
                                         return_info=True)
    assert iters == int(iters_j)
    assert float(err) <= 1e-4
    assert_ns_close(z.numpy(), np.asarray(z_j), a_obs, inflat)


def test_ns_invsqrt_ill_conditioned_matches_jax():
    """tests/test_ns_solver.py:98-115: 300 strong obs, kappa in the hundreds."""
    k = 40
    a_obs = ill_conditioned_case(np.random.default_rng(4), 64, k)
    inflat = (k - 1) / 1.1
    z = solver.ns_invsqrt(torch.from_numpy(a_obs), inflat)
    z_j = jsolver.ns_invsqrt(jnp.asarray(a_obs), inflat)
    assert_ns_close(z.numpy(), np.asarray(z_j), a_obs, inflat)


@pytest.mark.parametrize("k", [40, 64])
def test_ns_invsqrt_matches_pallas_kernel(k):
    """The plain version against the TPU kernel itself, run interpreted."""
    from cwbnwp_letkf_tpu.ops.pallas_ns import ns_invsqrt_pallas

    a_obs, _ = normal_case(np.random.default_rng(10), 10, k, 2 * k)
    inflat = (k - 1) / 1.1
    z_p = ns_invsqrt_pallas(jnp.asarray(a_obs), inflat, interpret=True)
    z = solver.ns_invsqrt(torch.from_numpy(a_obs), inflat)
    assert zaz_residual(np.asarray(z_p), a_obs, inflat) < 5e-4
    assert_ns_close(z.numpy(), np.asarray(z_p), a_obs, inflat)


def test_ns_z_takes_plain_version_on_cpu():
    a_obs, _ = normal_case(np.random.default_rng(6), 9, 24, 48)
    before = ns_kernel.LAUNCHES
    z, resid = solver._ns_z(torch.from_numpy(a_obs), 23 / 1.6)
    assert ns_kernel.LAUNCHES == before
    z_plain, _, err = solver.ns_invsqrt(torch.from_numpy(a_obs), 23 / 1.6,
                                        return_info=True)
    assert torch.equal(z, z_plain) and float(resid) == float(err)


@pytest.mark.parametrize("bad", [
    torch.zeros(4, 40, 40),                          # on the CPU
    torch.zeros(4, 40, 40, dtype=torch.float64),
    torch.zeros(4, 97, 97),
    torch.zeros(40, 40),
    torch.zeros(4, 40, 80)[:, :, :40],
    torch.zeros(0, 40, 40),
])
def test_kernel_wrapper_rejects_what_it_does_not_take(bad):
    before = ns_kernel.LAUNCHES
    with pytest.raises(ValueError):
        ns_kernel.ns_invsqrt_cuda(bad, 1.0)
    assert ns_kernel.LAUNCHES == before


def test_cycle_solve_mixed_inflations_matches_jax():
    """Stacked solves: mixed inflation values within and across groups,
    RTPP/RTPS on, and points without obs (tests/test_ns_solver.py:165-204)."""
    rng = np.random.default_rng(7)
    k = 16
    inflats_gs = (((k - 1) / 1.6, (k - 1) / 1.6),
                  ((k - 1) / 1.1,),
                  ((k - 1) / 1.1, (k - 1) / 1.6, (k - 1) / 1.3))
    rtpp_gs = ((0.95, 0.0), (0.9,), (0.0, 0.95, 0.5))
    rtps_gs = ((0.0, 0.95), (0.95,), (0.95, 0.0, 0.5))
    a_gs, g_gs, xb_gs, has_gs = [], [], [], []
    for gi, inflats in enumerate(inflats_gs):
        b = 40 + 16 * gi
        a, g = normal_case(rng, b, k, 30 + 10 * gi)
        a_gs.append(a)
        g_gs.append(g)
        xb_gs.append(rng.standard_normal((b, len(inflats), k)).astype(np.float32))
        has_gs.append(rng.random(b) > 0.25)

    outs, diag = solver.letkf_solve_cycle_from_normal(
        [torch.from_numpy(x) for x in a_gs], [torch.from_numpy(x) for x in g_gs],
        [torch.from_numpy(x) for x in xb_gs],
        inflats_gs, [torch.from_numpy(x) for x in has_gs],
        rtpp_alpha_groups=rtpp_gs, rtps_alpha_groups=rtps_gs,
        return_diagnostics=True)
    outs_j, diag_j = jsolver.letkf_solve_cycle_from_normal(
        [jnp.asarray(x) for x in a_gs], [jnp.asarray(x) for x in g_gs],
        [jnp.asarray(x) for x in xb_gs], inflats_gs,
        [jnp.asarray(x) for x in has_gs],
        rtpp_alpha_groups=rtpp_gs, rtps_alpha_groups=rtps_gs,
        return_diagnostics=True)
    assert float(diag["ns_residual"]) <= 1e-4
    assert float(diag_j["ns_residual"]) <= 1e-4
    for gi in range(len(inflats_gs)):
        expect = np.asarray(outs_j[gi])
        np.testing.assert_allclose(outs[gi].numpy(), expect, rtol=0,
                                   atol=5e-4 * np.abs(expect).max(),
                                   err_msg=f"group {gi}")
        np.testing.assert_array_equal(outs[gi].numpy()[~has_gs[gi]],
                                      xb_gs[gi][~has_gs[gi]])


def test_tune_q_matches_jax():
    rng = np.random.default_rng(9)
    q = rng.normal(1e-3, 2e-3, size=(257, 40)).astype(np.float32)
    q[:5] = -np.abs(q[:5])            # points with no positive member
    expect = np.asarray(jsolver.tune_q(jnp.asarray(q)))
    got = solver.tune_q(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, expect, rtol=1e-6, atol=0)
    assert not got[:5].any()
