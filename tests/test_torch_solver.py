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
from cwbnwp_letkf_torch.ops import eigh_kernel, ns_kernel
from cwbnwp_letkf_torch.ops import solver

from .torch_parity import (assert_ns_close, ill_conditioned_case,
                           normal_case, zaz_residual)


@pytest.fixture(autouse=True)
def _ns_backend():
    jsolver.set_eigh_backend("ns")
    yield
    jsolver.set_eigh_backend("auto")
    solver.set_eigh_backend("auto")
    solver.set_ns_impl("auto")


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


def test_ns_invsqrt_rmul_matches_pallas_kernel():
    """The plain rmul version against the TPU's rmul kernel, interpreted,
    with the tolerances of tests/test_ns_solver.py:325-331; and against the
    plain trio version, which runs the same map."""
    from cwbnwp_letkf_tpu.ops.pallas_ns import ns_invsqrt_pallas

    k = 40
    a_obs, _ = normal_case(np.random.default_rng(12), 8, k, 2 * k)
    inflat = (k - 1) / 1.1
    z_p = np.asarray(ns_invsqrt_pallas(jnp.asarray(a_obs), inflat,
                                       packing="rmul", interpret=True),
                     np.float64)
    z, iters, err = solver.ns_invsqrt_rmul(torch.from_numpy(a_obs), inflat,
                                           return_info=True)
    assert float(err) <= 1e-4 and 1 <= iters <= 24
    z = z.numpy().astype(np.float64)
    for zz in (z_p, z):
        assert zaz_residual(zz, a_obs, inflat) < 5e-4
    np.testing.assert_allclose(z, z_p, rtol=0, atol=1e-4 * np.abs(z_p).max())
    z_trio = solver.ns_invsqrt(torch.from_numpy(a_obs), inflat)
    assert_ns_close(z, z_trio.numpy(), a_obs, inflat)


def test_ns_z_takes_plain_version_on_cpu():
    a_obs, _ = normal_case(np.random.default_rng(6), 9, 24, 48)
    before = dict(ns_kernel.LAUNCHES)
    z, resid = solver._ns_z(torch.from_numpy(a_obs), 23 / 1.6)
    assert ns_kernel.LAUNCHES == before
    z_plain, _, err = solver.ns_invsqrt(torch.from_numpy(a_obs), 23 / 1.6,
                                        return_info=True)
    assert torch.equal(z, z_plain) and float(resid) == float(err)


@pytest.mark.parametrize("bad", [
    torch.zeros(4, 40, 40),                          # on the CPU
    torch.zeros(4, 40, 40, dtype=torch.float64),
    torch.zeros(4, ns_kernel.MAX_K + 1, ns_kernel.MAX_K + 1),
    torch.zeros(40, 40),
    torch.zeros(4, 40, 80)[:, :, :40],
    torch.zeros(0, 40, 40),
])
def test_kernel_wrapper_rejects_what_it_does_not_take(bad):
    before = dict(ns_kernel.LAUNCHES)
    with pytest.raises(ValueError):
        ns_kernel.ns_invsqrt_cuda(bad, 1.0)
    with pytest.raises(ValueError):
        ns_kernel.ns_invsqrt_cuda(bad, 1.0, packing="rmul")
    assert ns_kernel.LAUNCHES == before


def test_kernel_wrapper_rejects_unknown_packing():
    with pytest.raises(ValueError):
        ns_kernel.launch(torch.zeros(4, 8, 8), 1.0, packing="blkdiag")


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


def _solve_case(rng, k, sizes, n_vars):
    """Per group: normal terms, a ``[B, V, k]`` background and a has-obs mask
    with rows left out (tests/test_pallas_eigh.py:55-61)."""
    out = []
    for gi, b in enumerate(sizes):
        a, g = normal_case(rng, b, k, 20 + 6 * gi)
        xb = rng.normal(5, 2, (b, n_vars[gi], k)).astype(np.float32)
        out.append((a, g, xb, rng.random(b) > 0.25))
    return out


@pytest.mark.parametrize("backend", ["xla", "jacobi"])
@pytest.mark.parametrize("entry", ["from_normal", "group", "cycle"])
def test_eigh_solves_match_jax(entry, backend):
    """The eigendecomposing solves on both sides, within the Jacobi-vs-XLA
    tolerance of tests/test_pallas_eigh.py:72; rows without obs keep the
    background bit for bit.  The per-variable case runs at an odd k (the
    sequential Jacobi kernel), the group and cycle cases at an even one."""
    rng = np.random.default_rng(73)
    k = 9 if entry == "from_normal" else 10
    inflats_gs = (((k - 1) / 1.6, (k - 1) / 1.1), ((k - 1) / 1.1,))
    rtpp_gs = ((0.9, 0.0), (0.0,))
    rtps_gs = ((0.0, 0.95), (0.9,))
    groups = _solve_case(rng, k, (24, 17), (2, 1))
    solver.set_eigh_backend(backend)
    jsolver.set_eigh_backend(backend)
    before = dict(ns_kernel.LAUNCHES)
    if entry == "from_normal":
        a, g, xb, has = groups[0]
        xb = xb[:, 0]
        kw = dict(use_rtpp=True, rtpp_alpha=0.9, use_rtps=True, rtps_alpha=0.9,
                  return_diagnostics=True)
        outs, diag = solver.letkf_solve_from_normal(
            torch.from_numpy(a), torch.from_numpy(g), torch.from_numpy(xb),
            inflats_gs[0][0], torch.from_numpy(has), **kw)
        outs_j, _ = jsolver.letkf_solve_from_normal(
            jnp.asarray(a), jnp.asarray(g), jnp.asarray(xb), inflats_gs[0][0],
            jnp.asarray(has), **kw)
        pairs = [(outs, outs_j, xb, has)]
    elif entry == "group":
        a, g, xb, has = groups[0]
        outs, diag = solver.letkf_solve_group_from_normal(
            torch.from_numpy(a), torch.from_numpy(g), torch.from_numpy(xb),
            inflats_gs[0], torch.from_numpy(has), rtpp_alpha=rtpp_gs[0],
            rtps_alpha=rtps_gs[0], return_diagnostics=True)
        outs_j = jsolver.letkf_solve_group_from_normal(
            jnp.asarray(a), jnp.asarray(g), jnp.asarray(xb), inflats_gs[0],
            jnp.asarray(has), rtpp_alpha=rtpp_gs[0], rtps_alpha=rtps_gs[0])
        pairs = [(outs, outs_j, xb, has)]
    else:
        tgs = [[torch.from_numpy(x) for x in grp] for grp in groups]
        outs, diag = solver.letkf_solve_cycle_from_normal(
            *zip(*[grp[:3] for grp in tgs]), inflats_gs, [grp[3] for grp in tgs],
            rtpp_alpha_groups=rtpp_gs, rtps_alpha_groups=rtps_gs,
            return_diagnostics=True)
        outs_j = jsolver.letkf_solve_cycle_from_normal(
            *zip(*[[jnp.asarray(x) for x in grp[:3]] for grp in groups]),
            inflats_gs, [jnp.asarray(grp[3]) for grp in groups],
            rtpp_alpha_groups=rtpp_gs, rtps_alpha_groups=rtps_gs)
        pairs = [(o, oj, grp[2], grp[3])
                 for o, oj, grp in zip(outs, outs_j, groups)]
    assert ns_kernel.LAUNCHES == before
    assert float(diag["ns_residual"]) == 0.0
    for got, want, xb, has in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_array_equal(got.numpy()[~has], xb[~has])


def test_float64_solve_eigendecomposes_under_auto():
    """"auto" takes Newton-Schulz for float32 only: a float64 solve goes to
    eigh and matches the JAX package's float64 solve closely."""
    rng = np.random.default_rng(74)
    k = 8
    (a, g, xb, has), = _solve_case(rng, k, (20,), (3,))
    a64, g64, xb64 = (x.astype(np.float64) for x in (a, g, xb))
    inflats = ((k - 1) / 1.6,) * 2 + ((k - 1) / 1.1,)
    kw = dict(rtpp_alpha=(0.9, 0.0, 0.5), rtps_alpha=(0.0, 0.9, 0.5),
              solver_dtype=torch.float64)
    before = dict(ns_kernel.LAUNCHES)
    xa = solver.letkf_solve_group_from_normal(
        torch.from_numpy(a64), torch.from_numpy(g64), torch.from_numpy(xb64),
        inflats, torch.from_numpy(has), **kw)
    assert ns_kernel.LAUNCHES == before and xa.dtype == torch.float64
    jsolver.set_eigh_backend("xla")
    kw["solver_dtype"] = jnp.float64
    xa_j = jsolver.letkf_solve_group_from_normal(
        jnp.asarray(a64), jnp.asarray(g64), jnp.asarray(xb64), inflats,
        jnp.asarray(has), **kw)
    np.testing.assert_allclose(xa.numpy(), np.asarray(xa_j), rtol=1e-10,
                               atol=1e-10)


def test_letkf_solve_batch_matches_jax():
    """From whitened obs: the weight factors and the solve, both backends."""
    rng = np.random.default_rng(75)
    b, k, n = 16, 7, 11
    yb = rng.normal(size=(b, k, n)).astype(np.float32)
    yo = rng.normal(size=(b, n)).astype(np.float32)
    xb = rng.normal(3, 1, (b, k)).astype(np.float32)
    has = np.arange(b) % 5 != 0
    for backend in ("xla", "jacobi"):
        solver.set_eigh_backend(backend)
        jsolver.set_eigh_backend(backend)
        xa = solver.letkf_solve_batch(
            torch.from_numpy(xb), torch.from_numpy(yo), torch.from_numpy(yb),
            (k - 1) / 1.2, torch.from_numpy(has), use_rtps=True,
            rtps_alpha=0.8)
        xa_j = jsolver.letkf_solve_batch(
            jnp.asarray(xb), jnp.asarray(yo), jnp.asarray(yb), (k - 1) / 1.2,
            jnp.asarray(has), use_rtps=True, rtps_alpha=0.8)
        np.testing.assert_allclose(xa.numpy(), np.asarray(xa_j), rtol=2e-4,
                                   atol=2e-4, err_msg=backend)
        np.testing.assert_array_equal(xa.numpy()[~has], xb[~has])


def test_set_eigh_backend_validates():
    with pytest.raises(ValueError):
        solver.set_eigh_backend("magma")


@pytest.mark.parametrize("device,k,backend,dtype,ns,eigh", [
    ("cpu", 96, "auto", torch.float32, "plain", "library"),
    ("cpu", 178, "auto", torch.float32, "plain", "library"),
    ("cpu", 177, "jacobi", torch.float32, "plain", "plain"),
    ("cpu", 178, "jacobi", torch.float32, "plain", "library"),
    ("cuda", 96, "auto", torch.float32, "kernel", "kernel"),
    ("cuda", 128, "auto", torch.float32, "kernel", "kernel"),
    ("cuda", 129, "auto", torch.float32, "matmul", "kernel"),
    ("cuda", 177, "jacobi", torch.float32, "matmul", "kernel"),
    ("cuda", 178, "jacobi", torch.float32, "matmul", "library"),
    ("cuda", 192, "auto", torch.float32, "matmul", "library"),
    ("cuda", 129, "xla", torch.float32, "matmul", "library"),
    ("cuda", 97, "auto", torch.float64, "kernel", "library"),
])
def test_check_ensemble_size(device, k, backend, dtype, ns, eigh):
    """No ensemble size is refused any more: on a card a float32 solve takes
    K1 up to ``ns_kernel.MAX_K`` = 128 and the ``torch.matmul`` iteration
    above, and the eigen paths K3/K4 up to ``eigh_kernel.MAX_K`` = 177 and
    ``torch.linalg.eigh`` above (the JAX package's VMEM guard); the CPU,
    float64 and "xla" keep their branches.  The routes are named from the
    size alone, so the CUDA cases run without a card."""
    solver.set_eigh_backend(backend)
    assert solver.ns_route(k, device) == ns
    assert solver.eigh_route(k, torch.device(device), dtype) == eigh


def _refined_case():
    """tests/test_ns_solver.py:118-141: k=24, 32 matrices of 120 obs."""
    k = 24
    rng = np.random.default_rng(4)
    y = rng.standard_normal((32, k, 120)).astype(np.float32) * 0.4
    return y @ np.transpose(y, (0, 2, 1)), (k - 1) / 1.1


def test_ns_invsqrt_refined_beats_float32():
    """The checks of tests/test_ns_solver.py:118-141 on the port: one
    float64 Newton step takes Z twentyfold closer to float64 eigh, below
    1e-7 relative, symmetric; and within 2e-8 of JAX's refined Z (the two
    float32 stages differ by float32 roundings, which the step leaves at
    2.8e-9 of max|Z|: measured)."""
    a, inflat = _refined_case()
    k = a.shape[-1]
    before = dict(ns_kernel.LAUNCHES)
    z64, resid = solver.ns_invsqrt_refined(torch.from_numpy(a), inflat)
    assert ns_kernel.LAUNCHES == before          # the plain version on the CPU
    assert z64.dtype == torch.float64 and float(resid) <= 1e-4
    z32 = solver.ns_invsqrt(torch.from_numpy(a), inflat).numpy()
    af = a.astype(np.float64) + inflat * np.eye(k)
    lam, v = np.linalg.eigh(af)
    zo = (v / np.sqrt(lam)[:, None, :]) @ np.transpose(v, (0, 2, 1))
    err32 = np.abs(z32.astype(np.float64) - zo).max() / np.abs(zo).max()
    err64 = np.abs(z64.numpy() - zo).max() / np.abs(zo).max()
    assert err64 < err32 / 20, (err64, err32)
    assert err64 < 1e-7
    np.testing.assert_array_equal(z64.numpy(), z64.transpose(1, 2).numpy())
    zj, _ = jsolver.ns_invsqrt_refined(jnp.asarray(a), inflat)
    zj = np.asarray(zj)
    np.testing.assert_allclose(z64.numpy(), zj, rtol=0,
                               atol=2e-8 * np.abs(zj).max())


def test_letkf_solve_group_refined_matches_float64():
    """tests/test_ns_solver.py:144-163 on the port: the refined group solve
    within 1e-6 of the analysis scale of the port's float64 solve, and
    within 2e-8 of it of JAX's refined solve (measured 4.0e-9); points
    without obs keep their background."""
    k = 16
    rng = np.random.default_rng(5)
    nb = 64
    y = rng.standard_normal((nb, k, 60)).astype(np.float32) * 0.4
    a = (y @ np.transpose(y, (0, 2, 1))).astype(np.float64)
    g = rng.standard_normal((nb, k))
    xb = rng.standard_normal((nb, 2, k))
    has = np.arange(nb) % 9 != 0
    kw = dict(inflats=((k - 1) / 1.1, (k - 1) / 1.6),
              rtpp_alpha=(0.9, 0.0), rtps_alpha=(0.0, 0.9))
    xa_r, diag = solver.letkf_solve_group_refined(
        torch.from_numpy(a), torch.from_numpy(g), torch.from_numpy(xb),
        has_obs=torch.from_numpy(has), return_diagnostics=True, **kw)
    xa_o = solver.letkf_solve_group_from_normal(
        torch.from_numpy(a), torch.from_numpy(g), torch.from_numpy(xb),
        kw["inflats"], torch.from_numpy(has), rtpp_alpha=kw["rtpp_alpha"],
        rtps_alpha=kw["rtps_alpha"], solver_dtype=torch.float64)
    assert xa_r.dtype == torch.float64 and float(diag["ns_residual"]) <= 1e-4
    sc = float(np.abs(xa_o.numpy()).max())
    np.testing.assert_allclose(xa_r.numpy(), xa_o.numpy(), rtol=0,
                               atol=1e-6 * sc)
    np.testing.assert_array_equal(xa_r.numpy()[~has], xb[~has])
    xa_j = np.asarray(jsolver.letkf_solve_group_refined(
        jnp.asarray(a), jnp.asarray(g), jnp.asarray(xb),
        has_obs=jnp.asarray(has), **kw))
    np.testing.assert_allclose(xa_r.numpy(), xa_j, rtol=0, atol=2e-8 * sc)
    # float32 normal terms and background: float32 out, the same solve
    xa_32 = solver.letkf_solve_group_refined(
        torch.from_numpy(a.astype(np.float32)), torch.from_numpy(g),
        torch.from_numpy(xb.astype(np.float32)),
        has_obs=torch.from_numpy(has), **kw)
    assert xa_32.dtype == torch.float32
    np.testing.assert_allclose(xa_32.numpy(), xa_o.numpy(), rtol=0,
                               atol=1e-6 * sc)


@pytest.mark.parametrize("name", ["auto", "pallas", "xla"])
def test_set_ns_impl_names(name):
    """The JAX package's names: on the CPU each takes the plain iteration;
    on a card "auto" and "pallas" take K1 up to 128 members and the
    ``torch.matmul`` iteration from 129, and "xla" raises at every k."""
    a, g = normal_case(np.random.default_rng(76), 6, 9, 20)
    want = solver._ns_z(torch.from_numpy(a), 4.0)
    solver.set_ns_impl(name)
    z, resid = solver._ns_z(torch.from_numpy(a), 4.0)
    assert torch.equal(z, want[0]) and float(resid) <= 1e-4
    if name == "xla":
        for k in (ns_kernel.MAX_K, ns_kernel.MAX_K + 1):
            with pytest.raises(ValueError, match="CPU only"):
                solver.ns_route(k, "cuda")
    else:
        assert solver.ns_route(ns_kernel.MAX_K, "cuda") == "kernel"
        assert solver.ns_route(ns_kernel.MAX_K + 1, "cuda") == "matmul"


def test_set_ns_impl_refuses_unknown():
    with pytest.raises(ValueError, match="unknown ns impl 'mosaic'"):
        solver.set_ns_impl("mosaic")
    with pytest.raises(ValueError, match="unknown ns impl 'mosaic'"):
        jsolver.set_ns_impl("mosaic")


@pytest.mark.parametrize("k", [12, 13])
def test_auto_eigen_factors_on_cpu_are_linalg_eigh(k):
    """Under "auto" the CPU's eigen factors are ``torch.linalg.eigh``'s, as
    the JAX package keeps LAPACK on the CPU; no kernel is launched."""
    rng = np.random.default_rng(77)
    a, g = normal_case(rng, 10, k, 2 * k)
    inflat = (k - 1) / 1.3
    before = (dict(ns_kernel.LAUNCHES), dict(eigh_kernel.LAUNCHES))
    lam, v, g2 = solver.letkf_weight_factors_from_normal(
        torch.from_numpy(a), torch.from_numpy(g), inflat)
    assert (dict(ns_kernel.LAUNCHES), dict(eigh_kernel.LAUNCHES)) == before
    lam_e, v_e = torch.linalg.eigh(torch.from_numpy(a)
                                   + inflat * torch.eye(k))
    assert torch.equal(lam, lam_e) and torch.equal(v, v_e)
    assert torch.equal(g2, torch.from_numpy(g))
