"""Large ensembles: the port against the JAX package at k = 128 to 192, on
the CPU.

The port's kernels take k <= 128 (K1/K2) and k <= 177 (K3/K4, the JAX
package's Pallas reach); above them a card takes the JAX package's own
library branches, the batched ``torch.matmul`` Newton-Schulz iteration and
``torch.linalg.eigh``.  Here the port runs its plain versions, and the JAX
package runs as its own tests run it: XLA, or its Pallas kernels in
interpret mode.  The dispatch on a card is checked with the card's routes
(``solver.ns_route``, ``solver.eigh_route``) asked for ``"cuda"`` and
stand-ins for the two kernel wrappers.

Tolerances: analyses within ``XA_RTOL`` of the reference's increment
``max|xa_ref - xb|`` (tests/test_torch_cycle.py); ``Z`` by
``assert_ns_close`` (tests/test_ns_solver.py); eigenpairs, whose order
differs between the two packages, by the order-invariant ``V f(lam) V^T``
(f the identity and ``lam^(-1/2)``) within ``EIGH_RTOL`` of its largest
entry and by the sorted eigenvalues at tests/test_pallas_eigh.py:28-35's
tolerances.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cwbnwp_letkf_tpu import config as jconfig
from cwbnwp_letkf_tpu import driver as jdriver
from cwbnwp_letkf_tpu.models import state as jstate
from cwbnwp_letkf_tpu.obs import base as jbase
from cwbnwp_letkf_tpu.ops import dense as jdense
from cwbnwp_letkf_tpu.ops import solver as jsolver
from cwbnwp_letkf_tpu.ops.pallas_eigh import jacobi_eigh as jacobi_eigh_pallas
from cwbnwp_letkf_torch import cli, config, driver, synthetic_case
from cwbnwp_letkf_torch.models import state
from cwbnwp_letkf_torch.obs import base
from cwbnwp_letkf_torch.obs.synthetic import correlated_ensemble, idealized_grid
from cwbnwp_letkf_torch.ops import cycle, eigh_kernel, ns_kernel, solver, update
from cwbnwp_letkf_torch.ops.jacobi_eigh import jacobi_eigh
from cwbnwp_letkf_torch.projection import LambertProjection

from .test_driver import NML
from .test_torch_cli import _assert_outputs_close, _jax_cli, _run
from .torch_parity import (assert_ns_close, cycle_case, group_fields,  # noqa: F401
                           normal_case, one_torch_thread, to_port)
from .wrf_fixtures import make_wrf_ensemble

XA_RTOL = 5e-4
#: tests/test_pallas_eigh.py's reconstruction tolerance, in units of the
#: largest entry; the two packages' V f(lam) V^T measured 1e-6 to 1.3e-5
#: apart at k = 128 and 176, and the port's k = 177 2e-6 from jnp's eigh
EIGH_RTOL = 3e-5
#: float32 spacings of a field's largest value: the floor below which two
#: summation orders of a 128-member float32 mean differ (twice the 4
#: measured on P in test_run_analysis_fused_matches_jax_at_k128)
F32_SPACINGS = 8
#: the ensemble sizes of the dispatch table: K1's last, the matmul
#: branch's first, K3/K4's last, torch.linalg.eigh's first, and 192
ROWS = (128, 129, 177, 178, 192)


@pytest.fixture(autouse=True)
def _backends():
    jsolver.set_eigh_backend("ns")
    jdense.set_accum_precision("highest")
    yield
    jsolver.set_eigh_backend("auto")
    jdense.set_accum_precision("high")
    solver.set_eigh_backend("auto")
    solver.set_ns_impl("auto")


def correlated_normal_case(rng, b, k, n_obs=None):
    """``(a_obs [b,k,k], g [b,k])`` of correlated members: each matrix sees
    ``n_obs`` (2k) random points of a 32x32 grid at 4 km through the
    members of ``obs.synthetic.correlated_ensemble``, obs error 1."""
    n_obs = n_obs or 2 * k
    pts = idealized_grid(32, 32, 1, dx_m=4e3)
    truth, xb = correlated_ensemble(rng, pts, k, n_bumps=12, length_m=2e4)
    a = np.empty((b, k, k), np.float32)
    g = np.empty((b, k), np.float32)
    for i in range(b):
        idx = rng.choice(pts.shape[0], n_obs, replace=False)
        y = xb[idx] - xb[idx].mean(1, keepdims=True)
        d = truth[idx] + rng.normal(0.0, 1.0, n_obs) - xb[idx].mean(1)
        a[i] = y.T @ y
        g[i] = y.T @ d
    return a, g


def assert_eigh_invariants_close(lam, v, lam_ref, v_ref, a):
    """``V f(lam) V^T`` within ``EIGH_RTOL`` of the reference's largest
    entry (f the identity and ``lam^(-1/2)``), and the sorted eigenvalues
    at rtol 1e-4, atol ``3e-5 max|A|`` (tests/test_pallas_eigh.py:28-35)."""
    lam, v, lam_ref, v_ref, a = (np.asarray(x, np.float64)
                                 for x in (lam, v, lam_ref, v_ref, a))
    for f in (lambda x: x, lambda x: x ** -0.5):
        got = np.einsum("bik,bk,bjk->bij", v, f(lam), v)
        want = np.einsum("bik,bk,bjk->bij", v_ref, f(lam_ref), v_ref)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=EIGH_RTOL * np.abs(want).max())
    np.testing.assert_allclose(np.sort(lam, -1), np.sort(lam_ref, -1),
                               rtol=1e-4, atol=3e-5 * np.abs(a).max())


# ---- K1's path --------------------------------------------------------------

def test_ns_invsqrt_matches_jax_at_k128():
    """The plain iteration (K1's plain version, and the card's matmul
    branch) against JAX's XLA ``ns_invsqrt`` at k = 128, the largest k K1
    takes, on normal matrices of correlated members."""
    k = ns_kernel.MAX_K
    a, _ = correlated_normal_case(np.random.default_rng(128), 8, k)
    inflat = (k - 1) / 1.1
    z, iters, err = solver.ns_invsqrt(torch.from_numpy(a), inflat,
                                      return_info=True)
    zj, iters_j, err_j = jsolver.ns_invsqrt(jnp.asarray(a), inflat,
                                            return_info=True)
    assert float(err) <= 1e-4 and float(err_j) <= 1e-4
    assert iters == int(iters_j)
    assert_ns_close(z.numpy(), np.asarray(zj), a, inflat)


@pytest.mark.parametrize("k", [128, 192])
def test_cycle_solve_matches_jax(k):
    """``letkf_solve_cycle_from_normal``, two groups stacked by inflation
    (1.6 and 1.1, RTPP and RTPS on, points without obs), at K1's last k and
    at 192, the matmul branch's on a card, against JAX's stacked solve."""
    rng = np.random.default_rng(k)
    inflats_gs = (((k - 1) / 1.6, (k - 1) / 1.1), ((k - 1) / 1.1,))
    rtpp_gs, rtps_gs = ((0.9, 0.0), (0.95,)), ((0.0, 0.9), (0.95,))
    a_gs, g_gs, xb_gs, has_gs = [], [], [], []
    pts = idealized_grid(8, 8, 1, dx_m=4e3)
    _, xb = correlated_ensemble(rng, pts, k, n_bumps=12, length_m=2e4)
    for gi, inflats in enumerate(inflats_gs):
        a, g = correlated_normal_case(rng, 24, k)
        a_gs.append(a)
        g_gs.append(g)
        rows = rng.choice(pts.shape[0], 24, replace=False)
        xb_gs.append(np.stack([xb[rows] * (1.0 + 0.02 * vi)
                               for vi in range(len(inflats))], 1)
                     .astype(np.float32))
        has_gs.append(rng.random(24) > 0.2)
    outs, diag = solver.letkf_solve_cycle_from_normal(
        [torch.from_numpy(x) for x in a_gs], [torch.from_numpy(x) for x in g_gs],
        [torch.from_numpy(x) for x in xb_gs], inflats_gs,
        [torch.from_numpy(x) for x in has_gs], rtpp_alpha_groups=rtpp_gs,
        rtps_alpha_groups=rtps_gs, return_diagnostics=True)
    outs_j = jsolver.letkf_solve_cycle_from_normal(
        [jnp.asarray(x) for x in a_gs], [jnp.asarray(x) for x in g_gs],
        [jnp.asarray(x) for x in xb_gs], inflats_gs,
        [jnp.asarray(x) for x in has_gs], rtpp_alpha_groups=rtpp_gs,
        rtps_alpha_groups=rtps_gs)
    assert float(diag["ns_residual"]) <= 1e-4
    for xa, xa_j, xb_g, has in zip(outs, outs_j, xb_gs, has_gs):
        xa_j = np.asarray(xa_j)
        incr = np.abs(xa_j - xb_g).max()
        assert incr > 0
        np.testing.assert_allclose(xa.numpy(), xa_j, rtol=0,
                                   atol=XA_RTOL * incr)
        np.testing.assert_array_equal(xa.numpy()[~has], xb_g[~has])


# ---- K3's and K4's plain versions -------------------------------------------

@pytest.mark.parametrize("b,k", [(2, 128), (1, 176)])
def test_jacobi_parallel_matches_pallas(b, k):
    """K3's plain version against the TPU kernel in interpret mode at even k
    above 96, the solver's ``A = a_obs + inflat I``."""
    a, _ = normal_case(np.random.default_rng(k), b, k, 2 * k)
    a = a + (k - 1) / 1.6 * np.eye(k, dtype=np.float32)
    assert eigh_kernel.kernel_for(k) == "parallel"
    lam_p, v_p = jacobi_eigh_pallas(jnp.asarray(a), interpret=True)
    lam, v = jacobi_eigh(torch.from_numpy(a))
    assert_eigh_invariants_close(lam.numpy(), v.numpy(), np.asarray(lam_p),
                                 np.asarray(v_p), a)


def test_jacobi_cyclic_same_rotations_as_pallas_at_k97():
    """K4's plain version against the TPU kernel in interpret mode at
    k = 97, the smallest odd k above 96.  Seven float32 sweeps take 31.7 s
    of the interpreter here, over this test's 30 s; three sweeps in float64
    take 19.7 s and apply the same rotations in the same order, so the
    unpolished eigenpairs agree element by element: measured 1.5e-11 of
    max|lam| and 1.2e-9 in V."""
    k = 97
    a, _ = normal_case(np.random.default_rng(k), 1, k, 2 * k)
    a = (a + (k - 1) / 1.6 * np.eye(k, dtype=np.float32)).astype(np.float64)
    assert eigh_kernel.kernel_for(k) == "cyclic"
    lam_p, v_p = jacobi_eigh_pallas(jnp.asarray(a), sweeps=3, interpret=True,
                                    polish=False)
    lam, v = jacobi_eigh(torch.from_numpy(a), sweeps=3, polish=False)
    lam_p = np.asarray(lam_p)
    np.testing.assert_allclose(lam.numpy(), lam_p, rtol=0,
                               atol=1e-9 * np.abs(lam_p).max())
    np.testing.assert_allclose(v.numpy(), np.asarray(v_p), rtol=0, atol=1e-8)


def test_jacobi_cyclic_k177_matches_eigh():
    """K4's plain version at k = 177, the largest k the kernels take,
    against JAX's ``jnp.linalg.eigh`` (the interpreted kernel takes more
    than 100 s here)."""
    k = eigh_kernel.MAX_K
    a, _ = normal_case(np.random.default_rng(k), 1, k, 2 * k)
    a = a + (k - 1) / 1.6 * np.eye(k, dtype=np.float32)
    assert eigh_kernel.kernel_for(k) == "cyclic"
    lam_j, v_j = jnp.linalg.eigh(jnp.asarray(a))
    lam, v = jacobi_eigh(torch.from_numpy(a))
    assert_eigh_invariants_close(lam.numpy(), v.numpy(), np.asarray(lam_j),
                                 np.asarray(v_j), a)


# ---- the dispatch on a card -------------------------------------------------

def _card(monkeypatch, k1=None, jacobi=None):
    """The card's routes on the CPU: ``solver.ns_route`` and
    ``solver.eigh_route`` asked for ``"cuda"``, K1's wrapper replaced by
    ``k1`` (default: the plain version) and the Jacobi path by ``jacobi``
    (default: ``torch.linalg.eigh``).  Returns ``{"k1": [k, ...],
    "jacobi": [k, ...]}``, the ensemble sizes each stand-in was given."""
    ns_route, eigh_route = solver.ns_route, solver.eigh_route
    calls = {"k1": [], "jacobi": []}

    def k1_plain(a_obs, inflat, **kwargs):
        calls["k1"].append(a_obs.shape[-1])
        z, iters, err = solver.ns_invsqrt(a_obs, inflat, return_info=True)
        return z, torch.tensor(iters), err

    def jacobi_library(a):
        calls["jacobi"].append(a.shape[-1])
        return torch.linalg.eigh(a)

    monkeypatch.setattr(solver, "ns_route",
                        lambda k, device: ns_route(k, "cuda"))
    monkeypatch.setattr(solver, "eigh_route",
                        lambda k, device, dtype=torch.float32:
                        eigh_route(k, "cuda", dtype))
    monkeypatch.setattr(ns_kernel, "ns_invsqrt_cuda", k1 or k1_plain)
    monkeypatch.setattr(solver, "jacobi_eigh", jacobi or jacobi_library)
    return calls


def _entry(entry, k):
    """Run ``entry`` on a 32-point case with ``k`` members (synop, and 300
    vr records on the dense path); returns the analysis."""
    pts, xb_v, plats = cycle_case(nobs_vr=300, nx=4, nz=2, k=k)
    tplats = [update.prepare_platform(*to_port(st, po), device="cpu")
              for st, po in plats]
    q, xb = torch.from_numpy(pts), torch.from_numpy(xb_v)
    if entry == "cycle":
        groups = [cycle.CycleGroup(*f) for f in group_fields(k)]
        return cycle.update_points_cycle(xb, q, tplats, groups,
                                         weight_function=0)
    if entry == "update_points":
        return update.update_points(xb[:, 3], q, tplats, 3,
                                    inflat=(k - 1) / 1.1, weight_function=0)
    if entry == "update_points_group":
        return update.update_points_group(
            xb[:, :2], q, tplats, [0, 1], inflats=[(k - 1) / 1.6] * 2,
            weight_function=0, rtpp_alpha=[0.9] * 2, rtps_alpha=[0.0] * 2)
    a, g = correlated_normal_case(np.random.default_rng(k), 6, k)
    lam, _, _ = solver.letkf_weight_factors_from_normal(
        torch.from_numpy(a), torch.from_numpy(g), (k - 1) / 1.6)
    return lam


@pytest.mark.parametrize("k", ROWS)
@pytest.mark.parametrize("backend", ["auto", "jacobi"])
@pytest.mark.parametrize("entry", ["cycle", "update_points",
                                   "update_points_group", "eigen_factors"])
def test_dispatch_on_a_card(monkeypatch, entry, backend, k):
    """Every row of the card's table, for the cycle, the per-variable and
    group updates and the eigen factors: under "auto" the solves take K1
    up to 128 and the matmul iteration above; the eigen factors, and every
    solve under "jacobi", take K3/K4 up to 177 and ``torch.linalg.eigh``
    above.  No other branch runs."""
    solver.set_eigh_backend(backend)
    calls = _card(monkeypatch)
    before = dict(solver.LIBRARY_SOLVES)
    out = _entry(entry, k)
    assert bool(torch.isfinite(out).all())
    ran = {"k1": len(calls["k1"]), "jacobi": len(calls["jacobi"]),
           **{n: solver.LIBRARY_SOLVES[n] - before[n] for n in before}}
    ns = backend == "auto" and entry != "eigen_factors"
    if ns:
        branch = "k1" if k <= ns_kernel.MAX_K else "ns_matmul"
    else:
        branch = "jacobi" if k <= eigh_kernel.MAX_K else "linalg_eigh"
    assert ran[branch] > 0, ran
    assert all(n == 0 for name, n in ran.items() if name != branch), ran
    assert set(calls["k1"]) | set(calls["jacobi"]) <= {k}


@pytest.mark.parametrize("entry,k", [("cycle", 128), ("update_points", 177)])
def test_kernel_failure_raises_without_fallback(monkeypatch, entry, k):
    """The branch is named from k before any launch: a K1 that fails at
    k = 128 (the cycle under "auto") or a K3/K4 that fails at k = 177 (the
    per-variable update under "jacobi") raises to the caller, and neither
    library branch runs in its place."""

    class Failed(Exception):
        pass

    def fail(*args, **kwargs):
        raise Failed

    solver.set_eigh_backend("auto" if entry == "cycle" else "jacobi")
    _card(monkeypatch, k1=fail, jacobi=fail)
    before = dict(solver.LIBRARY_SOLVES)
    with pytest.raises(Failed):
        _entry(entry, k)
    assert solver.LIBRARY_SOLVES == before


# ---- the slice --------------------------------------------------------------

def test_run_analysis_fused_matches_jax_at_k128(tmp_path):
    """``run_analysis(fuse_variables=True)`` with 128 WSM5 members
    (tests/test_driver.py's 8x7x5 fixture and namelist) and 25 synop records,
    port against JAX, every analysed field within ``XA_RTOL`` of JAX's
    increment and every other field equal.  Below that lies the float32
    floor of a field on a large base: the member mean of P (about 1e5 Pa)
    over 128 float32 members differs between the two packages' summation
    orders by 4 float32 spacings (measured; the perturbations by 2), above
    ``XA_RTOL`` of P's 11.6 Pa increment, so P's limit is ``F32_SPACINGS``
    spacings of the field where that is the larger (T, QVAPOR and W stay on
    the increment rule: measured 6e-5, 1.1e-5 and 1.2e-5 of it)."""
    k = 128
    paths = make_wrf_ensemble(str(tmp_path), k, seed=7)
    cfg = config.LetkfConfig.from_namelist(NML.format(k=k))
    jcfg = jconfig.LetkfConfig.from_namelist(NML.format(k=k))
    assert cfg.nmember == k
    proj = LambertProjection.from_config(cfg.projection)
    rng = np.random.default_rng(11)
    nobs = 25
    x, y = proj.lonlat_to_xy(rng.uniform(119.85, 120.15, nobs),
                             rng.uniform(23.55, 23.85, nobs))
    xyz = np.stack([x, y, rng.uniform(0.0, 5e3, nobs)], 1)
    obs = rng.normal(0.0, 2.0, (5, nobs))
    hdxb = obs[:, :, None] + rng.normal(0.0, 1.0, (5, nobs, k))
    po = base.make_platform_obs(xyz, obs, hdxb, rng.uniform(0.5, 1.5, (5, nobs)))
    ens = state.read_ensemble(paths, cfg)
    driver.run_analysis(cfg, ens, {"synop": po}, chunk=128,
                        fuse_variables=True, device="cpu")
    jens = jstate.read_ensemble(paths, jcfg)
    jdriver.run_analysis(jcfg, jens, {"synop": jbase.PlatformObs(**po._asdict())},
                         chunk=128, fuse_variables=True)
    prior = jstate.read_ensemble(paths, jcfg)
    for key in ("t", "p", "qv", "w"):
        want, xb = jens.fields[key], prior.fields[key]
        incr = np.abs(want - xb).max()
        assert incr > 0, key
        floor = F32_SPACINGS * np.spacing(np.abs(want).max())
        np.testing.assert_allclose(ens.fields[key], want, rtol=0,
                                   atol=max(XA_RTOL * incr, floor),
                                   err_msg=key)
    for key in ("u", "v", "ph", "mu"):
        assert np.array_equal(ens.fields[key], jens.fields[key]), key


def test_cli_matches_jax_at_nmember_128(tmp_path):
    """The command at ``nmember = 128``: ``generate_case``'s synthetic case
    with 128 members, the port's CLI on the CPU against JAX's, every output
    file within tests/test_torch_cli.py's tolerance."""
    kw = dict(k=128, nx=16, ny=14, nz=4, n_obs=30, seed=5)
    synthetic_case.generate_case(str(tmp_path / "in"), **kw)
    _run(cli.main, tmp_path / "in", tmp_path / "out", "--chunk", "256")
    _run(_jax_cli, tmp_path / "in", tmp_path / "jout", "--chunk", "256")
    _assert_outputs_close(tmp_path / "out", tmp_path / "jout",
                          tmp_path / "in", kw["k"], ("T", "QVAPOR"))
