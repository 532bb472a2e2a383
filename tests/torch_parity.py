"""Shared inputs for the PyTorch port's tests.

Every builder draws from a numpy ``Generator`` made from a seed and returns
float32 arrays: the test harness runs JAX with x64 on, and float64 inputs
would send JAX down its float64 / eigh paths.  Only the JAX-side helpers
import the JAX package, inside the function, so that the GPU tests can use
this module on a machine without jax.
"""
from __future__ import annotations

import dataclasses

import numpy as np

K_CYCLE = 12

#: production-shaped grouping as in tests/test_cycle.py, plus a group that no
#: platform feeds (ivar 7), which must keep its background exactly
GROUPS_SPEC = (
    ((0, 1), {"synop": (50.0, 3.0), "vr": (36.0, 3.0)}),
    ((2,),   {"synop": (50.0, 3.0), "vr": (12.0, 3.0)}),
    ((3, 4), {"synop": (50.0, 3.0), "vr": (24.0, 3.0)}),
    ((5,),   {"synop": (50.0, -1.0), "vr": (24.0, -1.0)}),  # 2-D group
    ((7,),   {}),
)


def normal_case(rng, b, k, n, scale=0.5):
    """``(a_obs [b,k,k], g [b,k])`` with ``a_obs = Y Y^T``, ``Y`` ``[b,k,n]``."""
    y = rng.standard_normal((b, k, n)).astype(np.float32) * scale
    a_obs = y @ np.transpose(y, (0, 2, 1))
    g = rng.standard_normal((b, k)).astype(np.float32)
    return a_obs, g


def ill_conditioned_case(rng, b, k, n=300):
    """Dense strong obs seeing one ensemble mode: kappa in the hundreds."""
    u = rng.standard_normal((b, k, 1)).astype(np.float32)
    w = rng.standard_normal((b, 1, n)).astype(np.float32)
    y = 5.0 * u * w + 0.1 * rng.standard_normal((b, k, n)).astype(np.float32)
    return y @ np.transpose(y, (0, 2, 1))


def zaz_residual(z, a_obs, inflat):
    """``max|Z A Z - I|`` in float64 with ``A = a_obs + inflat*I``."""
    z = np.asarray(z, np.float64)
    k = z.shape[-1]
    a = np.asarray(a_obs, np.float64) + inflat * np.eye(k)
    return float(np.abs(np.einsum("bij,bjk,bkl->bil", z, a, z) - np.eye(k)).max())


def kappa(a_obs, inflat):
    """Largest condition number of ``a_obs + inflat*I`` over the batch."""
    k = a_obs.shape[-1]
    lam = np.linalg.eigvalsh(np.asarray(a_obs, np.float64) + inflat * np.eye(k))
    return float((lam[:, -1] / lam[:, 0]).max())


def assert_ns_close(z, z_ref, a_obs, inflat, *, same_iteration=True):
    """The Newton-Schulz tolerances of tests/test_ns_solver.py.

    ``max|ZAZ - I|`` below ``max(5e-4, 20 kappa 1.2e-7)``, the float32 floor
    of the iteration (:115).  Z within ``2e-4 max|Z|`` of ``z_ref`` (:256-258)
    when both ran the same iteration; the CUDA kernel runs the same map in
    another form (it tracks ``W = ZY``, not ``Y``), so against the plain
    version its Z agrees only to the same float32 floor,
    ``max(2e-4, 20 kappa 1.2e-7) max|Z|``, which is 2e-4 below kappa ~ 83.
    """
    floor = 20 * kappa(a_obs, inflat) * 1.2e-7
    assert zaz_residual(z, a_obs, inflat) < max(5e-4, floor)
    z_rtol = 2e-4 if same_iteration else max(2e-4, floor)
    z_ref = np.asarray(z_ref, np.float64)
    np.testing.assert_allclose(np.asarray(z, np.float64), z_ref, rtol=0,
                               atol=z_rtol * np.abs(z_ref).max())


def to_port(static, obs):
    """The port's ``(PlatformStatic, PlatformObs)`` for a JAX-package pair."""
    from cwbnwp_letkf_torch.obs.base import from_reference

    return from_reference(dataclasses.asdict(static), obs._asdict())


def cycle_case(nobs_vr=9000, nx=24, nz=6):
    """tests/test_cycle.py::_case: synop 300 (dense) and vr (bucketed).

    Returns ``(pts, xb_v, [(static, obs)])`` from the JAX package's
    generators; ``xb_v`` ``[B, V, K]`` gives every variable its own field.
    """
    from cwbnwp_letkf_tpu.config import MAX_VARS
    from cwbnwp_letkf_tpu.obs.base import PlatformStatic
    from cwbnwp_letkf_tpu.obs.synthetic import (correlated_ensemble,
                                                idealized_grid,
                                                synthetic_gts_platform)

    rng = np.random.default_rng(3)
    pts = idealized_grid(nx, nx, nz, dx_m=50e3)
    truth, xb = correlated_ensemble(rng, pts, K_CYCLE, n_bumps=6,
                                    length_m=2e5)

    def radii(plat):
        h = [-1.0] * MAX_VARS
        v = [-1.0] * MAX_VARS
        for ivars, rmap in GROUPS_SPEC:
            if plat in rmap:
                for iv in ivars:
                    h[iv], v[iv] = rmap[plat]
        return tuple(h), tuple(v)

    plats = []
    for name, nobs, nvar, cap, err in (("synop", 300, 5, 40, 0.5),
                                       ("vr", nobs_vr, 1, 60, 1.0)):
        st0, po = synthetic_gts_platform(
            rng, pts, truth, xb, name=name, nobs=nobs, nvar=nvar,
            obs_err=err, max_lz_pts=cap, extent_frac=1.0)
        h, v = radii(name)
        st = PlatformStatic(
            name=name, kind=st0.kind, nvar=nvar, max_lz_pts=cap, hclr=h,
            vclr=v, err_muti=st0.err_muti, err_rej=st0.err_rej,
            is_assim=st0.is_assim)
        plats.append((st, po))
    v_tot = sum(len(ivars) for ivars, _ in GROUPS_SPEC)
    rng2 = np.random.default_rng(11)
    xb_v = np.stack([xb * (1.0 + 0.03 * vi) + 0.01 * rng2.standard_normal(
        xb.shape).astype(np.float32) for vi in range(v_tot)], axis=1)
    return pts, xb_v.astype(np.float32), plats


def group_fields():
    """Per group ``(ivars, inflats, rtpp_alpha, rtps_alpha)`` for GROUPS_SPEC."""
    out = []
    for ivars, _ in GROUPS_SPEC:
        nv = len(ivars)
        out.append((tuple(ivars),
                    tuple((K_CYCLE - 1) / (1.6 if iv < 3 else 1.1)
                          for iv in ivars),
                    (0.9,) * nv, (0.95,) * nv))
    return out
