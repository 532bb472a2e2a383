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
import pytest

from cwbnwp_letkf_torch.constants import GC1999_SQ

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


def cycle_case(nobs_vr=9000, nx=24, nz=6, k=K_CYCLE, dx_m=50e3):
    """tests/test_cycle.py::_case: synop 300 (dense) and vr (bucketed).

    Returns ``(pts, xb_v, [(static, obs)])`` from the JAX package's
    generators, with ``k`` members and grid spacing ``dx_m``; ``xb_v``
    ``[B, V, k]`` gives every variable its own field.
    """
    from cwbnwp_letkf_tpu.config import MAX_VARS
    from cwbnwp_letkf_tpu.obs.base import PlatformStatic
    from cwbnwp_letkf_tpu.obs.synthetic import (correlated_ensemble,
                                                idealized_grid,
                                                synthetic_gts_platform)

    rng = np.random.default_rng(3)
    pts = idealized_grid(nx, nx, nz, dx_m=dx_m)
    truth, xb = correlated_ensemble(rng, pts, k, n_bumps=6, length_m=2e5)

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


def group_fields(k=K_CYCLE):
    """Per group ``(ivars, inflats, rtpp_alpha, rtps_alpha)`` for GROUPS_SPEC."""
    out = []
    for ivars, _ in GROUPS_SPEC:
        nv = len(ivars)
        out.append((tuple(ivars),
                    tuple((k - 1) / (1.6 if iv < 3 else 1.1) for iv in ivars),
                    (0.9,) * nv, (0.95,) * nv))
    return out


def cap_case(rng, b, r, inside, masked=0.0):
    """``(r2 [b, r], mask [r] or None)``: squared distances from ``b``
    points near the middle of a cube to ``r`` records spread over it, about
    ``inside`` of them within the cap's radius (``GC1999_SQ``) of a point
    (the cap binds where ``inside`` exceeds ``max_lz_pts``); 5% of the
    records repeat others, so that distances tie; ``masked`` of the records
    are False in the mask (no mask at 0)."""
    radius = float(np.sqrt(GC1999_SQ))
    side = radius * (4.0 / 3.0 * np.pi * r / inside) ** (1.0 / 3.0)
    obs = (rng.random((r, 3)) * side).astype(np.float32)
    n_dup = r // 20
    obs[rng.choice(r, n_dup, replace=False)] = obs[rng.choice(r, n_dup)]
    pts = (side / 2 + (rng.random((b, 3)) - 0.5) * radius).astype(np.float32)
    r2 = np.square(pts[:, None, :] - obs[None]).sum(-1, dtype=np.float32)
    mask = rng.random(r) >= masked if masked else None
    return r2, mask


def select_stats(rng, v, r, k, valid=0.8):
    """``ObsStats`` of ``r`` records with ``v`` observed variables and ``k``
    members for K6's checks: normal perturbations and departures, errors in
    [0.5, 2), a share ``valid`` of the observations accepted."""
    import torch

    from cwbnwp_letkf_torch.ops.whiten import ObsStats

    return ObsStats(
        omm=torch.from_numpy(rng.standard_normal((v, r)).astype(np.float32)),
        bg=torch.from_numpy(rng.standard_normal((v, r, k)).astype(np.float32)),
        err=torch.from_numpy((0.5 + 1.5 * rng.random((v, r))).astype(np.float32)),
        valid=torch.from_numpy(rng.random((v, r)) < valid))


def select_tolerance(r2, sel, factors, nvalid, weight_function):
    """The float32 bound between two sums of K6's terms in any order:
    ``2 (n + 3)`` roundings (n the most terms a point adds) of the sum of
    the terms' magnitudes, ``[C, k, k+1]`` float64 on ``r2``'s device."""
    import torch

    from cwbnwp_letkf_torch.localization import (WEIGHT_GC1999,
                                                 gaspari_cohn_1999)

    bgo, e = (x.double() for x in factors)
    k = bgo.shape[-1] - 1
    took = sel & (nvalid > 0)[None]
    w = (gaspari_cohn_1999(torch.sqrt(r2)) if weight_function == WEIGHT_GC1999
         else torch.exp(-0.5 * r2))
    w = torch.where(took, w, 0.0).double().abs()
    u = (e[..., None] * bgo[..., :k]).abs()
    per_record = torch.einsum("rvk,rvl->rkl", u, bgo.abs())
    scale = (w @ per_record.reshape(per_record.shape[0], -1)).view(-1, k, k + 1)
    rows = int(took.sum(1).max()) * bgo.shape[1] if took.numel() else 0
    return 2 * (rows + 3) * 2.0 ** -24 * scale


def cap_tie_rows(r, n_max):
    """``[m, r]`` float32 rows that stress the cap search's edges at the cap
    ``GC1999_SQ``: the first round's candidates themselves, one value
    throughout, every record at +inf, NaN, zeros and denormals, one spacing
    either side of a value, the cap itself, and exactly ``n_max`` and
    ``n_max + 1`` records inside."""
    f = np.float32
    lo, hi = f(-1.0), f(GC1999_SQ)
    cands = np.array([lo + f(i / 16) * (hi - lo) for i in range(1, 16)], f)
    mid = hi / f(2)
    near = np.array([np.nextafter(mid, f(0)), mid, np.nextafter(mid, hi)], f)
    patterns = [
        cands, np.array([1.0], f), np.array([np.inf], f),
        np.array([np.nan, 1.0, np.nan, 3.0], f),
        np.array([0.0, 1e-40, 1e-45, 0.0], f), near,
        np.array([hi, np.nextafter(hi, f(0)), np.nextafter(hi, f(np.inf))], f),
        np.concatenate([cands, near, [hi, f(0)]]).astype(f),
    ]
    rows = [np.resize(p, r) for p in patterns]
    rng = np.random.default_rng(r)
    for inside in (n_max, n_max + 1):
        row = np.full(r, np.inf, f)
        row[rng.choice(r, min(inside, r), replace=False)] = \
            rng.random(min(inside, r)).astype(f) * hi
        rows.append(row)
    return np.stack(rows)


def spd_case(rng, b, k, cond=10.0):
    """tests/test_pallas_eigh.py::_spd: ``A A^T + cond I``, float32."""
    a = rng.normal(size=(b, k, k)).astype(np.float32)
    return a @ a.transpose(0, 2, 1) + cond * np.eye(k, dtype=np.float32)


def assert_eigh_close(lam, v, a, lam_ref=None):
    """The Jacobi tolerances of tests/test_pallas_eigh.py:28-35.

    Reconstruction ``max|V diag(lam) V^T - A| < 3e-5 max|A|``, orthogonality
    ``max|V^T V - I| < 1e-5``, sorted ``lam`` against float64 ``eigvalsh`` at
    rtol 1e-4 (atol ``3e-5 max|A|``), and, given ``lam_ref`` in the same
    order, ``lam`` against it element by element at the same tolerance.
    """
    lam, v, a = (np.asarray(x, np.float64) for x in (lam, v, a))
    k = a.shape[-1]
    scale = np.abs(a).max()
    rec = np.einsum("bik,bk,bjk->bij", v, lam, v)
    assert np.abs(rec - a).max() < 3e-5 * scale
    assert np.abs(np.einsum("bik,bjk->bij", v, v) - np.eye(k)).max() < 1e-5
    np.testing.assert_allclose(np.sort(lam, -1), np.linalg.eigvalsh(a),
                               rtol=1e-4, atol=3e-5 * scale)
    if lam_ref is not None:
        np.testing.assert_allclose(lam, np.asarray(lam_ref, np.float64),
                                   rtol=1e-4, atol=3e-5 * scale)


def assert_k96_sweep_level(jacobi_eigh, device):
    """The known accuracy of seven sweeps at k=96, held in place.

    On ``G G^T + 10 I`` at k=96 (``spd_case``, 33 matrices) seven sweeps
    and the polish leave a reconstruction error of 4.0e-5 max|A|, the TPU
    kernel's algorithm as it stands, above the 3e-5 of
    tests/test_pallas_eigh.py; six leave 4.6e-4 and eight 1.1e-6.  Seven
    sweeps must stay below 5e-5, so one sweep fewer fails, and eight must
    meet 3e-5.
    """
    import torch

    a_np = spd_case(np.random.default_rng(296), 33, 96)
    a = torch.from_numpy(a_np).to(device)
    scale = float(np.abs(a_np).max())
    for sweeps, tol in ((7, 5e-5), (8, 3e-5)):
        lam, v = jacobi_eigh(a, sweeps=sweeps)
        lam, v = lam.cpu().double(), v.cpu().double()
        rec = float(((v * lam[:, None, :]) @ v.transpose(1, 2)
                     - torch.from_numpy(a_np).double()).abs().max())
        orth = float((v.transpose(1, 2) @ v
                      - torch.eye(96, dtype=torch.float64)).abs().max())
        assert rec < tol * scale, (sweeps, rec / scale)
        assert orth < 1e-5, (sweeps, orth)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for a module's small cases: the test workers
    share the cores, and many threads spinning over small operations slow
    every worker down."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
