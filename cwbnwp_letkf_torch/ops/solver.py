"""Batched ensemble-space LETKF solve.

Port of the JAX package's ``ops/solver.py``.  With ``A = a_obs + inflat*I``
(``a_obs = Yb' Yb'^T`` and ``g = Yb' yo'`` accumulated per point), the
analysis of a variable with that inflation value is

    xa = mean(xb) + g^T A^-1 xb' + sqrt(k-1) A^(-1/2) xb'   (xb' = deviations)

followed by RTPP / RTPS relaxation; points without obs keep the background.
Two ways to the inverse factors, chosen by :func:`set_eigh_backend`:

- Newton-Schulz: ``Z = A^(-1/2)``, then ``u = Z xb'``, ``s = (Z g) . u``;
  the hand-written CUDA kernel (:mod:`.ns_kernel`) for tensors on a card up
  to ``ns_kernel.MAX_K`` members, above it the batched ``torch.matmul``
  iteration (the JAX package's XLA branch), and its plain version
  :func:`ns_invsqrt` for tensors on the CPU.  Float32 only.
- an eigendecomposition ``A = V diag(lam) V^T``: ``torch.linalg.eigh``
  (``"xla"``, every float64 solve, the CPU's eigen factors and every k
  above ``eigh_kernel.MAX_K``) or the Jacobi eigensolvers (``"jacobi"``,
  and the card's eigen factors under ``"auto"``; :mod:`.jacobi_eigh`).

:func:`ns_route` and :func:`eigh_route` name the branch a solve takes, from
k, the device, the dtype and the backend alone, before any launch.  A
kernel that fails raises; no branch stands in for another.

Every solve takes ``solver_dtype`` float32 or float64;
:func:`letkf_solve_group_refined` takes the float32 ``Z`` to float64 by one
Newton step.
"""
from __future__ import annotations

import torch

from .. import tracing
from . import eigh_kernel, ns_kernel
from .jacobi_eigh import jacobi_eigh


def ns_invsqrt(a_obs: torch.Tensor, inflat: float, *, tol: float = 1e-4,
               max_iters: int = 24, return_info: bool = False):
    """Batched ``Z ~= (a_obs + inflat*I)^(-1/2)`` by coupled Newton-Schulz.

    The plain version of the CUDA kernel.  Higham's coupled iteration
    (Functions of Matrices, alg. 6.21) on ``Y_0 = A/c``, ``Z_0 = I``::

        T = (3I - Z Y) / 2,   Y <- Y T,   Z <- T Z

    with ``c`` the per-matrix Gershgorin row-sum bound divided by 1.9, so the
    spectrum of ``A/c`` lies in (0, 1.9] and the iteration contracts from
    step 0.  The loop stops when the batch-wide ``max|ZY - I|``, taken before
    a step, is at most ``tol``, or after ``max_iters`` steps.

    Returns ``z`` ``[B, k, k]``; with ``return_info`` ``(z, iters, err)``:
    the steps run and the last ``max|ZY - I|`` (a 0-d tensor).
    """
    k = a_obs.shape[-1]
    eye = torch.eye(k, dtype=a_obs.dtype, device=a_obs.device)
    a = a_obs + inflat * eye
    c = a.abs().sum(-1).amax(-1) / 1.9
    c = c.clamp_min(torch.finfo(a.dtype).tiny)
    y = a / c[:, None, None]
    z = eye.expand_as(a).clone()
    err = torch.tensor(float("inf"), dtype=a.dtype, device=a.device)
    iters = 0
    while float(err) > tol and iters < max_iters:
        w = z @ y
        t = 0.5 * (3.0 * eye - w)
        err = (w - eye).abs().max()
        y, z = y @ t, t @ z
        iters += 1
    z = z / torch.sqrt(c)[:, None, None]
    if return_info:
        return z, iters, err
    return z


def ns_invsqrt_rmul(a_obs: torch.Tensor, inflat: float, *, tol: float = 1e-4,
                    max_iters: int = 24, return_info: bool = False):
    """Batched ``Z ~= (a_obs + inflat*I)^(-1/2)`` by right multiplication.

    The plain version of the CUDA kernel's ``packing="rmul"`` variant (the
    TPU kernel ``_ns_kernel_rmul``).  The W-form of the coupled iteration on
    ``W_0 = A/c``, ``Z_0 = I``, with ``c`` the Gershgorin bound over 1.9 as
    in :func:`ns_invsqrt`::

        T = (3I - W) / 2,   U = W T,   Z <- Z T,   W <- U T

    Every iterate is a polynomial in ``A``, so ``W``, ``Z`` and ``T``
    commute and this is the map of :func:`ns_invsqrt`.  The same stopping
    rule: the batch-wide ``max|W - I|`` before a step at most ``tol``, or
    ``max_iters`` steps.  Returns ``z`` or ``(z, iters, err)``.
    """
    k = a_obs.shape[-1]
    eye = torch.eye(k, dtype=a_obs.dtype, device=a_obs.device)
    a = a_obs + inflat * eye
    c = a.abs().sum(-1).amax(-1) / 1.9
    c = c.clamp_min(torch.finfo(a.dtype).tiny)
    w = a / c[:, None, None]
    z = eye.expand_as(a).clone()
    err = torch.tensor(float("inf"), dtype=a.dtype, device=a.device)
    iters = 0
    while float(err) > tol and iters < max_iters:
        err = (w - eye).abs().max()
        t = 1.5 * eye - 0.5 * w
        u = w @ t
        z = z @ t
        w = u @ t
        iters += 1
    z = z / torch.sqrt(c)[:, None, None]
    if return_info:
        return z, iters, err
    return z


_EIGH_BACKEND = "auto"

#: the backends :func:`set_eigh_backend` takes
EIGH_BACKENDS = ("auto", "xla", "jacobi", "ns")


def set_eigh_backend(name: str):
    """Select the ensemble-space factorization of every later solve.

    - ``"auto"`` (default): Newton-Schulz for float32 ``[B, k, k]`` solves,
      on every device (on a card K1 up to ``ns_kernel.MAX_K`` = 128
      members and the batched ``torch.matmul`` iteration above, as
      :func:`ns_route` says); ``torch.linalg.eigh`` otherwise.  The eigen
      factors (:func:`letkf_weight_factors`,
      :func:`letkf_weight_factors_from_normal`) of a float32 batch take the
      Jacobi kernels on a card up to ``eigh_kernel.MAX_K`` = 177 and
      ``torch.linalg.eigh`` on the CPU and above 177, as the JAX package
      takes its Pallas Jacobi off the CPU within its VMEM budget and LAPACK
      or XLA eigh otherwise.  (The JAX package's ``"auto"`` solves by
      eigendecomposition on the CPU; here the CPU runs the card's
      Newton-Schulz path on the plain versions.)
    - ``"ns"``: another name for ``"auto"``, kept so that call sites written
      for the JAX package (where the two differ on the CPU) run unchanged.
    - ``"xla"``: ``torch.linalg.eigh``, the counterpart of the JAX package's
      XLA eigh.
    - ``"jacobi"``: the Jacobi eigensolvers for float32 batches up to
      ``eigh_kernel.MAX_K`` members (on a card the CUDA kernels K3/K4, on
      the CPU their plain versions); ``torch.linalg.eigh`` above it, as the
      JAX package's VMEM guard takes XLA eigh (JAX solver.py:78-92), and
      for float64.
    """
    global _EIGH_BACKEND
    if name not in EIGH_BACKENDS:
        raise ValueError(f"unknown eigh backend {name!r}")
    _EIGH_BACKEND = name


#: solves a branch other than this package's kernels took since import (or
#: since a caller reset them): ``"ns_matmul"``, the batched ``torch.matmul``
#: Newton-Schulz iteration on a card (:func:`ns_route` ``"matmul"``), and
#: ``"linalg_eigh"``, every ``torch.linalg.eigh`` of the eigen paths
#: (:func:`eigh_route` ``"library"``)
LIBRARY_SOLVES = {"ns_matmul": 0, "linalg_eigh": 0}


def eigh_route(k: int, device, dtype=torch.float32) -> str:
    """The branch an eigendecomposition of a ``[B, k, k]`` batch takes, from
    ``k``, the device, the dtype and the backend alone:

    - ``"kernel"``: K3/K4 (:mod:`.eigh_kernel`) on a card, for float32 under
      ``"jacobi"``, ``"auto"`` or ``"ns"``, k <= ``eigh_kernel.MAX_K``;
    - ``"plain"``: their plain versions on the CPU, for float32 under
      ``"jacobi"``, k <= ``eigh_kernel.MAX_K``;
    - ``"library"``: ``torch.linalg.eigh`` for everything else: ``"xla"``,
      float64, the CPU under ``"auto"``, and every k above
      ``eigh_kernel.MAX_K``, where the JAX package's VMEM guard takes XLA
      eigh (JAX solver.py:78-92).
    """
    kind = torch.device(device).type
    if (dtype != torch.float32 or _EIGH_BACKEND == "xla"
            or k > eigh_kernel.MAX_K):
        return "library"
    if kind == "cuda":
        return "kernel"
    if kind == "cpu" and _EIGH_BACKEND == "jacobi":
        return "plain"
    return "library"


def _use_ns(a_obs: torch.Tensor) -> bool:
    """Whether the Newton-Schulz inverse-sqrt path handles this solve."""
    return (_EIGH_BACKEND in ("auto", "ns") and a_obs.dtype == torch.float32
            and a_obs.ndim == 3)


_NS_IMPL = "auto"

#: the names :func:`set_ns_impl` takes, the JAX package's
NS_IMPLS = ("auto", "pallas", "xla")


def set_ns_impl(name: str):
    """Select the Newton-Schulz implementation by the JAX package's names.

    - ``"auto"`` (default) and ``"pallas"``: the CUDA kernel (K1) for
      tensors on a card up to ``ns_kernel.MAX_K`` members and the batched
      ``torch.matmul`` iteration above (:func:`ns_route`), the plain
      version :func:`ns_invsqrt` for tensors on the CPU;
    - ``"xla"``: the plain iteration, which the port runs on the CPU only:
      a Newton-Schulz solve of tensors on a card raises under it.

    A kernel that fails raises; no other implementation stands in for it.
    """
    global _NS_IMPL
    if name not in NS_IMPLS:
        raise ValueError(f"unknown ns impl {name!r}")
    _NS_IMPL = name


def ns_route(k: int, device) -> str:
    """The branch a float32 Newton-Schulz solve of a ``[B, k, k]`` batch
    takes, from ``k`` and the device alone:

    - ``"kernel"``: K1 (:mod:`.ns_kernel`) on a card, k <= ``ns_kernel.MAX_K``;
    - ``"matmul"``: on a card above ``ns_kernel.MAX_K``, :func:`ns_invsqrt`
      as batched ``torch.matmul`` (TF32 off, :mod:`..device`): the
      counterpart of the JAX package's XLA branch of ``_ns_z`` (JAX
      solver.py:153-154), which it takes for every k its Pallas kernel does
      not support (every k > 64).  This is the one place where a card runs
      the iteration that is also K1's plain version, and only because it is
      the JAX package's own path at that k;
    - ``"plain"``: :func:`ns_invsqrt` on the CPU.

    Under ``set_ns_impl("xla")`` a card raises ``ValueError``, as does a
    device that is neither.
    """
    kind = torch.device(device).type
    if kind == "cuda":
        if _NS_IMPL == "xla":
            raise ValueError(
                "set_ns_impl('xla') selects the plain Newton-Schulz "
                "iteration, which the port runs on the CPU only; use "
                "'auto' or 'pallas' for tensors on a card")
        return "kernel" if k <= ns_kernel.MAX_K else "matmul"
    if kind == "cpu":
        return "plain"
    raise ValueError(f"no Newton-Schulz solve for tensors on {device}")


@tracing.labelled("solver.ns")
def _ns_z(a_obs: torch.Tensor, inflat: float):
    """``(z, residual)`` by the branch :func:`ns_route` names: K1, the
    ``torch.matmul`` iteration (counted in ``LIBRARY_SOLVES``), or the plain
    version on the CPU."""
    route = ns_route(a_obs.shape[-1], a_obs.device)
    if route == "kernel":
        z, _, resid = ns_kernel.ns_invsqrt_cuda(a_obs.contiguous(), float(inflat))
        return z, resid
    if route == "matmul":
        LIBRARY_SOLVES["ns_matmul"] += 1
    z, _, resid = ns_invsqrt(a_obs, float(inflat), return_info=True)
    return z, resid


def ns_invsqrt_refined(a_obs: torch.Tensor, inflat: float):
    """``(z64, residual)``: the float32 Newton-Schulz ``Z`` (:func:`_ns_z`:
    the CUDA kernel on a card up to ``ns_kernel.MAX_K``, the ``torch.matmul``
    iteration above) refined in float64 by one Newton step.

    With ``X_0`` the float32 ``Z`` and ``A = a_obs + inflat*I`` in float64::

        X' = 1.5 X - 0.5 X (A X^2)

    One step squares the part of the float32 stage's error that commutes
    with ``A`` (on the k=24 case of tests/test_ns_solver.py the relative
    error against float64 eigh falls from 4.8e-7 to 4.9e-9), for three
    float64 products instead of a float64 eigendecomposition.  The result is
    re-symmetrized (the products drift asymmetric by float64 rounding).
    ``residual`` is the float32 stage's.
    The products are plain float64 ``torch.matmul`` (the JAX package does
    them by its Ozaki scheme, ``ops/df64.py``, which is not ported).
    """
    z32, resid = _ns_z(a_obs.to(torch.float32), float(inflat))
    k = a_obs.shape[-1]
    f64 = torch.float64
    a64 = a_obs.to(f64) + inflat * torch.eye(k, dtype=f64, device=a_obs.device)
    x = z32.to(f64)
    x = 1.5 * x - 0.5 * (x @ (a64 @ (x @ x)))
    return 0.5 * (x + x.transpose(-1, -2)), resid


def letkf_solve_group_refined(a_obs, g, xb, inflats, has_obs, *, rtpp_alpha,
                              rtps_alpha, return_diagnostics: bool = False):
    """The fused group solve at float64-refined precision.

    The contract of :func:`letkf_solve_group_from_normal` with
    ``solver_dtype=float64``, but each distinct inflation value's
    ``Z = A^(-1/2)`` comes from :func:`ns_invsqrt_refined` (one float32
    Newton-Schulz call, :func:`_ns_z`'s branch) and the weights and
    RTPP/RTPS run in float64.  Takes float32 or float64 normal terms.
    Returns ``xa [B, V, k]`` in ``xb``'s dtype, with ``return_diagnostics``
    also ``{"ns_residual": 0-d float32}`` (the float32 stages' worst).
    """
    f64 = torch.float64
    xb64 = xb.to(f64)
    g64 = g.to(f64)
    k = xb.shape[-1]
    xb_mean = xb64.mean(-1, keepdim=True)
    xb_prime = xb64 - xb_mean
    resid = torch.zeros((), dtype=torch.float32, device=xb.device)
    by_val = {}
    for vi, val in enumerate(inflats):
        by_val.setdefault(float(val), []).append(vi)
    xa_cols = [None] * len(inflats)
    for val, vis in by_val.items():
        z, r_val = ns_invsqrt_refined(a_obs, val)
        resid = torch.maximum(resid, r_val.to(torch.float32))
        zg = torch.einsum("bij,bj->bi", z, g64)
        u = torch.einsum("bij,bvj->bvi", z, xb_prime[:, vis, :])
        s = (zg[:, None, :] * u).sum(-1, keepdim=True)
        xa_sub = xb_mean[:, vis, :] + s + (k - 1) ** 0.5 * u
        for j, vi in enumerate(vis):
            xa_cols[vi] = xa_sub[:, j, :]
    xa = _relax_group(torch.stack(xa_cols, 1), xb_prime, rtpp_alpha,
                      rtps_alpha)
    xa = torch.where(has_obs[:, None, None], xa.to(xb.dtype), xb)
    if return_diagnostics:
        return xa, {"ns_residual": resid}
    return xa


def _eigh_batch(a: torch.Tensor):
    """Batched symmetric eigendecomposition ``(lam, v)``, in any order: the
    solver only forms order-invariant ``V f(diag) V^T`` quantities.  A
    ``[B, k, k]`` batch goes where :func:`eigh_route` says; the Jacobi
    solvers (:func:`jacobi_eigh`) pick the kernel or the plain version by
    the device."""
    if a.ndim == 3 and eigh_route(a.shape[-1], a.device, a.dtype) != "library":
        return jacobi_eigh(a)
    LIBRARY_SOLVES["linalg_eigh"] += 1
    return torch.linalg.eigh(a)


def letkf_weight_factors_from_normal(a_obs, g, inflat, *,
                                     solver_dtype=torch.float32):
    """``(lam, v, g)``: the eigenpairs of ``A = a_obs + inflat*I`` and ``g``,
    in ``solver_dtype``."""
    k = a_obs.shape[-1]
    a = a_obs.to(solver_dtype) + inflat * torch.eye(
        k, dtype=solver_dtype, device=a_obs.device)
    lam, v = _eigh_batch(a)
    return lam, v, g.to(solver_dtype)


def letkf_weight_factors(yo, yb, inflat, *, solver_dtype=torch.float32):
    """The eigen-factored weight transform from whitened ``yo [B, n]`` and
    ``yb [B, k, n]`` (zero-padded obs slots contribute nothing)."""
    yb = yb.to(solver_dtype)
    a_obs = torch.einsum("bkn,bln->bkl", yb, yb)
    g = torch.einsum("bkn,bn->bk", yb, yo.to(solver_dtype))
    return letkf_weight_factors_from_normal(a_obs, g, inflat,
                                            solver_dtype=solver_dtype)


def apply_weight_factors(lam, v, g, xb, *, solver_dtype=torch.float32):
    """The analysis ``[B, k]`` of one field ``xb [B, k]`` from the factors:
    ``s = (V^T g / lam) . (V^T xb')``, ``t = V ((V^T xb') / sqrt(lam))``."""
    xb = xb.to(solver_dtype)
    k = xb.shape[-1]
    xb_mean = xb.mean(-1, keepdim=True)
    vt_g = torch.einsum("bik,bi->bk", v, g)
    vt_x = torch.einsum("bik,bi->bk", v, xb - xb_mean)
    s = ((vt_g / lam) * vt_x).sum(-1, keepdim=True)
    t = torch.einsum("bik,bk->bi", v, vt_x / torch.sqrt(lam))
    return xb_mean + s + (k - 1) ** 0.5 * t


def _apply_z(z, g, xb, *, solver_dtype=torch.float32):
    """The analysis of one field from ``Z = A^(-1/2)``: ``u = Z xb'``,
    ``s = (Z g) . u``."""
    xb = xb.to(solver_dtype)
    k = xb.shape[-1]
    xb_mean = xb.mean(-1, keepdim=True)
    zg = torch.einsum("bij,bj->bi", z, g.to(solver_dtype))
    u = torch.einsum("bij,bj->bi", z, xb - xb_mean)
    s = (zg * u).sum(-1, keepdim=True)
    return xb_mean + s + (k - 1) ** 0.5 * u


def _relax(xa, xb_prime, use_rtpp, rtpp_alpha, use_rtps, rtps_alpha):
    """RTPP / RTPS posterior spread relaxation (letkf_core.f90:684-698)."""
    xa_mean = xa.mean(-1, keepdim=True)
    xa_prime = xa - xa_mean
    if use_rtpp:
        xa_prime = (1.0 - rtpp_alpha) * xa_prime + rtpp_alpha * xb_prime
    if use_rtps:
        xb_std = (xb_prime * xb_prime).sum(-1, keepdim=True)
        xa_std = (xa_prime * xa_prime).sum(-1, keepdim=True)
        xa_std = xa_std.clamp_min(torch.finfo(xa.dtype).tiny)
        factor = rtps_alpha * torch.sqrt(xb_std / xa_std) - rtps_alpha + 1.0
        xa_prime = xa_prime * factor
    return xa_mean + xa_prime


def _relax_group(xa, xb_prime, rtpp_alpha, rtps_alpha):
    """RTPP then RTPS over ``[B, V, k]`` with ``[V]`` strengths; a strength of
    0 is an exact identity, so disabled variables need no other path."""
    rtpp = torch.tensor(rtpp_alpha, dtype=xa.dtype, device=xa.device)[None, :, None]
    rtps = torch.tensor(rtps_alpha, dtype=xa.dtype, device=xa.device)[None, :, None]
    xa_mean = xa.mean(-1, keepdim=True)
    xa_prime = xa - xa_mean
    xa_prime = (1.0 - rtpp) * xa_prime + rtpp * xb_prime
    xb_std = (xb_prime * xb_prime).sum(-1, keepdim=True)
    xa_std = (xa_prime * xa_prime).sum(-1, keepdim=True)
    xa_std = xa_std.clamp_min(torch.finfo(xa.dtype).tiny)
    factor = rtps * torch.sqrt(xb_std / xa_std) - rtps + 1.0
    return xa_mean + xa_prime * factor


def letkf_solve_batch(xb, yo, yb, inflat, has_obs, *, use_rtpp: bool = False,
                      rtpp_alpha: float = 0.85, use_rtps: bool = False,
                      rtps_alpha: float = 0.85, solver_dtype=torch.float32):
    """LETKF analysis ``[B, k]`` in ``xb``'s dtype from whitened innovations
    ``yo [B, n]`` and obs-space perturbations ``yb [B, k, n]``; points where
    ``has_obs [B]`` is False keep their background."""
    yb_s = yb.to(solver_dtype)
    a_obs = torch.einsum("bkn,bln->bkl", yb_s, yb_s)
    g = torch.einsum("bkn,bn->bk", yb_s, yo.to(solver_dtype))
    return letkf_solve_from_normal(
        a_obs, g, xb, inflat, has_obs, use_rtpp=use_rtpp, rtpp_alpha=rtpp_alpha,
        use_rtps=use_rtps, rtps_alpha=rtps_alpha, solver_dtype=solver_dtype)


def letkf_solve_from_normal(a_obs, g, xb, inflat, has_obs, *,
                            use_rtpp: bool = False, rtpp_alpha: float = 0.85,
                            use_rtps: bool = False, rtps_alpha: float = 0.85,
                            solver_dtype=torch.float32,
                            return_diagnostics: bool = False):
    """Like :func:`letkf_solve_batch`, from accumulated normal terms
    ``a_obs [B, k, k]``, ``g [B, k]``.

    With ``return_diagnostics`` also returns ``{"ns_residual": 0-d float32}``,
    the Newton-Schulz certificate (0 on the eigh paths).
    """
    a = a_obs.to(solver_dtype)
    resid = torch.zeros((), dtype=torch.float32, device=a.device)
    if _use_ns(a):
        z, resid = _ns_z(a, inflat)
        xa = _apply_z(z, g, xb, solver_dtype=solver_dtype)
    else:
        lam, v, g = letkf_weight_factors_from_normal(
            a, g, inflat, solver_dtype=solver_dtype)
        xa = apply_weight_factors(lam, v, g, xb, solver_dtype=solver_dtype)
    if use_rtpp or use_rtps:
        xbp = xb.to(solver_dtype)
        xbp = xbp - xbp.mean(-1, keepdim=True)
        xa = _relax(xa, xbp, use_rtpp, rtpp_alpha, use_rtps, rtps_alpha)
    xa = torch.where(has_obs[:, None], xa.to(xb.dtype), xb)
    if return_diagnostics:
        return xa, {"ns_residual": resid.to(torch.float32)}
    return xa


def letkf_solve_group_from_normal(a_obs, g, xb, inflats, has_obs, *,
                                  rtpp_alpha, rtps_alpha,
                                  solver_dtype=torch.float32,
                                  return_diagnostics: bool = False):
    """Fused solve of ``V`` variables sharing one set of normal terms.

    ``xb [B, V, k]``, ``inflats``, ``rtpp_alpha`` and ``rtps_alpha`` ``[V]``
    (0 disables either exactly).  ``A_v = a_obs + inflat_v I`` differ only by
    a multiple of the identity, so one eigendecomposition of ``a_obs`` serves
    the whole group (eigenvalues shift by ``inflat_v``); on the
    Newton-Schulz path one ``Z`` serves each distinct inflation value (the
    stacked solve of :func:`letkf_solve_cycle_from_normal` for one group).

    Returns ``xa [B, V, k]`` in ``xb``'s dtype; with ``return_diagnostics``
    also ``{"ns_residual": 0-d float32}``.
    """
    a = a_obs.to(solver_dtype)
    if _use_ns(a):
        outs, diag = letkf_solve_cycle_from_normal(
            [a], [g], [xb], [inflats], [has_obs], rtpp_alpha_groups=[rtpp_alpha],
            rtps_alpha_groups=[rtps_alpha], solver_dtype=solver_dtype,
            return_diagnostics=True)
        return (outs[0], diag) if return_diagnostics else outs[0]
    xb_s = xb.to(solver_dtype)
    k = xb.shape[-1]
    xb_mean = xb_s.mean(-1, keepdim=True)
    xb_prime = xb_s - xb_mean                                     # [B, V, k]
    lam0, v = _eigh_batch(a)                                      # [B, k], [B, k, k]
    vt_g = torch.einsum("bik,bi->bk", v, g.to(solver_dtype))
    vt_x = torch.einsum("bik,bvi->bvk", v, xb_prime)
    lam = lam0[:, None, :] + torch.tensor(
        inflats, dtype=solver_dtype, device=a.device)[None, :, None]   # [B, V, k]
    s = ((vt_g[:, None, :] / lam) * vt_x).sum(-1, keepdim=True)
    t = torch.einsum("bik,bvk->bvi", v, vt_x / torch.sqrt(lam))
    xa = _relax_group(xb_mean + s + (k - 1) ** 0.5 * t, xb_prime,
                      rtpp_alpha, rtps_alpha)
    xa = torch.where(has_obs[:, None, None], xa.to(xb.dtype), xb)
    if return_diagnostics:
        return xa, {"ns_residual": torch.zeros((), dtype=torch.float32,
                                               device=a.device)}
    return xa


@tracing.spanned("solver.solve")
def letkf_solve_cycle_from_normal(
    a_groups,
    g_groups,
    xb_groups,
    inflats_groups,
    has_obs_groups,
    *,
    rtpp_alpha_groups,
    rtps_alpha_groups,
    solver_dtype=torch.float32,
    return_diagnostics: bool = False,
):
    """Several variable groups' solves, the NS iterations stacked by inflation.

    Per group ``gi``: ``a_groups[gi]`` ``[B, k, k]``, ``g_groups[gi]``
    ``[B, k]``, ``xb_groups[gi]`` ``[B, V, k]``, ``inflats_groups[gi]`` ``[V]``
    floats ``(k-1)/multi_infl``, ``has_obs_groups[gi]`` ``[B]`` bool, and
    ``[V]`` RTPP / RTPS strengths (0 disables either exactly).

    On the Newton-Schulz path all groups that share an inflation value go
    into ONE Newton-Schulz call: two calls per chunk under the production
    namelist (1.6 dynamics, 1.1 moisture).  On the CPU the plain iteration
    stops on the stack's worst residual, so the reported ``ns_residual`` is
    the worst over all stacks.  The eigh backends and float64 solve group by
    group (:func:`letkf_solve_group_from_normal`), one eigendecomposition
    each.

    Returns the per-group ``xa`` list in each ``xb``'s dtype, plus
    ``{"ns_residual": 0-d float32}`` with ``return_diagnostics``.
    """
    n_groups = len(a_groups)
    dev = xb_groups[0].device
    resid = torch.zeros((), dtype=torch.float32, device=dev)
    if not _use_ns(a_groups[0].to(solver_dtype)):
        outs = [letkf_solve_group_from_normal(
            a_groups[gi], g_groups[gi], xb_groups[gi], inflats_groups[gi],
            has_obs_groups[gi], rtpp_alpha=rtpp_alpha_groups[gi],
            rtps_alpha=rtps_alpha_groups[gi], solver_dtype=solver_dtype)
            for gi in range(n_groups)]
        return (outs, {"ns_residual": resid}) if return_diagnostics else outs

    f32 = torch.float32
    k = xb_groups[0].shape[-1]
    sqkm1 = torch.sqrt(torch.tensor(k - 1, dtype=f32, device=dev))
    a_gs = [a.to(f32) for a in a_groups]
    g_gs = [g.to(f32) for g in g_groups]
    xb_gs = [x.to(f32) for x in xb_groups]
    means = [x.mean(-1, keepdim=True) for x in xb_gs]
    primes = [x - m for x, m in zip(xb_gs, means)]

    # inflation value -> [(group, the group's variables with that value)]
    by_val = {}
    for gi, inflats in enumerate(inflats_groups):
        seen = {}
        for vi, val in enumerate(inflats):
            seen.setdefault(float(val), []).append(vi)
        for val, vis in seen.items():
            by_val.setdefault(val, []).append((gi, vis))

    xa_cols = [[None] * len(inflats_groups[gi]) for gi in range(n_groups)]
    for val, members in by_val.items():
        astack = (a_gs[members[0][0]] if len(members) == 1
                  else torch.cat([a_gs[gi] for gi, _ in members], 0))
        z_all, r_val = _ns_z(astack, val)
        resid = torch.maximum(resid, r_val.to(f32))
        off = 0
        with tracing.label("solver.apply"):
            for gi, vis in members:
                b = a_gs[gi].shape[0]
                z = z_all[off:off + b]
                off += b
                zg = torch.einsum("bij,bj->bi", z, g_gs[gi])
                u = torch.einsum("bij,bvj->bvi", z, primes[gi][:, vis, :])
                s = (zg[:, None, :] * u).sum(-1, keepdim=True)
                xa_sub = means[gi][:, vis, :] + s + sqkm1 * u
                for j, vi in enumerate(vis):
                    xa_cols[gi][vi] = xa_sub[:, j, :]

    outs = []
    for gi in range(n_groups):
        with tracing.label("solver.relax"):
            xa = _relax_group(torch.stack(xa_cols[gi], 1), primes[gi],
                              rtpp_alpha_groups[gi], rtps_alpha_groups[gi])
            outs.append(torch.where(has_obs_groups[gi][:, None, None],
                                    xa.to(xb_groups[gi].dtype), xb_groups[gi]))
    if return_diagnostics:
        return outs, {"ns_residual": resid}
    return outs


@tracing.spanned("solver.tune_q")
def tune_q(q: torch.Tensor) -> torch.Tensor:
    """Moisture positivity fix (letkf_tune_q) over the member (last) axis.

    Zeroes negative members and rescales the positive ones so the member sum,
    hence the ensemble mean, is kept.  Points with no positive member become
    zero.
    """
    pos = q > 0.0
    sum_all = q.sum(-1, keepdim=True)
    sum_pos = torch.where(pos, q, 0.0).sum(-1, keepdim=True)
    any_pos = sum_pos > 0.0
    ratio = torch.where(any_pos, sum_all / torch.where(any_pos, sum_pos, 1.0), 0.0)
    return torch.where(pos, ratio * q, 0.0).to(q.dtype)
