"""Batched ensemble-space LETKF solve by Newton-Schulz inverse square roots.

Port of the Newton-Schulz path of the JAX package's ``ops/solver.py``.  With
``A = a_obs + inflat*I`` (``a_obs = Yb' Yb'^T`` and ``g = Yb' yo'``
accumulated per point) and ``Z = A^(-1/2)``, the analysis of every variable
sharing that inflation value is

    u  = Z xb'                    (xb' = member deviations)
    s  = (Z g) . u                (= g^T A^-1 xb', Z symmetric)
    xa = mean(xb) + s + sqrt(k-1) u

followed by RTPP / RTPS relaxation; points without obs keep the background.
The solve never eigendecomposes.  ``Z`` comes from the coupled Newton-Schulz
iteration: the hand-written CUDA kernel (:mod:`.ns_kernel`) for tensors on a
card, its plain version :func:`ns_invsqrt` for tensors on the CPU.  Float32
only; the eigh backends and the float64 paths are not ported.
"""
from __future__ import annotations

import torch

from . import ns_kernel


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


def _ns_z(a_obs: torch.Tensor, inflat: float):
    """``(z, residual)``: the CUDA kernel on a card, the plain version on the CPU."""
    if a_obs.device.type == "cuda":
        z, _, resid = ns_kernel.ns_invsqrt_cuda(a_obs.contiguous(), float(inflat))
        return z, resid
    if a_obs.device.type == "cpu":
        z, _, resid = ns_invsqrt(a_obs, float(inflat), return_info=True)
        return z, resid
    raise ValueError(f"no Newton-Schulz solve for tensors on {a_obs.device}")


def letkf_solve_cycle_from_normal(
    a_groups,
    g_groups,
    xb_groups,
    inflats_groups,
    has_obs_groups,
    *,
    rtpp_alpha_groups,
    rtps_alpha_groups,
    return_diagnostics: bool = False,
):
    """Several variable groups' solves, the NS iterations stacked by inflation.

    Per group ``gi``: ``a_groups[gi]`` ``[B, k, k]``, ``g_groups[gi]``
    ``[B, k]``, ``xb_groups[gi]`` ``[B, V, k]``, ``inflats_groups[gi]`` ``[V]``
    floats ``(k-1)/multi_infl``, ``has_obs_groups[gi]`` ``[B]`` bool, and
    ``[V]`` RTPP / RTPS strengths (0 disables either exactly).

    All groups that share an inflation value go into ONE Newton-Schulz call:
    two calls per chunk under the production namelist (1.6 dynamics, 1.1
    moisture).  On the CPU the plain iteration stops on the stack's worst
    residual, so the reported ``ns_residual`` is the worst over all stacks.

    Returns the per-group ``xa`` list in each ``xb``'s dtype, plus
    ``{"ns_residual": 0-d float32}`` with ``return_diagnostics``.
    """
    f32 = torch.float32
    n_groups = len(a_groups)
    k = xb_groups[0].shape[-1]
    dev = xb_groups[0].device
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

    resid = torch.zeros((), dtype=f32, device=dev)
    xa_cols = [[None] * len(inflats_groups[gi]) for gi in range(n_groups)]
    for val, members in by_val.items():
        astack = (a_gs[members[0][0]] if len(members) == 1
                  else torch.cat([a_gs[gi] for gi, _ in members], 0))
        z_all, r_val = _ns_z(astack, val)
        resid = torch.maximum(resid, r_val.to(f32))
        off = 0
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
        xa = torch.stack(xa_cols[gi], 1)
        rtpp = torch.tensor(rtpp_alpha_groups[gi], dtype=f32, device=dev)[None, :, None]
        rtps = torch.tensor(rtps_alpha_groups[gi], dtype=f32, device=dev)[None, :, None]
        xa_mean = xa.mean(-1, keepdim=True)
        xa_prime = xa - xa_mean
        xa_prime = (1.0 - rtpp) * xa_prime + rtpp * primes[gi]
        xb_std = (primes[gi] * primes[gi]).sum(-1, keepdim=True)
        xa_std = (xa_prime * xa_prime).sum(-1, keepdim=True)
        xa_std = xa_std.clamp_min(torch.finfo(f32).tiny)
        factor = rtps * torch.sqrt(xb_std / xa_std) - rtps + 1.0
        xa = (xa_mean + xa_prime * factor).to(xb_groups[gi].dtype)
        outs.append(torch.where(has_obs_groups[gi][:, None, None], xa,
                                xb_groups[gi]))
    if return_diagnostics:
        return outs, {"ns_residual": resid}
    return outs


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
