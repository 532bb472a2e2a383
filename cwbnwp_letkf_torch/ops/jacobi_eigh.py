"""Batched small-k symmetric eigendecomposition by cyclic Jacobi.

Port of the JAX package's ``ops/pallas_eigh.py``.  The LETKF solve needs one
k-by-k symmetric eigendecomposition per gridpoint; :func:`jacobi_eigh` runs
``sweeps`` sweeps of two-sided Jacobi rotations over a ``[B, k, k]`` batch:

- even k >= 4: the Brent-Luk round-robin order (:func:`jacobi_parallel`):
  each round applies k/2 disjoint rotations computed from the pre-round
  matrix, a sweep is k-1 rounds, and the pairing advances as a round-robin
  tournament with player 0 fixed;
- odd k or k < 4: the sequential cyclic-by-row order (:func:`jacobi_cyclic`).

CUDA tensors go to the hand-written kernels (:mod:`.eigh_kernel`), CPU
tensors to these plain versions; there is no other route.  The eigenpairs are
unsorted, in the TPU kernels' order, with ``a ~= v diag(lam) v^T``: the
solver only forms order-invariant ``V f(diag) V^T`` quantities.
"""
from __future__ import annotations

import torch

from . import eigh_kernel

#: |a_pq| at or below which a rotation is the identity
_TINY = 1e-30


def _schur(app, aqq, apq):
    """The guarded symmetric Schur 2x2 (Golub & Van Loan alg. 8.4.1):
    ``(c, s)`` that zero ``a_pq``; ``t = 1`` where ``tau == 0`` and the
    identity where ``|a_pq| <= 1e-30``."""
    nz = apq.abs() > _TINY
    apq_safe = torch.where(nz, apq, torch.ones_like(apq))
    tau = (aqq - app) / (2.0 * apq_safe)
    t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    t = torch.where(tau == 0.0, 1.0, t)
    t = torch.where(nz, t, 0.0)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, t * c


def _rotated(c, s, x, y):
    """``(c x - s y, s x + c y)``."""
    return c * x - s * y, s * x + c * y


def round_robin(k: int, rounds: int) -> torch.Tensor:
    """``[rounds + 1, k]`` pairings ``[top | bot]``: round r pairs
    ``top[i]`` with ``bot[i]``; the last row is the order after the last
    round, the order of the eigenpairs."""
    m = k // 2
    top, bot = list(range(m)), list(range(m, k))
    rows = []
    for _ in range(rounds):
        rows.append(top + bot)
        top, bot = [top[0], bot[0]] + top[1:m - 1], bot[1:] + [top[m - 1]]
    rows.append(top + bot)
    return torch.tensor(rows)


def jacobi_parallel(a: torch.Tensor, *, sweeps: int = 7):
    """The plain version of K3: round-robin Jacobi, even k >= 4.

    Returns unsorted ``(lam [B, k], v [B, k, k])``, no polish, in the order
    of the last pairing.
    """
    b, k, _ = a.shape
    if k < 4 or k % 2:
        raise ValueError(f"round-robin Jacobi needs an even k >= 4, got {k}")
    m = k // 2
    rounds = sweeps * (k - 1)
    tables = round_robin(k, rounds).to(a.device)
    a = a.clone()
    v = torch.eye(k, dtype=a.dtype, device=a.device).expand(b, k, k).clone()
    for r in range(rounds):
        top, bot = tables[r, :m], tables[r, m:]
        c, s = _schur(a[:, top, top], a[:, bot, bot], a[:, top, bot])  # [B, m]
        a[:, top], a[:, bot] = _rotated(c[:, :, None], s[:, :, None],
                                        a[:, top], a[:, bot])
        cc, sc = c[:, None, :], s[:, None, :]
        a[:, :, top], a[:, :, bot] = _rotated(cc, sc, a[:, :, top], a[:, :, bot])
        v[:, :, top], v[:, :, bot] = _rotated(cc, sc, v[:, :, top], v[:, :, bot])
    perm = tables[rounds]
    return a.diagonal(dim1=-2, dim2=-1)[:, perm], v[:, :, perm]


def jacobi_cyclic(a: torch.Tensor, *, sweeps: int = 7):
    """The plain version of K4: sequential cyclic-by-row Jacobi, any k.

    Returns unsorted ``(lam [B, k], v [B, k, k])``, no polish.
    """
    b, k, _ = a.shape
    a = a.clone()
    v = torch.eye(k, dtype=a.dtype, device=a.device).expand(b, k, k).clone()
    for _ in range(sweeps):
        for p in range(k - 1):
            for q in range(p + 1, k):
                c, s = _schur(a[:, p, p], a[:, q, q], a[:, p, q])       # [B]
                c1, s1 = c[:, None], s[:, None]
                a[:, p], a[:, q] = _rotated(c1, s1, a[:, p], a[:, q])
                a[:, :, p], a[:, :, q] = _rotated(c1, s1, a[:, :, p], a[:, :, q])
                v[:, :, p], v[:, :, q] = _rotated(c1, s1, v[:, :, p], v[:, :, q])
    return a.diagonal(dim1=-2, dim2=-1).clone(), v


def jacobi_eigh(a: torch.Tensor, *, sweeps: int = 7, polish: bool = True):
    """Batched symmetric eigendecomposition of a ``[B, k, k]`` batch.

    Even k >= 4 takes the round-robin order, odd or tiny k the sequential
    one.  ``polish`` adds one Newton orthogonalization of V,
    ``V (3I - V^T V) / 2``, and the Rayleigh eigenvalues ``diag(V^T A V)``,
    as float32 matmuls; the sweeps' rounding in V drops about tenfold.

    Returns ``(lam [B, k], v [B, k, k])``, unsorted;
    ``a ~= v diag(lam) v^T``.
    """
    if a.ndim != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"need a [B, k, k] batch, got shape {tuple(a.shape)}")
    k = a.shape[-1]
    if a.device.type == "cuda":
        lam, v = eigh_kernel.launch(a.contiguous(), sweeps=sweeps)
    elif a.device.type == "cpu":
        plain = (jacobi_parallel if eigh_kernel.kernel_for(k) == "parallel"
                 else jacobi_cyclic)
        lam, v = plain(a, sweeps=sweeps)
    else:
        raise ValueError(f"no Jacobi eigensolver for tensors on {a.device}")
    if polish:
        eye = torch.eye(k, dtype=a.dtype, device=a.device)
        v = v @ (1.5 * eye - 0.5 * (v.transpose(-1, -2) @ v))
        lam = (v * (a @ v)).sum(-2)
    return lam, v
