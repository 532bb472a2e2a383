"""K4's layout above k = 96 (``csrc/jacobi_eigh.cu``,
``jacobi_cyclic_chain_kernel`` and ``jacobi_cyclic_v_kernel``) on the CPU.

The chain rotates A alone and writes each rotation's ``(c, s)`` to a log;
the V pass rebuilds V from the log, row by row, 32 rows a warp.  The chain
is pipelined by one rotation: rotation q + 1's 2x2 is made from what its
owner held before rotation q, rotated by rotation q's ``(c, s)``, and the
shared-memory copy of A keeps row and column p stale through p and its
diagonal unread.  A batch whose log would pass ``eigh_kernel.LOG_CAP_BYTES``
runs in pieces (``eigh_kernel.log_pieces``) through one workspace.  A torch
emulation of that schedule must give the plain version's eigenpairs bit for
bit: the kernels run the same products in another order, so on the card
they are held to the same equality (tests/test_torch_kernels.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cwbnwp_letkf_tpu.ops.pallas_eigh import jacobi_eigh as jacobi_eigh_pallas
from cwbnwp_letkf_torch.ops import eigh_kernel
from cwbnwp_letkf_torch.ops.jacobi_eigh import _rotated, _schur, jacobi_cyclic

from .torch_parity import normal_case, one_torch_thread, spd_case  # noqa: F401


def emulate_chain(a, sweeps, log):
    """The chain on A alone, as the kernel runs it; writes each rotation's
    ``(c, s)`` into ``log [B, rotations, 2]`` and returns lam.  ``shared``
    is the block's copy of A; ``diag``, ``row_p``/``col_p`` (A's row and
    column p), ``y_row``/``y_col`` (row and column q) and the 2x2s are
    registers."""
    b, k, _ = a.shape
    shared = a.clone()
    diag = a.diagonal(dim1=1, dim2=2).clone()
    i = 0
    for _ in range(sweeps):
        for p in range(k - 1):
            row_p, col_p = shared[:, p].clone(), shared[:, :, p].clone()
            y_row, y_col = shared[:, p + 1].clone(), shared[:, :, p + 1].clone()
            app, apq, aqp, aqq = diag[:, p], row_p[:, p + 1], col_p[:, p + 1], diag[:, p + 1]
            if p + 2 < k:   # rotation p + 2's 2x2 before rotation p + 1
                nxt = (row_p[:, p + 2], y_row[:, p + 2], col_p[:, p + 2],
                       y_col[:, p + 2], diag[:, p + 2])
            c, s = _schur(app, aqq, apq)
            for q in range(p + 1, k):
                x_pp, x_qp = _rotated(c, s, app, aqp)
                x_pq, x_qq = _rotated(c, s, apq, aqq)
                x_pp, x_pq = _rotated(c, s, x_pp, x_pq)
                x_qp, x_qq = _rotated(c, s, x_qp, x_qq)
                log[:, i, 0], log[:, i, 1] = c, s
                i += 1
                if q + 1 < k:   # rotation q + 1's a_pq, a_qp, rotated by their owner
                    n_apq, _ = _rotated(c, s, nxt[0], nxt[1])
                    n_aqp, _ = _rotated(c, s, nxt[2], nxt[3])
                    n_aqq = nxt[4]
                c1, s1 = c[:, None], s[:, None]
                row_p, y_row = _rotated(c1, s1, row_p, y_row)
                col_p, y_col = _rotated(c1, s1, col_p, y_col)
                row_p[:, q], col_p[:, q], diag[:, q] = x_pq, x_qp, x_qq
                shared[:, q], shared[:, :, q] = y_row, y_col
                if q + 1 < k:
                    y_row, y_col = shared[:, q + 1].clone(), shared[:, :, q + 1].clone()
                    if q + 2 < k:
                        nxt = (row_p[:, q + 2], y_row[:, q + 2], col_p[:, q + 2],
                               y_col[:, q + 2], diag[:, q + 2])
                    c, s = _schur(x_pp, n_aqq, n_apq)
                    apq, aqp, aqq = n_apq, n_aqp, n_aqq
                app = x_pp
            shared[:, p], shared[:, :, p] = row_p, col_p
            diag[:, p] = app
    return diag


def emulate_v(log, b, k, sweeps):
    """The V pass: warp w holds rows 32 w + lane of V as ``vt[:, w, c,
    lane] = V[32 w + lane, c]`` (V = I to start), each lane rotating its own
    row's entries p and q by the log, rotation after rotation."""
    warps = -(-k // 32)
    rows = torch.arange(32 * warps).reshape(warps, 1, 32)
    vt = (torch.arange(k).reshape(1, k, 1) == rows).to(log.dtype)
    vt = vt.expand(b, warps, k, 32).clone()
    i = 0
    for _ in range(sweeps):
        for p in range(k - 1):
            x = vt[:, :, p].clone()
            for q in range(p + 1, k):
                c = log[:, i, 0].reshape(b, 1, 1)
                s = log[:, i, 1].reshape(b, 1, 1)
                x, vt[:, :, q] = _rotated(c, s, x, vt[:, :, q])
                i += 1
            vt[:, :, p] = x
    return vt.transpose(2, 3).reshape(b, 32 * warps, k)[:, :k]


def emulate(a, sweeps, cap=None):
    """K4 above k = 96 as the wrapper drives it: the batch in the pieces of
    ``log_pieces(b, k, sweeps, cap)`` through one log workspace sized for
    the largest, each piece's chain, then its V pass."""
    b, k, _ = a.shape
    pieces = eigh_kernel.log_pieces(b, k, sweeps, cap)
    rotations = sweeps * k * (k - 1) // 2
    workspace = torch.empty(max(e - s for s, e in pieces), rotations, 2,
                            dtype=a.dtype)
    lam, v = torch.empty(b, k, dtype=a.dtype), torch.empty_like(a)
    for start, stop in pieces:
        log = workspace[:stop - start]
        lam[start:stop] = emulate_chain(a[start:stop], sweeps, log)
        v[start:stop] = emulate_v(log, stop - start, k, sweeps)
    return lam, v


@pytest.mark.parametrize("k,sweeps", [(5, 3), (9, 2), (13, 2), (97, 1)])
def test_emulation_equals_plain_bit_for_bit(k, sweeps):
    """The chain on A alone and V from its log give ``jacobi_cyclic``'s
    eigenvalues and eigenvectors bit for bit (the same products, rows
    before columns), at k below a warp and at k = 97 with its four slots a
    lane (j = lane + 32 t, the last slot partly empty)."""
    a = torch.from_numpy(spd_case(np.random.default_rng(950 + k), 2, k))
    lam, v = emulate(a, sweeps)
    lam_p, v_p = jacobi_cyclic(a, sweeps=sweeps)
    assert torch.equal(lam, lam_p) and torch.equal(v, v_p)


def test_emulation_in_pieces_equals_plain_bit_for_bit():
    """A cap of two matrices' log cuts a batch of five at k = 97 into pieces
    of 2, 2 and 1 through one workspace; the eigenpairs stay the plain
    version's bit for bit."""
    k, sweeps = 97, 1
    cap = 2 * eigh_kernel.log_bytes(k, sweeps)
    assert eigh_kernel.log_pieces(5, k, sweeps, cap) == [(0, 2), (2, 4), (4, 5)]
    a = torch.from_numpy(spd_case(np.random.default_rng(961), 5, k))
    lam, v = emulate(a, sweeps, cap)
    lam_p, v_p = jacobi_cyclic(a, sweeps=sweeps)
    assert torch.equal(lam, lam_p) and torch.equal(v, v_p)


def test_emulation_matches_pallas_at_k9():
    """The emulation against the JAX package's K4 (``pallas_eigh.py:76``) in
    interpret mode at k = 9, seven sweeps in float64: the same rotations in
    the same order, so the unpolished eigenpairs agree element by element
    at tests/test_torch_large_k.py's tolerances (1e-9 of max|lam|, 1e-8 in
    V)."""
    k = 9
    a, _ = normal_case(np.random.default_rng(k), 3, k, 2 * k)
    a = (a + (k - 1) / 1.6 * np.eye(k, dtype=np.float32)).astype(np.float64)
    lam_p, v_p = jacobi_eigh_pallas(jnp.asarray(a), sweeps=7, interpret=True,
                                    polish=False)
    lam, v = emulate(torch.from_numpy(a), 7)
    lam_p = np.asarray(lam_p)
    np.testing.assert_allclose(lam.numpy(), lam_p, rtol=0,
                               atol=1e-9 * np.abs(lam_p).max())
    np.testing.assert_allclose(v.numpy(), np.asarray(v_p), rtol=0, atol=1e-8)


@pytest.mark.parametrize("k,sweeps,want", [(41, 7, 0), (96, 7, 0), (128, 7, 0),
                                           (97, 1, 8 * 4656),
                                           (129, 7, 462_336),
                                           (177, 7, 872_256)])
def test_log_bytes(k, sweeps, want):
    """8 bytes a rotation of K4 above k = 96 (462 KB a matrix at k = 129,
    872 KB at 177); no log for K4 up to 96 or for K3."""
    assert eigh_kernel.log_bytes(k, sweeps) == want


@pytest.mark.parametrize("b,k,cap,want", [
    (4096, 177, None, [(0, 1230), (1230, 2460), (2460, 3690), (3690, 4096)]),
    (256, 129, None, [(0, 256)]),
    (3, 129, 100, [(0, 1), (1, 2), (2, 3)]),
    (5, 41, 1, [(0, 5)]),
])
def test_log_pieces(b, k, cap, want):
    """The pieces cover the batch in order, each within the cap (1 GiB by
    default: a 4,096-matrix chunk at k = 177 takes four), at least one
    matrix a piece, and one piece where there is no log."""
    pieces = eigh_kernel.log_pieces(b, k, 7, cap)
    assert pieces == want
    cap = eigh_kernel.LOG_CAP_BYTES if cap is None else cap
    assert all(stop - start == 1 or
               (stop - start) * eigh_kernel.log_bytes(k) <= cap
               for start, stop in pieces)
