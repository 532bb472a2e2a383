"""K3's layout above k = 96 (``csrc/jacobi_eigh.cu``,
``jacobi_parallel_big_kernel``) on the CPU: V in registers in slot order,
moved each round by ``eigh_kernel.slot_schedule``'s fixed permutation, and
each round's pairing and rotations made from the round before, as the kernel
makes them.  A torch emulation of that layout must give the plain version's
eigenpairs bit for bit: the kernel runs the same products in another layout,
so on the card it is held to the same equality (tests/test_torch_kernels.py).
"""
import numpy as np
import pytest
import torch

from cwbnwp_letkf_torch.ops import cuda_build, eigh_kernel
from cwbnwp_letkf_torch.ops.jacobi_eigh import (_rotated, _schur,
                                                jacobi_parallel, round_robin)

from .torch_parity import one_torch_thread, spd_case  # noqa: F401


@pytest.mark.parametrize("k", [98, 128, 130, 176])
def test_slot_order_follows_the_pairing(k):
    """After r rounds of ``move`` the slots hold round r's pairing, by the
    tables and by the closed form, over a sweep and a half."""
    sched = eigh_kernel.slot_schedule(k)
    rounds = 3 * (k - 1) // 2
    tables = round_robin(k, rounds).tolist()
    order = sched.order
    assert order == tables[0]
    for r in range(1, rounds + 1):
        order = [order[s] for s in sched.move]
        assert order == tables[r] == eigh_kernel.ring_pairing(k, r), (k, r)


@pytest.mark.parametrize("k", range(98, 177, 2))
def test_halves_cover_the_pairs(k):
    """Each even k above 96 splits its m pairs into a half of L0 and one of
    P = ceil(m / 2) = ceil(k / 4) (the kernel's instance, 25 .. 44), with
    L0 = P - 1 or P, so half 0 has at most one spare register pair."""
    sched = eigh_kernel.slot_schedule(k)
    m = k // 2
    assert sched.pairs == (k + 3) // 4 and 25 <= sched.pairs <= 44
    assert sched.first_half in (sched.pairs - 1, sched.pairs)
    assert sched.first_half + sched.pairs == m
    assert sorted(sched.move) == list(range(k))


@pytest.mark.parametrize("k", [6, 97, 3])
def test_slot_schedule_needs_even_k(k):
    if k % 2 == 0:
        assert eigh_kernel.slot_schedule(k).move == [0, 3, 1, 4, 5, 2]
    else:
        with pytest.raises(ValueError, match="even k"):
            eigh_kernel.slot_schedule(k)


def emulate_layout(a, sweeps):
    """The kernel's data layout in torch: ``vt[:, row, g, u]`` and ``vb`` are
    thread (row, g)'s registers, half g's pair ``first[g] + u`` (half 0's
    spare rotates by the identity); the shuffle across the half-row boundary
    and the moves are the kernel's lines.  The pairing of each next round is
    made from the round before's (``next_couple``), its rotations from A
    after the round."""
    b, k, _ = a.shape
    sched = eigh_kernel.slot_schedule(k)
    m, npairs, l0 = k // 2, sched.pairs, sched.first_half
    first = (0, l0)
    a = a.clone()
    top, bot = torch.arange(m), torch.arange(m, k)
    c, s = _schur(a[:, top, top], a[:, bot, bot], a[:, top, bot])
    rows = torch.arange(k)[:, None]
    vt = torch.stack([(rows == f + torch.arange(npairs)).float()
                      for f in first], 1).expand(b, k, 2, npairs).clone()
    vb = torch.stack([(rows == m + f + torch.arange(npairs)).float()
                      for f in first], 1).expand(b, k, 2, npairs).clone()
    spare = torch.zeros(2, npairs, dtype=torch.bool)
    spare[0, l0:] = True
    reg_pair = torch.tensor([[min(f + u, m - 1) for u in range(npairs)]
                             for f in first])
    g0 = (torch.arange(2) == 0)[:, None].expand(2, 1)
    full0 = l0 == npairs
    for _ in range(sweeps * (k - 1)):
        a[:, top], a[:, bot] = _rotated(c[:, :, None], s[:, :, None],
                                        a[:, top], a[:, bot])
        cc, sc = c[:, None, :], s[:, None, :]
        a[:, :, top], a[:, :, bot] = _rotated(cc, sc, a[:, :, top], a[:, :, bot])
        cr = torch.where(spare, 1.0, c[:, reg_pair])[:, None]
        sr = torch.where(spare, 0.0, s[:, reg_pair])[:, None]
        vt, vb = _rotated(cr, sr, vt, vb)
        # the moves: send, shuffle with the other half, shift
        send = torch.where(g0, vt[..., npairs - 1 if full0 else npairs - 2, None],
                           vb[..., :1])
        recv = send.flip(2)
        top0 = torch.where(g0, vt[..., :1], recv)
        top1 = torch.where(g0, vb[..., :1], vt[..., :1])
        bot_last = torch.where(g0, recv if full0 else vb[..., -1:], vt[..., -1:])
        bot_prev = torch.where(g0 & (not full0), recv, vb[..., -1:])
        vt = torch.cat([top0, top1, vt[..., 1:-1]], -1)
        vb = torch.cat([vb[..., 1:-1], bot_prev, bot_last], -1)
        # the next round's couples from this round's (next_couple)
        idx = torch.arange(m)
        lo = torch.where(idx <= 1, 0, idx - 1)
        hi = torch.where(idx == m - 1, m - 1, idx + 1)
        top, bot = (torch.where(idx == 1, bot[lo], top[lo]),
                    torch.where(idx == m - 1, top[hi], bot[hi]))
        c, s = _schur(a[:, top, top], a[:, bot, bot], a[:, top, bot])
    perm = torch.cat([top, bot])
    lam = a.diagonal(dim1=-2, dim2=-1)[:, perm]
    v = torch.empty_like(a)
    for g, length in ((0, l0), (1, npairs)):
        v[:, :, first[g]:first[g] + length] = vt[:, :, g, :length]
        v[:, :, m + first[g]:m + first[g] + length] = vb[:, :, g, :length]
    return lam, v


@pytest.mark.parametrize("k", [98, 128, 176])
def test_layout_emulation_equals_plain_bit_for_bit(k):
    """Two sweeps through the kernel's layout give ``jacobi_parallel``'s
    eigenvalues and eigenvectors bit for bit (the same products in the
    same order), at an odd m with a spare (98), and at L0 = P (128, 176)."""
    a = torch.from_numpy(spd_case(np.random.default_rng(900 + k), 3, k))
    lam, v = emulate_layout(a, 2)
    lam_p, v_p = jacobi_parallel(a, sweeps=2)
    assert torch.equal(lam, lam_p) and torch.equal(v, v_p)


def test_resources_reads_the_compiler_report(tmp_path):
    """``cuda_build.resources`` reads registers, stack and spills of each
    entry from a library's ``-Xptxas -v`` report (``chip_smoke.py`` phase 1
    fails on a spill in K3 above k = 96)."""
    big = "_ZN12_GLOBAL__N_126jacobi_parallel_big_kernelILi44EEEvPKfPfS3_iii"
    (tmp_path / "lib.log").write_text(
        "ptxas info    : 0 bytes gmem\n"
        f"ptxas info    : Compiling entry function '{big}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {big}\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 2 barriers, 392 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function 'other' for 'sm_90a'\n"
        "    16 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers\n")
    assert cuda_build.resources(tmp_path / "lib.so") == {
        big: {"stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 168},
        "other": {"stack": 16, "spill_stores": 8, "spill_loads": 4,
                  "registers": 128}}
