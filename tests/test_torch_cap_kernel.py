"""The cap search kernel's plain version and arithmetic, on the CPU.

``ops/cap_kernel.py`` launches ``csrc/cap_search.cu`` for the capped branch
of ``dense.terms_from_r2`` on a card.  Here: its plain version selects as
``terms_from_r2`` does; the kernel's counting scheme (the row in 16-byte
slots at any offset, +inf outside the row and at masked records, only the
values inside the bracket compared with the candidates, each candidate's
three operations rounded on their own), emulated in float32 torch, gives
``dense._cap_threshold``'s thresholds and the same selection bit for bit;
``work`` against a brute count; what ``launch`` refuses; and every CPU call
of ``terms_from_r2`` keeps its own code.  The kernel itself is held against
the plain version on a card in ``tests/test_torch_kernels.py``.  Imports no
JAX.
"""
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from cwbnwp_letkf_torch import tracing
from cwbnwp_letkf_torch.constants import GC1999_SQ
from cwbnwp_letkf_torch.localization import WEIGHT_GAUSSIAN
from cwbnwp_letkf_torch.ops import cap_kernel, dense

from .torch_parity import cap_case, cap_tie_rows

F32 = torch.float32
N_MAX = 30


def candidate(lo, hi, i):
    """``lo + (i / 16) (hi - lo)``, each operation rounded to float32."""
    return lo + torch.tensor(i / cap_kernel.SPLITS, dtype=F32) * (hi - lo)


def emulate(r2, row_mask, n_max, r2_cap, pad=0, brackets=None):
    """``(thr, sel, over)`` by the kernel's arithmetic, a row at a time: the
    row at offset ``pad`` in whole 16-byte slots, +inf around it and at
    masked records; each round the values at or below ``lo`` counted once,
    only those in ``(lo, c_15]`` against every candidate; ``n_ok`` the
    candidates whose count is within ``n_max``.  ``brackets``, a list, gets
    each row's ``(lo, hi)`` after every round."""
    b, r = r2.shape
    slots = (pad + r + 3) // 4
    inf = torch.tensor(float("inf"))
    cap = torch.tensor(r2_cap, dtype=F32)
    vals = r2 if row_mask is None else torch.where(row_mask[None], r2, inf)
    padded = torch.full((b, 4 * slots), float("inf"))
    padded[:, pad:pad + r] = vals
    thr = torch.empty(b)
    over = torch.empty(b, dtype=torch.bool)
    for row in range(b):
        v = padded[row]
        lo, hi = torch.tensor(-1.0), cap
        row_over = True
        for rnd in range(cap_kernel.ROUNDS):
            c = torch.stack([candidate(lo, hi, i)
                             for i in range(1, cap_kernel.SPLITS)])
            below = int((v <= lo).sum())
            inside = (v > lo) & (v <= c[-1])
            under = (inside[None] & (v[None] <= c[:, None])).sum(1)
            if rnd == 0:
                row_over = int((v <= cap).sum()) > n_max
                if not row_over:
                    break
            n_ok = int((below + under <= n_max).sum())
            next_lo = lo if n_ok == 0 else candidate(lo, hi, n_ok)
            hi = hi if n_ok == cap_kernel.SPLITS - 1 else candidate(
                lo, hi, n_ok + 1)
            lo = next_lo
            if brackets is not None:
                brackets.append((float(lo), float(hi)))
        thr[row] = lo if row_over else cap
        over[row] = row_over
    sel = (padded <= thr[:, None])[:, pad:pad + r]
    return thr, sel, over


def reference_threshold(r2, row_mask, n_max, r2_cap):
    if row_mask is not None:
        r2 = torch.where(row_mask[None], r2, float("inf"))
    return dense._cap_threshold(r2, n_max, r2_cap)


def bracket_tie_rows(rng, r, n_max):
    """Rows holding the values of every round's bracket ends of random rows:
    ties at the candidates of the later rounds too."""
    r2, _ = cap_case(rng, 4, r, inside=4 * n_max)
    got = []
    emulate(torch.from_numpy(r2), None, n_max, GC1999_SQ, brackets=got)
    ends = np.array([e for pair in got for e in pair], np.float32)
    rows = r2.copy()
    for row in rows:
        row[rng.choice(r, ends.size, replace=False)] = ends
    return rows


def adversarial(r=257):
    rng = np.random.default_rng(3)
    return np.concatenate([cap_tie_rows(r, N_MAX),
                           bracket_tie_rows(rng, r, N_MAX)])


def as_bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("rows", ["random", "masked", "adversarial"])
def test_emulated_kernel_gives_cap_threshold_bit_for_bit(rows):
    rng = np.random.default_rng(11)
    mask = None
    if rows == "adversarial":
        r2 = adversarial()
    else:
        r2, mask = cap_case(rng, 24, 900, inside=150,
                            masked=0.2 if rows == "masked" else 0.0)
    r2 = torch.from_numpy(r2)
    mask = None if mask is None else torch.from_numpy(mask)
    want = reference_threshold(r2, mask, N_MAX, GC1999_SQ)
    sel_p, over_p = cap_kernel.plain(r2, mask, N_MAX, GC1999_SQ)
    for pad in range(4):
        thr, sel, over = emulate(r2, mask, N_MAX, GC1999_SQ, pad=pad)
        assert torch.equal(as_bits(thr), as_bits(want)), pad
        assert torch.equal(sel, sel_p) and torch.equal(over, over_p), pad
    assert over_p.any()
    if rows == "adversarial":
        assert not over_p.all()


def test_emulated_kernel_at_n_max_zero_and_one_record_over():
    rng = np.random.default_rng(5)
    r2, _ = cap_case(rng, 6, 40, inside=20)
    r2 = torch.from_numpy(r2)
    for n_max in (0, 1, 39):
        thr, sel, over = emulate(r2, None, n_max, GC1999_SQ, pad=3)
        want = reference_threshold(r2, None, n_max, GC1999_SQ)
        assert torch.equal(as_bits(thr), as_bits(want)), n_max
        assert (torch.equal(sel, cap_kernel.plain(r2, None, n_max,
                                                  GC1999_SQ)[0])), n_max


def identity_table(r):
    """A fused table whose product copies each record's weight: ``[r,
    k (k + 1)]`` with a 1 at ``(j, j)``."""
    k = 1
    while k * (k + 1) < r:
        k += 1
    fused = torch.zeros(r, k * (k + 1))
    fused[torch.arange(r), torch.arange(r)] = 1.0
    return fused, k


def selection_case(case):
    rng = np.random.default_rng(7)
    r = 301
    if case == "ties":
        r2, mask = adversarial(r), None
    elif case == "n_max_plus_1":
        r2, mask = cap_case(rng, 16, N_MAX + 1, inside=200)
    else:
        r2, mask = cap_case(rng, 32, r, inside=3 * N_MAX, masked=0.25)
        if case == "not_over":
            r2[::2] += np.float32(GC1999_SQ) * 0.8   # about 8 inside
        elif case == "all_masked":
            mask[:] = False
    r2 = torch.from_numpy(r2)
    return r2, (None if mask is None else torch.from_numpy(mask))


@pytest.mark.parametrize("case", ["masked", "not_over", "all_masked",
                                  "n_max_plus_1", "ties"])
def test_plain_selects_as_terms_from_r2(case):
    """:func:`cap_kernel.plain`'s ``sel`` and ``over`` against what
    ``terms_from_r2`` selected (read back through a table that copies each
    weight) and counted (``accumulate.cap_bound``, ``pairs_selected``),
    bit for bit, on the CPU path the kernel leaves as it was."""
    r2, mask = selection_case(case)
    c, r = r2.shape
    fused, k = identity_table(r)
    tracing.reset_counters()
    with tracing.record():
        a, g, count = dense.terms_from_r2(
            r2, fused, torch.ones(r, dtype=torch.int32), n_max=N_MAX,
            weight_function=WEIGHT_GAUSSIAN, row_mask=mask)
    got = tracing.counters()
    tracing.reset_counters()
    took = torch.cat([a, g[..., None]], -1).reshape(c, -1)[:, :r] > 0
    sel, over = cap_kernel.plain(r2, mask, N_MAX, GC1999_SQ)
    assert torch.equal(took, sel)
    assert torch.equal(count, sel.sum(1, dtype=torch.int32))
    assert got["accumulate.cap_bound"] == int(over.sum())
    assert got["accumulate.pairs_selected"] == int(sel.sum())
    assert "accumulate.cap_launches" not in got
    if case in ("not_over", "all_masked"):
        assert not over.all()
    if case in ("masked", "n_max_plus_1", "not_over"):
        assert over.any()


class CountCompares(TorchFunctionMode):
    """Counts the float32 elements compared by ``<=``."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (func in (torch.Tensor.__le__, torch.Tensor.le, torch.le)
                and args[0].dtype == torch.float32):
            self.n += out.numel()
        return out


@pytest.mark.parametrize("b,r", [(3, 31), (16, 400)])
def test_work_matches_a_brute_count(b, r):
    """Operations: the compares of the capped selection as
    ``terms_from_r2`` makes it (``_cap_threshold`` and ``r2 <= thr``);
    bytes: the plain version's inputs and outputs."""
    rng = np.random.default_rng(b)
    r2, mask = cap_case(rng, b, r, inside=2 * N_MAX, masked=0.1)
    r2, mask = torch.from_numpy(r2), torch.from_numpy(mask)
    with CountCompares() as counted:
        r2 <= dense._cap_threshold(r2, N_MAX, GC1999_SQ)[:, None]
    sel, over = cap_kernel.plain(r2, mask, N_MAX, GC1999_SQ)
    nbytes = sum(t.numel() * t.element_size() for t in (r2, mask, sel, over))
    assert cap_kernel.work(b, r) == (counted.n, nbytes)


@pytest.mark.parametrize("bad,match", [
    (lambda: torch.zeros(4, 40), "CUDA"),
    (lambda: torch.zeros(4, 40, dtype=torch.float64), "float32"),
    (lambda: torch.zeros(40, 4).T, "contiguous"),
    (lambda: torch.zeros(40), r"\[B, R\]"),
])
def test_launch_refuses_what_the_kernel_does_not_take(bad, match):
    with pytest.raises(ValueError, match=match):
        cap_kernel.launch(bad(), None, N_MAX, GC1999_SQ)


@pytest.mark.parametrize("kw,match", [
    (dict(splits=8), "splits"), (dict(rounds=7), "rounds"),
    (dict(r2_cap=float("inf")), "r2_cap"), (dict(r2_cap=-1.0), "r2_cap"),
])
def test_launch_refuses_other_search_settings(kw, match):
    args = {"r2_cap": GC1999_SQ, **kw}
    with pytest.raises(ValueError, match=match):
        cap_kernel.launch(torch.zeros(4, 40), None, N_MAX, **args)


def test_cpu_calls_keep_the_plain_search(monkeypatch):
    """``terms_from_r2`` on the CPU never reaches the kernel's wrapper."""
    def refuse(*args, **kw):
        raise AssertionError("the CPU path launched the kernel")

    monkeypatch.setattr(cap_kernel, "launch", refuse)
    r2, mask = selection_case("masked")
    fused, _ = identity_table(r2.shape[1])
    before = cap_kernel.LAUNCHES
    dense.terms_from_r2(r2, fused, torch.ones(r2.shape[1], dtype=torch.int32),
                        n_max=N_MAX, weight_function=WEIGHT_GAUSSIAN,
                        row_mask=mask)
    assert cap_kernel.LAUNCHES == before
