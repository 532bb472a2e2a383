"""K6, the selected-pair accumulation (``ops/select_kernel.py``,
``csrc/select_terms.cu``).

On the CPU: the kernel's per-point order (the point's selected records of
accepted observations in ascending order, each observed variable's
``s bg (x) [bg | omm]`` added in turn) emulated in float32 torch, held
against the dense product of ``dense.terms_from_r2`` within a float32
rounding bound scaled by the sum of the terms' magnitudes, counts exact; the
factors the plans keep rebuild the fused tables' rows, in record order and
in block order with padding; ``terms_from_r2`` on the CPU, in float64 or
uncapped never reaches the library; what ``launch`` refuses.  On a card
(``gpu``): the kernel against its plain version at the main path's shapes
and at the edges of its tiling and its list, without a sync, without
spills, and inside ``terms_from_r2`` and the fused cycle.  Imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_select_kernel.py -q
"""
import numpy as np
import pytest
import torch

from cwbnwp_letkf_torch import tracing
from cwbnwp_letkf_torch.config import MAX_VARS
from cwbnwp_letkf_torch.constants import GC1999_SQ
from cwbnwp_letkf_torch.localization import (WEIGHT_GAUSSIAN, WEIGHT_GC1999,
                                             gaspari_cohn_1999)
from cwbnwp_letkf_torch.obs.base import PlatformStatic
from cwbnwp_letkf_torch.ops import (cap_kernel, cuda_build, cycle, dense,
                                    select_kernel, update)
from cwbnwp_letkf_torch.ops.update import DevicePlatform
from cwbnwp_letkf_torch.ops.whiten import ObsStats

from .torch_parity import cap_case, select_stats, select_tolerance

F32 = torch.float32
N_MAX = 30
#: the vr platform's max_lz_pts
VR_N_MAX = 300


def assim_mask(v):
    """Every variable but the second assimilated (all of one)."""
    return tuple(i != 1 or v == 1 for i in range(v))


def weight(r2, weight_function):
    if weight_function == WEIGHT_GC1999:
        return gaspari_cohn_1999(torch.sqrt(r2))
    return torch.exp(-0.5 * r2)


def emulate(r2, sel, factors, nvalid, weight_function):
    """K6's terms in its order, a point at a time: the selected records of
    accepted observations in ascending order, and for each its observed
    variables in turn, ``acc += (s bg) (x) [bg | omm]`` with ``s = w e``.
    The kernel lists the records a segment of ``sel`` at a time and takes
    them out in batches; neither changes the order.  (It fuses each product
    and sum into one FMA, which this rounds twice.)"""
    bgo, e = factors
    c = r2.shape[0]
    v, k = bgo.shape[1], bgo.shape[2] - 1
    out = torch.zeros(c, k, k + 1)
    count = torch.zeros(c, dtype=torch.int32)
    for p in range(c):
        acc = torch.zeros(k, k + 1)
        picked = torch.nonzero(sel[p]).flatten()
        count[p] = int(nvalid[picked].sum())
        for j in picked.tolist():
            if nvalid[j] == 0:
                continue
            w = weight(r2[p, j], weight_function)
            for vv in range(v):
                u = (w * e[j, vv]) * bgo[j, vv, :k]
                acc = acc + u[:, None] * bgo[j, vv][None, :]
        out[p] = acc
    return out[:, :, :k], out[:, :, k], count


def assert_terms_close(got, want, tol):
    """``a`` and ``g`` within ``tol`` (:func:`.torch_parity.select_tolerance`:
    the bound for two orders of the sum), ``count`` equal."""
    k = tol.shape[1]
    for x, y, t in ((got[0], want[0], tol[:, :, :k]),
                    (got[1], want[1], tol[:, :, k])):
        gap = (x.double() - y.double()).abs()
        assert bool((gap <= t).all()), float((gap - t).max())
    assert torch.equal(got[2], want[2])


def select_case(rng, case, c, r, k, v, n_max=N_MAX):
    """``(r2, mask, stats, assim)``: distances of ``c`` points to ``r``
    records (about ``4 n_max`` within the cap), and the records'
    statistics; ``case`` "masked" (a fifth of the records masked),
    "empty_row" (the first point's records all beyond the cap),
    "all_masked" or "n_max_plus_1" (``r`` is ``n_max + 1``, none masked)."""
    if case == "n_max_plus_1":
        r = n_max + 1
    r2, mask = cap_case(rng, c, r, inside=4 * n_max, masked=0.2)
    if case == "n_max_plus_1":
        mask[:] = True                  # every record counts
    elif case == "empty_row":
        r2[0] += np.float32(2 * GC1999_SQ)
    elif case == "all_masked":
        mask[:] = False
    return (torch.from_numpy(r2), torch.from_numpy(mask),
            select_stats(rng, v, r, k), assim_mask(v))


CASES = ["masked", "empty_row", "all_masked", "n_max_plus_1"]


@pytest.mark.parametrize("weight_function", [WEIGHT_GAUSSIAN, WEIGHT_GC1999])
@pytest.mark.parametrize("k,v", [(40, 1), (96, 1), (40, 5), (96, 5)])
@pytest.mark.parametrize("case", CASES)
def test_emulated_kernel_matches_the_dense_product(case, k, v, weight_function):
    """The emulated kernel, and the plain version, against ``terms_from_r2``
    on the CPU (the dense product with the fused table) within the float32
    bound; counts exact; a point with nothing selected, or every record
    masked, gets exact zeros."""
    rng = np.random.default_rng(k + 10 * v + 100 * CASES.index(case))
    r2, mask, stats, assim = select_case(rng, case, 6, 400, k, v)
    fused, nvalid = dense.fused_platform_table(stats, assim)
    factors, = dense.pair_factors(stats, (assim,))
    want = dense.terms_from_r2(r2, fused, nvalid, n_max=N_MAX,
                               weight_function=weight_function, row_mask=mask)
    sel, over = cap_kernel.plain(r2, mask, N_MAX, GC1999_SQ)
    got = emulate(r2, sel, factors, nvalid, weight_function)
    tol = select_tolerance(r2, sel, factors, nvalid, weight_function)
    assert_terms_close(got, want, tol)
    assert_terms_close(select_kernel.plain(r2, sel, *factors, nvalid,
                                           weight_function), want, tol)
    if case == "all_masked":
        assert not sel.any() and not got[0].any() and not got[1].any()
    elif case == "empty_row":
        assert not sel[0].any() and not got[0][0].any()
        assert int(got[2][0]) == 0 and sel[1:].any()
    else:
        assert over.any() and got[2].sum() > 0


def test_emulation_adds_terms_for_accepted_records_only():
    """A record whose every observation is rejected adds nothing, however
    near: leaving it out of the list drops only zeros."""
    rng = np.random.default_rng(4)
    r2, mask, stats, assim = select_case(rng, "masked", 4, 300, 8, 2)
    fused, nvalid = dense.fused_platform_table(stats, assim)
    factors, = dense.pair_factors(stats, (assim,))
    assert (nvalid == 0).any()
    rows = fused[nvalid == 0]
    assert not rows.any()
    assert not factors.e[nvalid == 0].any()


def plan_platform(rng, v, r, k, name="vr"):
    """A port platform of ``r`` records with ``v`` observed variables, all
    assimilated into variable 0 (24 km, 3 km), none into variable 1."""
    h = (24.0,) + (-1.0,) * (MAX_VARS - 1)
    vc = (3.0,) + (-1.0,) * (MAX_VARS - 1)
    st = PlatformStatic(
        name=name, kind="radar", nvar=v, max_lz_pts=N_MAX, hclr=h, vclr=vc,
        err_muti=(1.0,) * v, err_rej=(3.0,) * v,
        is_assim=tuple((True,) + (False,) * (MAX_VARS - 1) for _ in range(v)))
    xyz = np.stack([rng.random(r) * 200e3, rng.random(r) * 200e3,
                    rng.random(r) * 10e3], 1).astype(np.float32)
    return DevicePlatform(static=st, xyz=torch.from_numpy(xyz),
                          stats=select_stats(rng, v, r, k), cache={})


@pytest.mark.parametrize("v", [1, 5])
@pytest.mark.parametrize("method", ["dense", "bucketed"])
def test_plan_factors_rebuild_the_fused_tables(method, v):
    """The factors a cycle plan keeps (record order on the dense path; block
    order with padding on the bucketed one, one ``bgo`` shared by the masks)
    multiply out to its fused tables' rows."""
    rng = np.random.default_rng(v)
    dp = plan_platform(rng, v, 700, 12)
    groups = [cycle.CycleGroup(ivars=(0,), inflats=(9.0,), rtpp_alpha=(0.0,),
                               rtps_alpha=(0.0,))]
    plan, = cycle._resolve_plans([dp], groups, max_blocks=8, method=method)
    if method == "dense":
        tables = []
        for m, nvalid in zip(plan.masks, plan.nvalid):
            fused, counts = update.dense_table(dp, m, F32)
            assert torch.equal(counts, nvalid)
            tables.append(fused)
        factors = plan.factors
    else:
        cb = plan.blocking
        tables = [f.reshape(cb.n_blocks * cb.block_size, -1)
                  for f in cb.fused_by_mask]
        factors = cb.factors_by_mask
        assert not cb.rec_mask.all()            # padding rows are there
        pad = ~cb.rec_mask.reshape(-1)
        assert not factors[0].bgo[pad].any() and not factors[0].e[pad].any()
    assert len(tables) == len(factors) == 1
    for fused, f in zip(tables, factors):
        assert f.bgo.shape == (fused.shape[0], v, 13)
        torch.testing.assert_close(dense.fused_rows(f), fused, rtol=1e-6,
                                   atol=1e-6)
        if v == 1:
            assert torch.equal(dense.fused_rows(f), fused)


@pytest.mark.parametrize("blocked", [False, True])
def test_factors_of_two_masks_share_bgo(blocked):
    """Two assimilation masks: one ``bgo``, their own ``e``, each rebuilding
    :func:`dense.fused_platform_table`'s rows in the same order and padding."""
    rng = np.random.default_rng(8)
    stats = select_stats(rng, 3, 90, 7)
    masks = ((True, False, True), (False, True, True))
    kw = {}
    if blocked:
        kw = dict(order=torch.from_numpy(rng.permutation(90)), pad_to=96)
    got = dense.pair_factors(stats, masks, **kw)
    assert got[0].bgo is got[1].bgo
    for m, f in zip(masks, got):
        fused, _ = dense.fused_platform_table(stats, m, **kw)
        torch.testing.assert_close(dense.fused_rows(f), fused, rtol=1e-6,
                                   atol=1e-6)


def test_selects_pairs_follows_the_input_alone():
    """K6 where the cap runs on a card with float32 factors; the product on
    the CPU, in float64, uncapped or without factors."""
    f32 = dense.PairFactors(torch.zeros(1, 1, 2), torch.zeros(1, 1))
    f64 = dense.PairFactors(*(x.double() for x in f32))
    cuda = torch.device("cuda")
    assert dense.selects_pairs(301, 300, F32, cuda, f32)
    assert not dense.selects_pairs(300, 300, F32, cuda, f32)
    assert not dense.selects_pairs(301, 300, torch.float64, cuda, f32)
    assert not dense.selects_pairs(301, 300, F32, cuda, f64)
    assert not dense.selects_pairs(301, 300, F32, cuda, None)
    assert not dense.selects_pairs(301, 300, F32, torch.device("cpu"), f32)


@pytest.mark.parametrize("inputs", ["cpu", "float64", "uncapped"])
def test_product_calls_never_load_the_library(monkeypatch, inputs):
    """``terms_from_r2`` given the factors on the CPU, in float64 or
    uncapped takes the dense product and never reaches K6's library."""
    def refuse(*args, **kw):
        raise AssertionError("a product call reached K6")

    monkeypatch.setattr(select_kernel, "launch", refuse)
    monkeypatch.setattr(select_kernel, "_load", refuse)
    monkeypatch.setattr(cuda_build, "load", refuse)
    rng = np.random.default_rng(6)
    r2, mask, stats, assim = select_case(rng, "masked", 5, 200, 6, 1)
    dtype = torch.float64 if inputs == "float64" else F32
    n_max = 1000 if inputs == "uncapped" else N_MAX
    fused, nvalid = dense.fused_platform_table(stats, assim, dtype=dtype)
    factors, = dense.pair_factors(stats, (assim,), dtype=dtype)
    before = select_kernel.LAUNCHES
    tracing.reset_counters()
    with tracing.record():
        a, g, count = dense.terms_from_r2(
            r2.to(dtype), fused, nvalid, n_max=n_max,
            weight_function=WEIGHT_GAUSSIAN, row_mask=mask, factors=factors)
    got = tracing.counters()
    tracing.reset_counters()
    assert select_kernel.LAUNCHES == before
    assert "accumulate.select_launches" not in got
    assert a.dtype == dtype and count.sum() > 0
    with pytest.raises(ValueError, match="fused table"):
        dense.terms_from_r2(r2.to(dtype), None, nvalid, n_max=n_max,
                            weight_function=WEIGHT_GAUSSIAN, factors=factors)


def launch_args(c=4, r=40, v=2, k=6):
    return dict(r2=torch.zeros(c, r), sel=torch.zeros(c, r, dtype=torch.bool),
                bgo=torch.zeros(r, v, k + 1), e=torch.zeros(r, v),
                nvalid=torch.zeros(r, dtype=torch.int32))


@pytest.mark.parametrize("bad,match", [
    (dict(), "CUDA"),
    (dict(r2=torch.zeros(4, 40, dtype=torch.float64)), "float32 r2"),
    (dict(sel=torch.zeros(4, 40, dtype=torch.uint8)), "bool sel"),
    (dict(nvalid=torch.zeros(40, dtype=torch.int64)), "int32 nvalid"),
    (dict(r2=torch.zeros(40)), r"\[C, R\]"),
    (dict(bgo=torch.zeros(41, 2, 7)), r"\[R, V, k\+1\]"),
    (dict(e=torch.zeros(40, 3)), "e of shape"),
    (dict(sel=torch.zeros(40, 4, dtype=torch.bool).T), "contiguous sel"),
    (dict(bgo=torch.zeros(40, 7, 2).transpose(1, 2)), "contiguous bgo"),
])
def test_launch_refuses_what_the_kernel_does_not_take(bad, match):
    args = {**launch_args(), **bad}
    with pytest.raises(ValueError, match=match):
        select_kernel.launch(weight_function=WEIGHT_GAUSSIAN, **args)


def test_work_counts_the_emulated_terms():
    """Operations: each summed (pair, variable)'s scalings and FMAs, as the
    emulation makes them; the production slab's chunk is about 11.4
    GFLOP."""
    rng = np.random.default_rng(12)
    r2, mask, stats, assim = select_case(rng, "masked", 5, 300, 9, 3)
    _, nvalid = dense.fused_platform_table(stats, assim)
    sel, _ = cap_kernel.plain(r2, mask, N_MAX, GC1999_SQ)
    pairs = int((sel & (nvalid > 0)[None]).sum())
    ops, nbytes = select_kernel.work(5, 300, 9, 3, pairs)
    assert ops == pairs * 3 * (9 + 2 * 9 * 10)
    assert nbytes == 5 * 300 + 4 * pairs + 4 * 300 * (3 * 11 + 1) + 4 * 5 * 91
    slab_ops, _ = select_kernel.work(2048, 14300, 96, 1, 2048 * 300)
    assert 11.4e9 < slab_ops < 11.6e9


# ------------------------------------------------------------------ on a card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def card_case(cuda, seed, c, r, k, v=1, masked=0.0, inside=1500,
              n_max=VR_N_MAX):
    """K6's inputs on the card: ``(r2, sel, factors, nvalid)`` with ``sel``
    from K5, and ``over``."""
    rng = np.random.default_rng(seed)
    r2, mask = cap_case(rng, c, r, inside, masked)
    stats = select_stats(rng, v, r, k)
    r2 = torch.from_numpy(r2).to(cuda)
    mask = None if mask is None else torch.from_numpy(mask).to(cuda)
    assim = assim_mask(v)
    _, nvalid = dense.fused_platform_table(stats, assim)
    factors, = dense.pair_factors(stats, (assim,))
    sel, over = cap_kernel.launch(r2, mask, n_max, GC1999_SQ)
    return (r2, sel, dense.PairFactors(*(x.to(cuda) for x in factors)),
            nvalid.to(cuda)), over


def assert_kernel_matches_plain(r2, sel, factors, nvalid, weight_function):
    """K6 against its plain version within the float32 bound, counts equal;
    one launch."""
    before = select_kernel.LAUNCHES
    got = select_kernel.launch(r2, sel, *factors, nvalid, weight_function)
    assert select_kernel.LAUNCHES == before + 1
    want = select_kernel.plain(r2, sel, *factors, nvalid, weight_function)
    assert_terms_close(got, want, select_tolerance(r2, sel, factors, nvalid,
                                                   weight_function))
    return got


#: (points, records, k, observed variables, masked share): the dense vr
#: platform's subchunk, the production slab's chunk with the record mask, and
#: k = 40 and 128
CARD_SHAPES = [(512, 6033, 96, 1, 0.0), (2048, 14300, 96, 1, 0.1),
               (512, 6033, 40, 1, 0.0), (256, 6033, 128, 1, 0.1)]


@pytest.mark.gpu
@pytest.mark.parametrize("c,r,k,v,masked", CARD_SHAPES)
def test_select_kernel_matches_plain(cuda, c, r, k, v, masked):
    (r2, sel, factors, nvalid), over = card_case(
        cuda, r + k, c, r, k, v, masked, inside=2000 if r > 10000 else 1500)
    assert over.any()
    got = assert_kernel_matches_plain(r2, sel, factors, nvalid,
                                      WEIGHT_GAUSSIAN)
    assert bool(torch.isfinite(got[0]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("weight_function", [WEIGHT_GAUSSIAN, WEIGHT_GC1999])
@pytest.mark.parametrize("k,v", [(1, 1), (15, 3), (16, 1), (17, 2), (96, 5),
                                 (127, 1), (129, 1), (177, 1), (191, 2),
                                 (192, 1), (200, 1), (24, 33)])
def test_select_kernel_tiles(cuda, k, v, weight_function):
    """Each side of a tile's edge (k and k + 1 a multiple of 16), the
    largest one-block tile (8 x 9), two to six blocks a point above k =
    128, many observed variables (a batch of one record)."""
    (r2, sel, factors, nvalid), _ = card_case(cuda, 7 * k + v, 37, 1031, k, v,
                                              masked=0.1, inside=400,
                                              n_max=N_MAX * 3)
    assert_kernel_matches_plain(r2, sel, factors, nvalid, weight_function)


@pytest.mark.gpu
@pytest.mark.parametrize("n_max,inside", [(0, 50), (1, 50), (1023, 3000),
                                          (1100, 3000), (5000, 9000)])
def test_select_kernel_lists(cuda, n_max, inside):
    """Selections from none to thousands a point: batches carried across
    the kernel's segments of 2,048 records, and more than a segment's
    records in a point's selection."""
    (r2, sel, factors, nvalid), _ = card_case(cuda, n_max, 20, 12000, 24,
                                              masked=0.1, inside=inside,
                                              n_max=n_max)
    assert int(sel.sum(1).max()) <= n_max
    if n_max >= 5000:
        assert int(sel.sum(1).max()) > 2048
    assert_kernel_matches_plain(r2, sel, factors, nvalid, WEIGHT_GAUSSIAN)


@pytest.mark.gpu
def test_select_kernel_rows_without_selection(cuda):
    """A point with nothing selected and a call with every record masked:
    zeros and count 0."""
    (r2, sel, factors, nvalid), _ = card_case(cuda, 5, 8, 700, 12)
    sel[0] = False
    a, g, count = assert_kernel_matches_plain(r2, sel, factors, nvalid,
                                              WEIGHT_GAUSSIAN)
    assert not a[0].any() and not g[0].any() and int(count[0]) == 0
    a, g, count = select_kernel.launch(r2, torch.zeros_like(sel), *factors,
                                       nvalid, WEIGHT_GAUSSIAN)
    assert not a.any() and not g.any() and not count.any()


@pytest.mark.gpu
def test_select_kernel_does_not_sync(cuda):
    """A launch under ``set_sync_debug_mode("error")`` raises nothing."""
    (r2, sel, factors, nvalid), _ = card_case(cuda, 2, 64, 6033, 96)
    select_kernel.launch(r2, sel, *factors, nvalid, WEIGHT_GAUSSIAN)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = select_kernel.launch(r2, sel, *factors, nvalid, WEIGHT_GAUSSIAN)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = select_kernel.launch(r2, sel, *factors, nvalid, WEIGHT_GAUSSIAN)
    for x, y in zip(got, want):
        assert torch.equal(x, y)   # the same order every run


@pytest.mark.gpu
def test_select_kernel_config_and_compiler_report(cuda):
    """Every instance without spills or a stack frame; one block a point up
    to k = 128, a 6 x 7 micro-tile at k = 96."""
    lib = cuda_build.build(select_kernel.SOURCE)[0]
    report = {name: res for name, res in cuda_build.resources(lib).items()
              if "select_terms_kernel" in name}
    assert len(report) == 17
    for res in report.values():
        assert res["spill_stores"] == res["spill_loads"] == 0, report
        assert res["stack"] == 0, report
    at96 = select_kernel.config(96)
    assert (at96["mr"], at96["mc"], at96["blocks_per_point"]) == (6, 7, 1)
    assert at96["blocks_per_sm"] >= 2, at96
    assert select_kernel.config(128)["blocks_per_point"] == 1
    assert select_kernel.config(177)["blocks_per_point"] == 2


@pytest.mark.gpu
def test_terms_from_r2_takes_k6_on_a_card(cuda):
    """The capped call with factors on a card is one K5 and one K6 launch,
    within the float32 bound of the dense product on the same card; traced,
    ``accumulate.select_launches`` counts it and the pair counters read as
    they do without it."""
    rng = np.random.default_rng(9)
    r2, mask = cap_case(rng, 256, 6033, 1500, 0.1)
    r2, mask = torch.from_numpy(r2).to(cuda), torch.from_numpy(mask).to(cuda)
    stats = select_stats(rng, 1, 6033, 96)
    fused, nvalid = (x.to(cuda) for x in dense.fused_platform_table(stats, (True,)))
    factors = dense.PairFactors(
        *(x.to(cuda) for x in dense.pair_factors(stats, ((True,),))[0]))
    before = select_kernel.LAUNCHES, cap_kernel.LAUNCHES
    counted = []
    for fac in (factors, None):
        tracing.reset_counters()
        with tracing.record():
            out = dense.terms_from_r2(r2, fused if fac is None else None,
                                      nvalid, n_max=VR_N_MAX,
                                      weight_function=WEIGHT_GAUSSIAN,
                                      row_mask=mask, factors=fac)
        counted.append((out, tracing.counters()))
        tracing.reset_counters()
    (got, with_k6), (want, without) = counted
    assert (select_kernel.LAUNCHES, cap_kernel.LAUNCHES) == (before[0] + 1,
                                                             before[1] + 2)
    assert with_k6.pop("accumulate.select_launches") == 1
    assert with_k6 == without
    sel, _ = cap_kernel.launch(r2, mask, VR_N_MAX, GC1999_SQ)
    assert_terms_close(got, want, select_tolerance(r2, sel, factors, nvalid,
                                                   WEIGHT_GAUSSIAN))


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["dense", "bucketed"])
def test_cycle_takes_k6_on_a_card(cuda, method):
    """The fused cycle on a card (its calls capped: K5 and K6) against the
    same cycle on the CPU (the dense product), within 5e-4 of the increment
    (``chip_smoke.XA_RTOL``: K1 against the CPU's solve)."""
    rng = np.random.default_rng(3)
    k, b = 24, 3000
    dp = plan_platform(rng, 1, 9000, k)
    dp_card = DevicePlatform(
        static=dp.static, xyz=dp.xyz.to(cuda),
        stats=ObsStats(*(x.to(cuda) for x in dp.stats)), cache={})
    pts = torch.from_numpy(np.stack([
        rng.random(b) * 200e3, rng.random(b) * 200e3, rng.random(b) * 10e3],
        1).astype(np.float32))
    xb = torch.from_numpy(rng.standard_normal((b, 1, k)).astype(np.float32))
    groups = [cycle.CycleGroup(ivars=(0,), inflats=((k - 1) / 1.1,),
                               rtpp_alpha=(0.0,), rtps_alpha=(0.0,))]
    kw = dict(weight_function=WEIGHT_GAUSSIAN, chunk=1024, subchunk=512,
              method=method, max_blocks=64)
    want = cycle.update_points_cycle(xb, pts, [dp], groups, **kw)
    before = select_kernel.LAUNCHES
    got = cycle.update_points_cycle(xb.to(cuda), pts.to(cuda), [dp_card],
                                    groups, **kw)
    assert select_kernel.LAUNCHES > before
    incr = float((want - xb).abs().max())
    assert incr > 0
    assert float((got.cpu() - want).abs().max()) <= 5e-4 * incr
