"""The port's spans and counters (``cwbnwp_letkf_torch.tracing``).

On the CPU: with no profiler recording nothing is entered or kept; under a
CPU profiler recording the program's spans alone (``RecordScope.
USER_SCOPE``, as the benchmark's traced run and ``maybe_trace`` record) a
fused cycle, with a dense and a bucketed platform, and a whole
``run_analysis`` record every span, nested as the layers are (the labels
on the program's own stack alone), and give the untraced analyses bit for
bit; the accumulation's counters equal counts made from
``terms_from_r2``'s own distances; with the syncs watched a stand-in
sync warning is counted under the innermost span, and left alone without.
On a card (``gpu``): a pageable copy each way counts one sync in its span,
none is counted untraced or not watched, and the sync-debug mode is
restored.  Imports no JAX.
"""
import contextlib
import dataclasses
import json
import types
import warnings

import numpy as np
import pytest
import torch

from cwbnwp_letkf_torch import config, driver, tracing
from cwbnwp_letkf_torch.constants import GC1999_SQ
from cwbnwp_letkf_torch.models import state
from cwbnwp_letkf_torch.obs import base
from cwbnwp_letkf_torch.obs.synthetic import (correlated_ensemble,
                                              idealized_grid,
                                              synthetic_gts_platform)
from cwbnwp_letkf_torch.ops import cycle, dense, update
from cwbnwp_letkf_torch.projection import LambertProjection

from .torch_parity import GROUPS_SPEC, K_CYCLE, group_fields
from .wrf_fixtures import make_wrf_ensemble

CHUNK, SUB = 512, 128

#: the program's spans (recorded on the profiler) and labels (on its own
#: stack alone), each with the spans or labels it opens inside
SPANS = {
    "cycle.plan": (None, "driver.analysis"),
    "cycle.update": (None, "driver.analysis"),
    "cycle.accumulate_chunk": ("cycle.update",),
    "accumulate.cull": ("cycle.accumulate_chunk",),
    "accumulate.cap": ("cycle.accumulate_chunk",),
    "accumulate.matmul": ("cycle.accumulate_chunk",),
    "solver.solve": ("cycle.update",),
    "driver.prepare": ("driver.analysis",),
    "driver.load": ("driver.analysis",),
    "driver.store": ("driver.analysis",),
    "solver.tune_q": ("driver.analysis",),
}
LABELS = {
    "driver.analysis": (None,),
    "cycle.resolve": ("cycle.plan", "cycle.update"),
    "driver.h2d": ("driver.analysis",),
    "driver.d2h": ("driver.analysis",),
    "accumulate.distance": ("cycle.accumulate_chunk",),
    "accumulate.weights": ("cycle.accumulate_chunk",),
    "accumulate.sum": ("cycle.accumulate_chunk",),
    "tracing.count": ("cycle.accumulate_chunk",),
    "solver.ns": ("solver.solve",),
    "solver.apply": ("solver.solve",),
    "solver.relax": ("solver.solve",),
}
#: those of a cycle call, and those a synop-only analysis adds (no cull)
CYCLE = {n for n in {**SPANS, **LABELS}
         if not n.startswith("driver.") and n not in ("solver.tune_q",)}
DRIVER = (CYCLE - {"accumulate.cull"}) | {
    n for n in {**SPANS, **LABELS} if n.startswith("driver.")} | {
    "solver.tune_q"}

NML = """
&control
 nmember          = 4
 var_update       = 'T', 'P', 'QVAPOR', 'W'
 weight_function  = 0
 wrf_mp_physics   = 4
/
&projection
 cen_lon  = 120.0
 cen_lat  = 23.7
 truelat1 = 10.0
 truelat2 = 40.0
 sta_lon  = 120.0
/
&observations
 synop_nml % use_it     = T
 synop_nml % max_lz_pts = 10
 synop_nml % hclr       = 30., 30., 30., 30.
 synop_nml % vclr       =  3.,  3.,  3.,  3.
 synop_nml % u % is_assim = T, T, T, T
 synop_nml % v % is_assim = T, T, T, T
 synop_nml % t % is_assim = T, T, T, T
 synop_nml % q % is_assim = T, T, T, T
/
&inflation
 multi_infl = 1.2, 1.1, 1.3, 1.2
/
"""


@contextlib.contextmanager
def recording():
    """:func:`tracing.record` on the CPU; yields a holder whose ``events``,
    ``(name, start, end)`` of each recorded event, are set when the block
    ends."""
    held = types.SimpleNamespace(events=())
    with tracing.record() as rec:
        yield held
    held.events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in rec.result.events()]


@contextlib.contextmanager
def watched():
    """The syncs counted over the block (:func:`tracing.watch_syncs`)."""
    was = tracing.watch_syncs(True)
    try:
        yield
    finally:
        tracing.watch_syncs(was)


@pytest.fixture
def entered(monkeypatch):
    """``(name, the innermost open span or label)`` of every span and label
    entered."""
    seen = []
    enter = tracing._Label.__enter__

    def note(self):
        seen.append((self.name, tracing._STATE.stack[-1]
                     if tracing._STATE.stack else None))
        return enter(self)

    monkeypatch.setattr(tracing._Label, "__enter__", note)
    return seen


def assert_nested(events, seen, expected):
    """The spans and labels ``expected`` were entered, each inside one it
    may open inside; the spans, and no label, were recorded, each inside
    the recorded span around it."""
    assert {n for n, _ in seen} == expected
    parents = {**SPANS, **LABELS}
    for name, parent in seen:
        assert parent in parents[name], (name, parent)
    by_name = {}
    for name, s, e in events:     # a card's profiler adds its runtime calls
        if name in parents:
            by_name.setdefault(name, []).append((s, e))
    assert set(by_name) == expected & set(SPANS)
    for name in by_name:
        outer = [iv for n, p in set(seen) if n == name and p in SPANS
                 for iv in by_name[p]]
        for s, e in by_name[name] if outer else ():
            assert any(ps <= s and e <= pe for ps, pe in outer), name


@pytest.fixture(scope="module")
def cycle_inputs():
    """tests/torch_parity.cycle_case at 16 x 16 x 4 points from the port's
    generators: synop 300 (dense), vr 9000 (bucketed), a group no platform
    feeds; two chunks of four subchunks."""
    rng = np.random.default_rng(3)
    pts = idealized_grid(16, 16, 4, dx_m=50e3)
    truth, xb = correlated_ensemble(rng, pts, K_CYCLE, n_bumps=6,
                                    length_m=2e5)
    plats = []
    for name, nobs, nvar, cap, err in (("synop", 300, 5, 40, 0.5),
                                       ("vr", 9000, 1, 60, 1.0)):
        st0, po = synthetic_gts_platform(
            rng, pts, truth, xb, name=name, nobs=nobs, nvar=nvar,
            obs_err=err, max_lz_pts=cap, extent_frac=1.0)
        h = [-1.0] * len(st0.hclr)
        v = [-1.0] * len(st0.vclr)
        for ivars, rmap in GROUPS_SPEC:
            for iv in ivars:
                if name in rmap:
                    h[iv], v[iv] = rmap[name]
        st = dataclasses.replace(st0, hclr=tuple(h), vclr=tuple(v))
        plats.append(update.prepare_platform(st, po, device="cpu"))
    assert plats[1].xyz.shape[0] >= update.BUCKET_MIN_RECORDS
    v_tot = sum(len(ivars) for ivars, _ in GROUPS_SPEC)
    xb_v = np.stack([xb * (1.0 + 0.03 * vi) for vi in range(v_tot)], 1)
    return torch.from_numpy(pts), torch.from_numpy(xb_v), plats


def run_cycle(inputs):
    q, xb, plats = inputs
    groups = [cycle.CycleGroup(*f) for f in group_fields()]
    budgets = cycle.plan_cycle_budgets(q, plats, groups, chunk=CHUNK,
                                       subchunk=SUB)
    return cycle.update_points_cycle(
        xb, q, plats, groups, weight_function=0, chunk=CHUNK, subchunk=SUB,
        max_blocks=budgets)


@pytest.fixture(scope="module")
def driver_inputs(tmp_path_factory):
    """tests/test_torch_driver.py's case with a cap of 10 of 25 synop
    records: member files, config and observations."""
    d = tmp_path_factory.mktemp("tracing")
    paths = make_wrf_ensemble(str(d), 4, seed=7)
    cfg = config.LetkfConfig.from_namelist(NML)
    proj = LambertProjection.from_config(cfg.projection)
    rng = np.random.default_rng(11)
    nobs = 25
    x, y = proj.lonlat_to_xy(rng.uniform(119.85, 120.15, nobs),
                             rng.uniform(23.55, 23.85, nobs))
    xyz = np.stack([x, y, rng.uniform(0.0, 5e3, nobs)], 1)
    obs = rng.normal(0.0, 2.0, (5, nobs))
    hdxb = obs[:, :, None] + rng.normal(0.0, 1.0, (5, nobs, 4))
    err = rng.uniform(0.5, 1.5, (5, nobs))
    return cfg, paths, {"synop": base.make_platform_obs(xyz, obs, hdxb, err)}


def run_driver(inputs):
    cfg, paths, obs = inputs
    ens = state.read_ensemble(paths, cfg)
    driver.run_analysis(cfg, ens, obs, chunk=128, device="cpu")
    return {name: a.copy() for name, a in ens.fields.items()}


def test_untraced_a_span_is_one_shared_no_op(cycle_inputs, monkeypatch):
    """With no profiler, a fused cycle enters no span and keeps nothing."""
    assert not tracing.on()
    assert tracing.span("a") is tracing.span("b")
    tracing.reset_counters()
    before = tracing.counters()

    def refuse(self, name):
        raise AssertionError(f"span {name} entered with no profiler")

    monkeypatch.setattr(tracing._Label, "__init__", refuse)
    run_cycle(cycle_inputs)
    tracing.count("accumulate.pairs", 3)
    tracing.count_sync()
    assert tracing.counters() == before == {"host.syncs": 0,
                                            "host.syncs_by_span": {}}
    assert tracing._STATE.stack == [] and tracing._STATE.saved is None


def test_a_traced_cycle_records_every_span_nested(cycle_inputs, entered):
    plain = run_cycle(cycle_inputs)
    assert not entered
    with recording() as rec:
        traced = run_cycle(cycle_inputs)
    assert torch.equal(traced, plain)
    assert_nested(rec.events, entered, CYCLE)
    assert tracing._STATE.stack == [] and tracing._STATE.saved is None


def test_a_traced_analysis_records_the_driver_spans(driver_inputs, entered):
    plain = run_driver(driver_inputs)
    with recording() as rec:
        traced = run_driver(driver_inputs)
    assert all(np.array_equal(traced[n], plain[n]) for n in plain)
    assert_nested(rec.events, entered, DRIVER)


def test_the_accumulation_counters_count_what_terms_from_r2_took(
        cycle_inputs, monkeypatch):
    """``pairs``, ``pairs_selected``, ``cap_points`` and ``cap_bound``
    against counts from each ``terms_from_r2`` call's own distances, row
    mask and cap threshold."""
    calls, thresholds = [], []
    terms, cap = cycle.terms_from_r2, dense._cap_threshold

    def seen_terms(r2, fused, nvalid, *, n_max, row_mask=None, **kw):
        calls.append((r2.clone(), row_mask, n_max))
        return terms(r2, fused, nvalid, n_max=n_max, row_mask=row_mask, **kw)

    def seen_cap(*args, **kw):
        out = cap(*args, **kw)
        thresholds.append(out)
        return out

    monkeypatch.setattr(cycle, "terms_from_r2", seen_terms)
    monkeypatch.setattr(dense, "_cap_threshold", seen_cap)
    tracing.reset_counters()
    with recording():
        run_cycle(cycle_inputs)
    got = tracing.counters()
    pairs = selected = cap_points = cap_bound = 0
    thresholds = iter(thresholds)
    for r2, row_mask, n_max in calls:
        if row_mask is not None:
            r2 = torch.where(row_mask[None, :], r2, float("inf"))
        r2 = r2.numpy()
        c, r = r2.shape
        inside = (r2 <= GC1999_SQ).sum(1)
        pairs += c * r
        if r > n_max:
            t = next(thresholds).numpy()
            took = (r2 <= t[:, None]).sum(1)
            assert (took <= np.minimum(inside, n_max)).all()
            cap_points += c
            cap_bound += int((inside > n_max).sum())
        else:
            took = inside
        selected += int(took.sum())
    assert next(thresholds, None) is None
    assert cap_points and cap_bound and selected < pairs
    assert got == {"accumulate.pairs": pairs,
                   "accumulate.pairs_selected": selected,
                   "accumulate.cap_points": cap_points,
                   "accumulate.cap_bound": cap_bound,
                   "host.syncs": 0, "host.syncs_by_span": {}}
    tracing.reset_counters()
    assert tracing.counters() == {"host.syncs": 0, "host.syncs_by_span": {}}


@pytest.mark.parametrize("watch", [True, False])
def test_a_sync_is_counted_under_the_innermost_span(watch):
    """Watched, a stand-in for the card's sync-debug warning, and an
    explicit :func:`tracing.count_sync`, each charged to the innermost open
    span; other warnings pass on; the filters are restored when the
    outermost span closes.  Not watched, the spans leave the warnings alone
    and count nothing."""
    stand_in = tracing.SYNC_WARNING + " (stand-in)"
    tracing.reset_counters()
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("always")
        filters = list(warnings.filters)
        with recording(), (watched() if watch else contextlib.nullcontext()):
            warnings.warn(stand_in)               # no span open: not counted
            with tracing.span("outer"):
                warnings.warn(stand_in)
                with tracing.span("inner"):
                    warnings.warn(stand_in)
                    warnings.warn("another warning")
                    tracing.count_sync()
                    warnings.warn(stand_in)
            assert warnings.filters == filters
            assert tracing._STATE.saved is None
        assert [str(w.message) for w in shown] == (
            [stand_in, "another warning"] if watch else
            [stand_in] * 3 + ["another warning", stand_in])
    assert not tracing._STATE.watching
    assert tracing.counters() == (
        {"host.syncs": 4, "host.syncs_by_span": {"outer": 1, "inner": 3}}
        if watch else {"host.syncs": 0, "host.syncs_by_span": {}})
    tracing.reset_counters()


def test_maybe_trace_writes_the_spans_and_the_counters(cycle_inputs,
                                                      tmp_path):
    with tracing.maybe_trace(None):
        assert not tracing.on()
    with tracing.maybe_trace(str(tmp_path)):
        assert tracing.on()
        run_cycle(cycle_inputs)
    assert not tracing.on()
    (trace,) = tmp_path.glob("trace_*.json")
    (counts,) = tmp_path.glob("counters_*.json")
    assert trace.name[6:] == counts.name[9:]
    names = {e.get("name") for e in json.loads(trace.read_text())
             ["traceEvents"]}
    assert CYCLE & set(SPANS) <= names and not names & set(LABELS)
    got = json.loads(counts.read_text())
    assert got["accumulate.pairs"] > got["accumulate.pairs_selected"] > 0
    assert got["host.syncs"] == 0


@pytest.mark.gpu
def test_a_pageable_copy_counts_one_sync_in_its_span():
    """On a card: ``torch.tensor(..., device=cuda)`` and ``x.cpu()`` count
    one sync each in their span, an explicit synchronize once through the
    driver, nothing untraced or not watched; the sync-debug mode is
    restored."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    mode = torch.cuda.get_sync_debug_mode()
    x = torch.ones(4, device=dev)
    tracing.reset_counters()
    torch.tensor(1.0, device=dev)
    x.cpu()
    with recording(), tracing.span("not watched"):
        assert torch.cuda.get_sync_debug_mode() == mode
        torch.tensor(1.0, device=dev)
        x.cpu()
    assert tracing.counters()["host.syncs"] == 0
    with recording(), watched():
        with tracing.span("h2d"):
            assert torch.cuda.get_sync_debug_mode() == 1
            torch.tensor(1.0, device=dev)
        with tracing.span("d2h"):
            x.cpu()
        with tracing.span("launch"):
            (x * 2).sum()
        with tracing.span("explicit"):
            driver._sync(dev)
        assert torch.cuda.get_sync_debug_mode() == mode
    assert tracing.counters()["host.syncs_by_span"] == {
        "h2d": 1, "d2h": 1, "explicit": 1}
    assert torch.cuda.get_sync_debug_mode() == mode
    tracing.reset_counters()
