"""The readers of the program's own spans and counters, on the CPU: each
returns nothing where nothing was read (a program without the span or the
counter, or an empty record), and reads a made-up record right; and a
traced run of a tiny cell reports the counters the program kept."""
import types

import pytest

from letkf_bench import counters, run, trace

SPANS = {"accumulate.cap_device_share": "accumulate.cap",
         "accumulate.cull_device_share": "accumulate.cull",
         "accumulate.matmul_device_share": "accumulate.matmul"}
COUNTERS = ("accumulate.selected_pair_share", "accumulate.cap_bound_share",
            "host.syncs_per_step")


def summary(**kw):
    base = dict(window_s=0.0, busy_s=0.0, kernel_s={}, span_device_s={},
                idle_s={}, n_device_events=0, n_unattributed=0)
    return trace.Summary(**dict(base, **kw))


def context(steps=((1.0, 10),), tr=None):
    return types.SimpleNamespace(steps=list(steps), counters={}, data={},
                                 trace=tr or summary())


def program(monkeypatch, totals):
    """A program whose ``tracing.counters()`` are ``totals`` (None: a
    program without them)."""
    fake = None if totals is None else types.SimpleNamespace(
        counters=lambda: dict(totals), reset_counters=lambda: None,
        watch_syncs=lambda flag: False)
    monkeypatch.setattr(counters, "_tracing", lambda: fake)


@pytest.mark.parametrize("name", sorted(SPANS))
def test_a_span_reader(name):
    mod = run.reader(name)
    assert mod.SPAN == SPANS[name]
    assert not hasattr(mod, "install")   # the profiler turns spans on
    assert mod.read(context()) is None
    # the span's kernels but no busy time, busy time but not the span
    assert mod.read(context(tr=summary(span_device_s={SPANS[name]: 1.0}))) \
        is None
    assert mod.read(context(tr=summary(busy_s=4.0))) is None
    got = mod.read(context(tr=summary(busy_s=4.0, span_device_s={
        SPANS[name]: 1.0, "cycle.accumulate_chunk": 3.0})))
    assert got == pytest.approx(25.0)


@pytest.mark.parametrize("name", COUNTERS)
def test_a_counter_reader_reads_nothing_without_the_counters(name,
                                                             monkeypatch):
    mod = run.reader(name)
    program(monkeypatch, None)
    assert mod.install(context()) == []
    assert mod.read(context()) is None
    program(monkeypatch, {"host.syncs": 0, "host.syncs_by_span": {}})
    ctx = context(steps=())
    mod.install(ctx)
    assert mod.read(ctx) is None


def test_the_counter_readers_read_a_made_up_record(monkeypatch, capsys):
    program(monkeypatch, {
        "accumulate.pairs": 1000, "accumulate.pairs_selected": 40,
        "accumulate.cap_points": 50, "accumulate.cap_bound": 5,
        "host.syncs": 30,
        "host.syncs_by_span": {"accumulate.distance": 24, "solver.relax": 6}})
    ctx = context(steps=[(1.0, 10), (1.0, 10), (1.0, 10)])
    got = {}
    for name in COUNTERS:
        mod = run.reader(name)
        assert mod.install(ctx) == []
        got[name] = mod.read(ctx)
    assert got == pytest.approx({"accumulate.selected_pair_share": 4.0,
                                 "accumulate.cap_bound_share": 10.0,
                                 "host.syncs_per_step": 10.0})
    out = capsys.readouterr().out
    assert "'accumulate.distance': 24, 'solver.relax': 6" in out


def test_install_clears_the_program_counters():
    from cwbnwp_letkf_torch import tracing

    with tracing.span("x"):       # no profiler: nothing is kept
        tracing.count("accumulate.pairs", 5)
    tracing._STATE.ints["accumulate.pairs"] = 5
    run.reader("accumulate.selected_pair_share").install(context())
    assert "accumulate.pairs" not in tracing.counters()


def test_a_traced_tiny_cell_reports_the_program_counters():
    """The radar cell at a tiny size on the CPU, traced: the counters the
    program kept over the window, no device share (no device)."""
    from letkf_bench.tests.test_letkf_bench_cells import go

    out = go("full96.radar_gts", trace=True)
    assert out["correct"]
    m = out["metrics"]
    assert 0 < m["accumulate.selected_pair_share"]["value"] < 100
    assert 0 <= m["accumulate.cap_bound_share"]["value"] <= 100
    assert m["host.syncs_per_step"] == {"value": 0.0, "unit": "syncs/step"}
    assert not set(SPANS) & set(m)
