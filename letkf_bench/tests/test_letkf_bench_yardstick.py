"""The yardstick's arithmetic on the CPU: the roofline's operation count
against a brute count, the profiler reduction on a made-up record, and the
readers that find nothing to read."""
import types

import pytest
import torch

from letkf_bench import roofline, run, trace


@pytest.mark.parametrize("b,k", [(3, 8), (5, 40)])
def test_ns_work_counts_what_the_iteration_multiplies(b, k):
    """``ns_invsqrt_work`` against the products the plain Newton-Schulz
    iteration runs, counted by torch's flop counter."""
    from torch.utils.flop_counter import FlopCounterMode

    from cwbnwp_letkf_torch.ops.solver import ns_invsqrt

    torch.manual_seed(0)
    y = torch.randn(b, k, 3 * k)
    a = y @ y.transpose(1, 2) / k
    with FlopCounterMode(display=False) as count:
        _, steps, _ = ns_invsqrt(a, 1.0, return_info=True)
    flop, nbytes = roofline.ns_invsqrt_work(b, k, steps * b)
    assert flop == count.get_total_flops()
    assert nbytes == 2 * 4 * k * k * b


def test_least_time_is_the_larger_bound():
    assert roofline.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.least_seconds(67e12, 6.7e12) == pytest.approx(2.0)


class Event:
    def __init__(self, name, start, dur, dev=False, corr=0, link=0):
        self._v = (name, start, dur, dev, corr, link)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._v[3]
                else torch.autograd.DeviceType.CPU)

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def test_summarize_a_made_up_record():
    ns = 1_000_000_000
    ev = [Event(trace.STEP, 0, 10 * ns, corr=1),
          Event("acc", 1 * ns, 4 * ns, corr=2),
          # launched inside "acc": 3 s; launched outside it: 2 s (each
          # linked to the innermost span open at its launch)
          Event("gemm", 2 * ns, 3 * ns, dev=True, corr=9, link=2),
          Event("add", 7 * ns, 2 * ns, dev=True, corr=10, link=1),
          # no launching span: inside acc's device range
          Event("acc", 2 * ns, 3 * ns, dev=True),
          Event("k1", 3 * ns, 1 * ns, dev=True),
          # outside the step: not busy time of the window
          Event("late", 11 * ns, 1 * ns, dev=True)]
    s = trace.summarize(ev, ["acc"])
    assert s.window_s == pytest.approx(10.0)
    assert s.busy_s == pytest.approx(5.0)      # [2, 5] and [7, 9]
    assert s.span_device_s["acc"] == pytest.approx(4.0)   # gemm and k1
    assert s.kernel_s == pytest.approx({"gemm": 3.0, "add": 2.0, "k1": 1.0,
                                        "late": 1.0})
    # idle: [0, 2] at 1 s (acc starts at 1) -> acc; [5, 7] -> the step;
    # [9, 10] -> the step
    assert s.idle_s == pytest.approx({"acc": 2.0, trace.STEP: 3.0})
    assert s.n_unattributed == 2


def test_readers_return_nothing_where_nothing_was_read():
    ctx = types.SimpleNamespace(
        steps=[(1.0, 10)], counters={}, data={},
        trace=trace.Summary(window_s=1.0, busy_s=0.0, kernel_s={},
                            span_device_s={}, idle_s={}, n_device_events=0,
                            n_unattributed=0))
    for name in ("driver.load_share", "cycle.accumulate_device_share",
                 "ns_invsqrt_roofline", "device.idle_share"):
        assert run.reader(name).read(ctx) is None, name
    assert run.reader("analysis_var_gridpoint_updates_per_s").read(ctx) == 10


def test_an_undecided_outlier_test_gives_both_answers():
    """A record whose outlier test float32 cannot decide is taken both ways:
    two variants, the float64 one primary, each with its own count."""
    from letkf_bench.reference import letkf as ref

    k = 4
    hdxb = torch.tensor([[[0.0, 1.0, -1.0, 0.0],
                          [0.5, -0.5, 0.2, -0.2]]], dtype=torch.float64)
    spread = float(torch.sqrt((hdxb - hdxb.mean(-1, keepdim=True))
                              .pow(2).sum(-1)[0, 0] / (k - 1)))
    thr = (spread ** 2 + 1.0) ** 0.5 * 3.0
    obs = torch.tensor([[thr * (1 - 1e-7), 0.3]], dtype=torch.float64)
    plat = ref.platform(
        "synop", torch.tensor([[0.0, 0.0, 0.0], [1e3, 0.0, 0.0]]), obs,
        torch.ones(1, 2), torch.zeros(1, 2, k), hdxb, err_muti=[1.0],
        err_rej=[3.0], max_lz_pts=10, hclr=[50.0], vclr=[-1.0],
        assim=[[True]])
    assert plat.unsure[0, 0] and not plat.unsure[0, 1]
    terms = ref.local_terms(torch.zeros(1, 3, dtype=torch.float64), [plat],
                            0, 0)
    assert terms.a.shape[1] == 2 and terms.feasible.all()
    assert sorted(terms.count[0].tolist()) == [1.0, 2.0]
    assert terms.count[0, int(terms.primary[0])] == 2.0   # float64 keeps it
