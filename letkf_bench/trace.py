"""The traced run: spans the benchmark wraps around program calls, and the
profiler's record read in process.

The profiler records the device's kernels, copies and fills, and on the host
the benchmark's spans (:func:`profiler`).  :func:`summarize` reduces that record, without writing
it out, to what the per-layer readers take: the device's busy intervals,
each kernel's time, the device time of the kernels launched inside each
span, and the idle gaps named by the span the host was in.
"""
from __future__ import annotations

import contextlib
import types
from collections import defaultdict
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

#: the span around each step of a traced window
STEP = "bench.step"


class Summary(NamedTuple):
    window_s: float                    # the traced steps' seconds
    busy_s: float                      # union of the device's intervals
    kernel_s: Dict[str, float]         # device seconds by operation name
    span_device_s: Dict[str, float]    # device seconds launched inside a span
    idle_s: Dict[str, float]           # idle device seconds by host span
    n_device_events: int
    n_unattributed: int                # device events with no host launch


def wrapped(fn, name: str):
    """``fn`` inside a profiler span ``name``."""
    def call(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return call


@contextlib.contextmanager
def patched(patches: Sequence[Tuple[object, str, object]]):
    """Set each ``(owner, attribute, value)`` for the block, then restore."""
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in patches]
    try:
        for owner, attr, value in patches:
            setattr(owner, attr, value)
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)


@contextlib.contextmanager
def profiler():
    """``torch.profiler``'s recorder over the block, holding the device's
    kernels, copies and fills and, on the host, the runtime's launches and
    the spans alone (``RecordScope.USER_SCOPE``): no operator of the
    program is recorded, which would cost each of a step's million
    launches several microseconds.  A device event's linked host event is
    then the innermost span open at its launch.  Yields a holder whose
    ``events`` are set when the block ends."""
    from torch._C._autograd import (_disable_profiler, _enable_profiler,
                                    _prepare_profiler)
    from torch._C._profiler import (ProfilerActivity, ProfilerConfig,
                                    ProfilerState, RecordScope,
                                    _ExperimentalConfig)

    acts = {ProfilerActivity.CPU}
    if torch.cuda.is_available():
        acts.add(ProfilerActivity.CUDA)
    config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False,
                            False, _ExperimentalConfig())
    _prepare_profiler(config, acts)
    _enable_profiler(config, acts, {RecordScope.USER_SCOPE})
    held = types.SimpleNamespace(result=None, events=())
    try:
        yield held
    finally:
        held.result = _disable_profiler()
        held.events = held.result.events()


def _union(intervals) -> np.ndarray:
    """Sorted disjoint ``[n, 2]`` union of ``(start, end)`` intervals."""
    if not len(intervals):
        return np.zeros((0, 2), np.int64)
    iv = np.asarray(sorted(intervals), np.int64)
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, len(iv) - 1)
    return np.stack([iv[first, 0], ends[last]], 1)


def _inside(t: np.ndarray, union: np.ndarray) -> np.ndarray:
    j = np.searchsorted(union[:, 0], t, side="right") - 1
    ok = j >= 0
    ok[ok] = t[ok] <= union[j[ok], 1]
    return ok


def _innermost(t: np.ndarray, spans: Dict[str, list]) -> List[str]:
    """The name of the latest-started span holding each time of the sorted
    ``t`` (spans of one thread nest), or ``"host"``."""
    ev = sorted((s, e, n) for n, ivs in spans.items() for s, e in ivs)
    out, stack, k = [], [], 0
    for x in t.tolist():
        while k < len(ev) and ev[k][0] <= x:
            while stack and stack[-1][1] < ev[k][0]:
                stack.pop()
            stack.append(ev[k])
            k += 1
        while stack and stack[-1][1] < x:
            stack.pop()
        out.append(stack[-1][2] if stack else "host")
    return out


def summarize(events, span_names: Sequence[str]) -> Summary:
    """Reduce a finished profile's events (module docstring).  A device
    event is attributed to a span when the innermost span open at its
    launch (the profiler's linked correlation) started inside the span, or,
    where the link is missing, when it ran inside the span's device
    range."""
    names = set(span_names) | {STEP}
    cpu_start: Dict[int, int] = {}
    spans: Dict[str, list] = defaultdict(list)
    mirrors: Dict[str, list] = defaultdict(list)
    dev_s, dev_e, dev_name, dev_link = [], [], [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in events:
        name = e.name()
        s = e.start_ns()
        if e.device_type() == cuda:
            if name in names:      # a span's range on the device timeline
                mirrors[name].append((s, s + e.duration_ns()))
            else:
                dev_s.append(s)
                dev_e.append(s + e.duration_ns())
                dev_name.append(name)
                dev_link.append(e.linked_correlation_id())
            continue
        if name in names:
            spans[name].append((s, s + e.duration_ns()))
        cpu_start[e.correlation_id()] = s
    d0 = np.asarray(dev_s, np.int64)
    d1 = np.asarray(dev_e, np.int64)
    dur = (d1 - d0) * 1e-9
    kernel_s: Dict[str, float] = defaultdict(float)
    for n, t in zip(dev_name, dur.tolist()):
        kernel_s[n] += t
    launch = np.asarray([cpu_start.get(x, -1) for x in dev_link], np.int64)
    linked = launch >= 0
    span_s = {}
    for sn in names:
        hit = np.where(linked, _inside(launch, _union(spans[sn])),
                       _inside(d0, _union(mirrors[sn])))
        span_s[sn] = float(dur[hit].sum())
    steps = _union(spans[STEP])
    if not len(steps):
        return Summary(0.0, 0.0, dict(kernel_s), span_s, {}, len(d0),
                       int((~linked).sum()))
    busy_all = _union(list(zip(d0.tolist(), d1.tolist())))
    busy_s, g0, g1 = 0, [], []
    for a, b in steps.tolist():
        lo = np.searchsorted(busy_all[:, 1], a, side="right")
        hi = np.searchsorted(busy_all[:, 0], b, side="left")
        iv = np.clip(busy_all[lo:hi], a, b)
        busy_s += int((iv[:, 1] - iv[:, 0]).sum())
        edges = np.concatenate([[a], iv.ravel(), [b]])
        g0.append(edges[0::2])
        g1.append(edges[1::2])
    g0, g1 = np.concatenate(g0), np.concatenate(g1)
    gap = g1 > g0
    g0, g1 = g0[gap], g1[gap]
    idle: Dict[str, float] = defaultdict(float)
    for n, t in zip(_innermost((g0 + g1) // 2, spans),
                    ((g1 - g0) * 1e-9).tolist()):
        idle[n] += t
    return Summary(window_s=float((steps[:, 1] - steps[:, 0]).sum()) * 1e-9,
                   busy_s=busy_s * 1e-9, kernel_s=dict(kernel_s),
                   span_device_s=span_s, idle_s=dict(idle),
                   n_device_events=len(d0),
                   n_unattributed=int((~linked).sum()))
