"""Spans, labels and counters inside the port, on only while a profiler
records.

The port's layers name their work with :func:`span` / :func:`spanned`
(``driver.load``, ``cycle.accumulate_chunk``, ``accumulate.cap``, ...) and
:func:`label` / :func:`labelled` (``accumulate.distance``, ``solver.ns``,
...), and count it with :func:`count`.  While no ``torch.profiler``
records, both return one shared no-op context and nothing is kept: a span
costs one C call and a ``with``.  While one records:

* a span is a ``torch.profiler.record_function`` (``RecordScope.
  USER_SCOPE``), on the profiler's clock with the device's kernels and
  copies.  The profiler also gives it a range on the device, from the first
  to the last kernel launched while it is the innermost span: a span nested
  in another must leave kernels of the outer one before and after it, or
  the outer range no longer holds its work.  So the spans are the layers'
  boundaries and the accumulation's cull, cap search and matmul, whose
  ``accumulate_chunk`` starts with fills and ends with sums;
* a label records nothing on the profiler; it names the host's work for
  the syncs made inside it (below);
* :func:`count` adds to a counter, a host int or a 0-d device tensor kept
  on its device and summed only when read (:func:`counters`), so the timed
  path gains no synchronisation.  Counter work that launches kernels runs
  after its layer's span closes, under the label ``tracing.count``: its
  kernels fall in the enclosing span's device range and in no layer's
  inside it;
* after :func:`watch_syncs` (off by default: it costs a Python warning a
  sync), every synchronisation the host makes with the card is counted
  under the innermost open span or label (``host.syncs``): while one is
  open, CUDA's sync-debug mode is ``"warn"`` and its warnings are taken
  here and not shown; the explicit ``torch.cuda.synchronize`` calls, which
  that mode does not flag, are counted by :func:`count_sync`.  When the
  outermost closes, the process's sync-debug mode and warning filters are
  what they were.

:func:`record` records a region with the program's spans and the device
alone; :func:`maybe_trace` (the CLI's ``--profile-dir``) does so with the
syncs counted and writes the Chrome trace and the counters.  The state is
the process's, as the profiler's is: one thread runs the spans.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import time
import types
import warnings
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

#: the start of the warning CUDA's sync-debug mode raises at a sync
SYNC_WARNING = "called a synchronizing CUDA operation"

_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


class _State:
    """What the spans and counters keep between :func:`reset_counters`
    calls."""

    def __init__(self):
        self.stack: List[str] = []        # open spans/labels, innermost last
        self.ints: Dict[str, int] = defaultdict(int)
        self.tensors: Dict[Tuple[str, torch.device], torch.Tensor] = {}
        self.syncs: Dict[str, int] = defaultdict(int)
        self.watching = False             # syncs counted (watch_syncs)
        self.saved = None                 # (catch_warnings, sync-debug mode)


_STATE = _State()


def on() -> bool:
    """Whether a profiler records, so that spans and counters are kept."""
    return _profiling()


class _Label:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if not _STATE.stack and _STATE.watching:
            _watch_syncs()
        _STATE.stack.append(self.name)
        return self

    def __exit__(self, *exc):
        _STATE.stack.pop()
        if not _STATE.stack and _STATE.saved is not None:
            _unwatch_syncs()
        return False


class _Span(_Label):
    __slots__ = ("record",)

    def __init__(self, name: str):
        super().__init__(name)
        self.record = torch.profiler.record_function(name)

    def __enter__(self):
        super().__enter__()
        self.record.__enter__()
        return self

    def __exit__(self, *exc):
        self.record.__exit__(*exc)
        return super().__exit__(*exc)


def span(name: str):
    """A context naming the work inside it ``name`` on the profiler while
    one records; the shared no-op context otherwise."""
    return _Span(name) if _profiling() else _OFF


def label(name: str):
    """A context naming the host's work inside it ``name`` for the syncs
    made there while a profiler records; the shared no-op context
    otherwise."""
    return _Label(name) if _profiling() else _OFF


def _decorator(kind, name: str):
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiling():
                return fn(*args, **kwargs)
            with kind(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def spanned(name: str):
    """Decorate a function so that each call runs inside ``span(name)``."""
    return _decorator(_Span, name)


def labelled(name: str):
    """Decorate a function so that each call runs inside ``label(name)``."""
    return _decorator(_Label, name)


def watch_syncs(flag: bool) -> bool:
    """Count the host's syncs (``host.syncs``) from the next outermost span
    or label on, or stop; returns the setting it replaces.  Off by default:
    each sync then passes through Python's warnings, which slows a traced
    step, so only a run that reads the syncs turns it on."""
    was, _STATE.watching = _STATE.watching, bool(flag)
    return was


def _watch_syncs() -> None:
    """From the first span or label opened: sync-debug mode ``"warn"`` on a
    card and its warnings counted, none shown."""
    caught = warnings.catch_warnings()
    caught.__enter__()
    warnings.filterwarnings("always", message=SYNC_WARNING)
    # torch's notice, on switching the mode, that the mode is a prototype
    warnings.filterwarnings("ignore", message="Synchronization debug mode")
    shown = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        if str(message).startswith(SYNC_WARNING):
            count_sync()
        else:
            shown(message, category, filename, lineno, file, line)

    warnings.showwarning = show
    mode = None
    if torch.cuda.is_available():
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
    _STATE.saved = (caught, mode)


def _unwatch_syncs() -> None:
    """When the last one closes: the process's mode and filters back."""
    caught, mode = _STATE.saved
    _STATE.saved = None
    if mode is not None:
        torch.cuda.set_sync_debug_mode(mode)
    caught.__exit__(None, None, None)


def count_sync() -> None:
    """One host synchronisation, under the innermost open span or label
    (none is counted while none is open, or the syncs are not watched)."""
    if _STATE.stack and _STATE.saved is not None:
        _STATE.syncs[_STATE.stack[-1]] += 1


def count(name: str, value) -> None:
    """Add ``value`` to counter ``name`` while a span or label is open: a
    host int, or a 0-d integer tensor, kept on its device and summed when
    read."""
    if not _STATE.stack:
        return
    if isinstance(value, torch.Tensor):
        key = (name, value.device)
        held = _STATE.tensors.get(key)
        _STATE.tensors[key] = value if held is None else held + value
    else:
        _STATE.ints[name] += int(value)


def counters() -> dict:
    """Every counter's total since :func:`reset_counters`, ``host.syncs``
    (all syncs) and ``host.syncs_by_span`` (``{span: syncs}``).  Reading a
    device counter waits for its device."""
    out = dict(_STATE.ints)
    for (name, _), value in _STATE.tensors.items():
        out[name] = out.get(name, 0) + int(value)
    out["host.syncs"] = sum(_STATE.syncs.values())
    out["host.syncs_by_span"] = dict(_STATE.syncs)
    return out


def reset_counters() -> None:
    """Clear every counter and the syncs by span."""
    _STATE.ints.clear()
    _STATE.tensors.clear()
    _STATE.syncs.clear()


@contextlib.contextmanager
def record():
    """``torch.profiler`` recording the region's program spans and, with
    CUDA, the device's kernels, copies and fills, and no operator (each
    would cost a step's every launch several microseconds).  Yields a holder
    whose ``result``, the profiler's, is set when the block ends."""
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
    held = types.SimpleNamespace(result=None)
    _prepare_profiler(config, acts)
    _enable_profiler(config, acts, {RecordScope.USER_SCOPE})
    try:
        yield held
    finally:
        held.result = _disable_profiler()


@contextlib.contextmanager
def maybe_trace(profile_dir: Optional[str]):
    """Under it, :func:`record` records the region, with the syncs watched;
    on exit it writes ``<profile_dir>/trace_<pid>_<ms>.json`` (a Chrome
    trace: Perfetto) and, beside it, ``counters_<pid>_<ms>.json``
    (:func:`counters`, reset on entry).  A no-op when ``profile_dir`` is
    empty."""
    if not profile_dir:
        yield
        return
    os.makedirs(profile_dir, exist_ok=True)
    reset_counters()
    was = watch_syncs(True)
    try:
        with record() as rec:
            yield
    finally:
        watch_syncs(was)
    stem = f"{os.getpid()}_{int(time.time() * 1e3)}.json"
    rec.result.save(os.path.join(profile_dir, f"trace_{stem}"))
    with open(os.path.join(profile_dir, f"counters_{stem}"), "w") as fh:
        json.dump(counters(), fh, indent=1, sort_keys=True)
