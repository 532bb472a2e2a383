"""Profiling: a trace of any region when a directory is given.

Port of ``maybe_trace`` of the JAX package's ``profiling.py``.  The
reference's only instrumentation is root-rank wall-clock stage prints
(timer(), module_mpi_util.f90:66-71); :func:`maybe_trace` records a
``torch.profiler`` trace of the region instead: host operators, and the
card's kernels and copies when CUDA is available.  The trace is written as a
Chrome trace (view it in Perfetto or ``chrome://tracing``).  The per-stage
device-time breakdown (``device_breakdown``) is not ported yet: ROADMAP M12.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def maybe_trace(profile_dir: Optional[str]):
    """Under it, ``torch.profiler`` records the region and writes
    ``<profile_dir>/trace_<pid>_<ms>.json`` on exit; a no-op when
    ``profile_dir`` is empty."""
    if not profile_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))
