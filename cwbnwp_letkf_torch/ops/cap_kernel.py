"""Launch the CUDA cap search (``csrc/cap_search.cu``).

The capped branch of :func:`.dense.terms_from_r2` on a card: the record
mask, the ``max_lz_pts`` threshold of :func:`.dense._cap_threshold` and the
selection under it, in one launch.  The kernel replaces no TPU kernel (the
JAX package's ``_cap_threshold`` is plain XLA); its plain version is
:func:`plain`, which calls ``_cap_threshold`` itself, and the two agree bit
for bit.  The library is built by :mod:`.cuda_build` at first use.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import cuda_build, dense

#: kernel launches since import (or since a caller reset it)
LAUNCHES = 0

#: the multisection's splits and rounds, compile-time constants of the
#: kernel and ``_cap_threshold``'s defaults
SPLITS, ROUNDS = 16, 6

SOURCE = cuda_build.CSRC / "cap_search.cu"

_fn = None


def work(b: int, r: int):
    """``(ops, bytes)`` of one search over ``[b, r]`` distances.

    Operations: the float32 compares the plain version makes, one a pair
    for the count under the cap, ``SPLITS - 1`` a pair a round and one for
    the selection.  Bytes: the distances read once (4 a pair), the selection
    written once (1 a pair), the record mask (1 a record) and ``over`` (1 a
    row).
    """
    pairs = b * r
    return (2 + ROUNDS * (SPLITS - 1)) * pairs, 5 * pairs + r + b


def _load():
    global _fn
    if _fn is None:
        fn = cuda_build.load(SOURCE).cap_search_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def config(r: int) -> dict:
    """What a launch over rows of ``r`` records uses on the current card:
    ``threads`` per block, dynamic ``smem_bytes``, ``registers`` per thread,
    resident ``blocks_per_sm`` and ``staged`` (1 where a row is kept in
    shared memory, 0 where each pass reads it again).  Builds the library if
    need be; launches nothing."""
    fn = cuda_build.load(SOURCE).cap_search_config
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    rc = fn(int(r), out)
    if rc != 0:
        raise RuntimeError(f"cap_search_config failed: CUDA error {rc}")
    return dict(zip(("threads", "smem_bytes", "registers", "blocks_per_sm",
                     "staged"), out))


def _check(r2, row_mask, n_max, r2_cap, splits, rounds):
    if (splits, rounds) != (SPLITS, ROUNDS):
        raise ValueError(f"the kernel runs {SPLITS} splits and {ROUNDS} "
                         f"rounds, got {splits} and {rounds}")
    if not (math.isfinite(r2_cap) and r2_cap >= 0.0):
        raise ValueError(f"need a finite r2_cap >= 0, got {r2_cap}")
    if not 0 <= n_max < 2 ** 31:
        raise ValueError(f"n_max {n_max} outside 0..2**31-1")
    if r2.ndim != 2 or r2.shape[1] == 0:
        raise ValueError(f"need [B, R] distances with R >= 1, got shape "
                         f"{tuple(r2.shape)}")
    if r2.dtype != torch.float32:
        raise ValueError(f"need float32 distances, got {r2.dtype}")
    if not r2.is_contiguous():
        raise ValueError("need contiguous distances")
    if r2.device.type != "cuda":
        raise ValueError(f"need a CUDA tensor, got one on {r2.device}")
    if row_mask is not None:
        if (row_mask.shape != (r2.shape[1],) or row_mask.dtype != torch.bool
                or row_mask.device != r2.device
                or not row_mask.is_contiguous()):
            raise ValueError(
                f"need a contiguous [R] bool record mask on {r2.device}, got "
                f"{row_mask.dtype} {tuple(row_mask.shape)} on "
                f"{row_mask.device}")
    if r2.shape[0] >= 2 ** 31 or r2.shape[1] >= 2 ** 31:
        raise ValueError(f"shape {tuple(r2.shape)} above the kernel's int range")


def launch(r2: torch.Tensor, row_mask: torch.Tensor | None, n_max: int,
           r2_cap: float, *, splits: int = SPLITS, rounds: int = ROUNDS):
    """The cap search on a CUDA float32 ``[B, R]`` distance matrix.

    ``row_mask`` is an optional ``[R]`` bool record mask (False records are
    never selected).  Returns ``(sel [B, R] bool, over [B] bool)``: the
    records within each row's threshold, and the rows where more than
    ``n_max`` records lie within ``r2_cap``, both bit for bit
    :func:`plain`'s.  Raises ``ValueError`` for an input the kernel does not
    take and ``RuntimeError`` when the launch fails.  Does not synchronize.
    """
    global LAUNCHES
    _check(r2, row_mask, n_max, r2_cap, splits, rounds)
    b, r = r2.shape
    sel = torch.empty((b, r), dtype=torch.bool, device=r2.device)
    over = torch.empty(b, dtype=torch.bool, device=r2.device)
    if b == 0:
        return sel, over
    fn = _load()
    rc = fn(r2.data_ptr(), None if row_mask is None else row_mask.data_ptr(),
            sel.data_ptr(), over.data_ptr(), b, r, int(n_max), float(r2_cap),
            cuda_build.stream_of(r2))
    if rc != 0:
        raise RuntimeError(f"cap_search_f32 launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return sel, over


def plain(r2: torch.Tensor, row_mask: torch.Tensor | None, n_max: int,
          r2_cap: float):
    """:func:`launch`'s plain version: ``(sel, over)`` as the capped branch
    of :func:`.dense.terms_from_r2` selects on the CPU, through the unchanged
    :func:`.dense._cap_threshold`."""
    if row_mask is not None:
        r2 = torch.where(row_mask[None, :], r2, float("inf"))
    sel = r2 <= dense._cap_threshold(r2, n_max, r2_cap)[:, None]
    return sel, (r2 <= r2_cap).sum(1) > n_max
