"""Launch the selected-pair accumulation, K6 (``csrc/select_terms.cu``).

The capped branch of :func:`.dense.terms_from_r2` on a card, after the cap
search (K5, :mod:`.cap_kernel`): each point's normal terms summed over the
records that the search selected for it, from the fused table's per-record
factors (:class:`.dense.PairFactors`), where the dense product multiplies
the whole ``[C, R]`` weight matrix, 95-98% of it zeros, with the table.  The
kernel replaces no TPU kernel (the JAX package forms the terms with the
dense product); its plain version is :func:`plain`, that product over the
rows the factors multiply out to.  The two give the same terms with the sum
in another order, and the same counts.  The library is built by
:mod:`.cuda_build` at first use.
"""
from __future__ import annotations

import ctypes

import torch

from ..localization import WEIGHT_GC1999
from . import cuda_build, dense

#: kernel launches since import (or since a caller reset it)
LAUNCHES = 0

SOURCE = cuda_build.CSRC / "select_terms.cu"

_fn = None


def work(c: int, r: int, k: int, v: int, pairs: int):
    """``(ops, bytes)`` of one call over ``[c, r]`` distances with ``pairs``
    selected (point, record) pairs of accepted records, ``v`` observed
    variables and ``k`` members.

    Operations: a (pair, variable)'s ``k`` scalings ``s bg`` and its
    ``k (k + 1)`` FMAs of two operations.  Bytes: ``sel`` read once (1 a
    pair), the selected pairs' distances (4 each), each record's factors
    and count once (``4 (v (k + 2) + 1)``) and the outputs written once
    (``4 (k (k + 1) + 1)`` a point).
    """
    ops = pairs * v * (2 * k * (k + 1) + k)
    nbytes = (c * r + 4 * pairs + 4 * r * (v * (k + 2) + 1)
              + 4 * c * (k * (k + 1) + 1))
    return ops, nbytes


def _load():
    global _fn
    if _fn is None:
        fn = cuda_build.load(SOURCE).select_terms_f32
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def config(k: int, v: int = 1) -> dict:
    """What a launch at ``k`` members and ``v`` observed variables uses on
    the current card: ``threads`` a block, dynamic ``smem_bytes``,
    ``registers`` a thread, resident ``blocks_per_sm``, the micro-tile
    ``mr`` x ``mc`` of each thread, ``blocks_per_point`` and the records a
    staged batch (``batch_records``).  Builds the library if need be;
    launches nothing."""
    fn = cuda_build.load(SOURCE).select_terms_config
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 8)()
    rc = fn(int(k), int(v), out)
    if rc != 0:
        raise RuntimeError(f"select_terms_config failed: CUDA error {rc}")
    return dict(zip(("threads", "smem_bytes", "registers", "blocks_per_sm",
                     "mr", "mc", "blocks_per_point", "batch_records"), out))


def _check(r2, sel, bgo, e, nvalid):
    if r2.ndim != 2 or r2.shape[1] == 0:
        raise ValueError(f"need [C, R] distances with R >= 1, got shape "
                         f"{tuple(r2.shape)}")
    c, r = r2.shape
    if bgo.ndim != 3 or bgo.shape[0] != r or bgo.shape[2] < 2:
        raise ValueError(f"need [R, V, k+1] factors with R = {r}, got "
                         f"{tuple(bgo.shape)}")
    v = bgo.shape[1]
    want = {"r2": (r2, torch.float32, (c, r)),
            "sel": (sel, torch.bool, (c, r)),
            "bgo": (bgo, torch.float32, tuple(bgo.shape)),
            "e": (e, torch.float32, (r, v)),
            "nvalid": (nvalid, torch.int32, (r,))}
    for name, (x, dtype, shape) in want.items():
        if x.dtype != dtype:
            raise ValueError(f"need {dtype} {name}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"need {name} of shape {shape}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"need a contiguous {name}")
    if r2.device.type != "cuda":
        raise ValueError(f"need a CUDA tensor, got one on {r2.device}")
    for name, (x, _, _) in want.items():
        if x.device != r2.device:
            raise ValueError(f"{name} on {x.device}, distances on {r2.device}")
    if max(c, r * v * bgo.shape[2]) >= 2 ** 31:
        raise ValueError(f"shape {tuple(r2.shape)} x {tuple(bgo.shape)} "
                         f"above the kernel's int range")


def launch(r2: torch.Tensor, sel: torch.Tensor, bgo: torch.Tensor,
           e: torch.Tensor, nvalid: torch.Tensor, weight_function: int):
    """K6 on CUDA float32 ``[C, R]`` distances ``r2`` and their ``[C, R]``
    bool selection ``sel`` (K5's), with the records' factors ``bgo`` ``[R,
    V, k+1]`` and ``e`` ``[R, V]`` (:class:`.dense.PairFactors`) and accepted
    counts ``nvalid`` ``[R]`` int32.

    Returns ``(a_obs [C, k, k], g [C, k], count [C] int32)``: :func:`plain`'s
    terms with the sum in another order, and its counts.  Raises
    ``ValueError`` for an input the kernel does not take and
    ``RuntimeError`` when the launch fails.  Does not synchronize.
    """
    global LAUNCHES
    _check(r2, sel, bgo, e, nvalid)
    c, r = r2.shape
    v, k = bgo.shape[1], bgo.shape[2] - 1
    a = torch.empty((c, k, k), dtype=torch.float32, device=r2.device)
    g = torch.empty((c, k), dtype=torch.float32, device=r2.device)
    count = torch.empty(c, dtype=torch.int32, device=r2.device)
    if c == 0:
        return a, g, count
    fn = _load()
    rc = fn(r2.data_ptr(), sel.data_ptr(), bgo.data_ptr(), e.data_ptr(),
            nvalid.data_ptr(), a.data_ptr(), g.data_ptr(), count.data_ptr(),
            c, r, k, v, int(weight_function == WEIGHT_GC1999),
            cuda_build.stream_of(r2))
    if rc != 0:
        raise RuntimeError(f"select_terms_f32 launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return a, g, count


def plain(r2: torch.Tensor, sel: torch.Tensor, bgo: torch.Tensor,
          e: torch.Tensor, nvalid: torch.Tensor, weight_function: int):
    """:func:`launch`'s plain version: the dense product of
    :func:`.dense.terms_from_r2` (:func:`.dense.product_terms`) with the
    fused rows that the factors multiply out to
    (:func:`.dense.fused_rows`)."""
    fused = dense.fused_rows(dense.PairFactors(bgo, e))
    return dense.product_terms(r2, sel, fused, nvalid, weight_function)
