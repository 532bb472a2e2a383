"""Launch the CUDA Jacobi eigensolvers (``csrc/jacobi_eigh.cu``).

Two kernels:

- ``"parallel"`` (K3, even k >= 4): the Brent-Luk round-robin order.  Up to
  k = 96 A and V in shared memory, a warp per matrix (one block of 256
  threads per matrix at k = 96), the pairing by the closed form of
  :func:`ring_pairing`.  Above 96 one block of 2 k threads per matrix, A
  alone in shared memory and V in registers in slot order, moved each round
  by the fixed permutation of :func:`slot_schedule`; plain version
  :func:`cwbnwp_letkf_torch.ops.jacobi_eigh.jacobi_parallel`;
- ``"cyclic"`` (K4, odd k or k < 4): the sequential cyclic-by-row order.
  Up to k = 96, 16 lanes per matrix at k = 41 (two matrices a warp) and a
  warp per matrix at any other k, up to four warps a block; each lane keeps
  A's row and column p, V's column p and A's diagonal at the indices it
  owns in registers, computes each rotation's 2x2 itself from entries
  shuffled ahead from their owner, and ends each rotation with one
  ``__syncwarp``; A and V in shared memory.  Above 96 two launches: the
  chain, two warps and one matrix a block with A alone in shared memory
  (up to three matrices an SM), rotates A and writes each rotation's
  ``(c, s)`` to a log; the V pass applies the log to V = I, a warp per 32
  rows of V.  The log, 8 bytes a rotation (:func:`log_bytes`), is a
  workspace from torch's allocator; a batch whose log would pass
  :data:`LOG_CAP_BYTES` runs in pieces (:func:`log_pieces`).  Plain version
  :func:`cwbnwp_letkf_torch.ops.jacobi_eigh.jacobi_cyclic`.

:func:`cwbnwp_letkf_torch.ops.jacobi_eigh.jacobi_eigh` sends CUDA tensors
here.  The library is built by :mod:`.cuda_build` at first use.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import cuda_build

#: kernel launches per kernel since import (or since a caller reset them)
LAUNCHES = {"parallel": 0, "cyclic": 0}

#: largest ensemble size the kernels take: the JAX package's Pallas reach
#: (``pallas_eigh.jacobi_vmem_bytes(k) <= VMEM_BUDGET_BYTES``, a TPU core's
#: VMEM budget, holds through k=177), not a property of this card; above it
#: ``solver`` takes ``torch.linalg.eigh``, as the JAX package takes XLA eigh
MAX_K = 177

#: the largest k of the layouts that keep V beside A (``kMidK`` in the
#: source); above it K3 keeps V in registers and K4 rebuilds it from a log
MID_K = 96

#: the most bytes of K4's rotation log one launch takes: a batch whose log
#: is larger runs in pieces of as many matrices as fit (at least one)
LOG_CAP_BYTES = 1 << 30

SOURCE = cuda_build.CSRC / "jacobi_eigh.cu"

_fns: dict = {}

#: the fields of ``jacobi_config``'s output, in order
CONFIG_KEYS = ("threads", "smem_bytes", "registers", "matrices", "blocks_per_sm",
               "v_in_device_memory", "v_in_registers", "v_from_log")


def kernel_for(k: int) -> str:
    """The kernel the TPU package's ``jacobi_eigh`` dispatch picks for ``k``."""
    return "parallel" if k >= 4 and k % 2 == 0 else "cyclic"


def ring_pairing(k: int, r: int) -> list:
    """The round-robin pairing ``[top | bot]`` after ``r`` rounds, by the
    closed form K3 computes it with (``ring_index`` in the source).

    Every index but ``top[0] = 0`` moves one step a round along a ring of
    ``k - 1`` positions ``[top_1 .. top_{m-1}, bot_{m-1} .. bot_0]``; after
    ``r`` rounds ring position ``u`` holds the index that started at
    ``x = (u - r) mod (k - 1)``, which is ``x + 1`` for ``x < m - 1`` and
    ``3m - 2 - x`` otherwise.  Equals ``jacobi_eigh.round_robin(k, r)[r]``.
    """
    m = k // 2

    def ring_index(u):
        x = (u - r) % (k - 1)
        return x + 1 if x < m - 1 else 3 * m - 2 - x

    top = [0] + [ring_index(i - 1) for i in range(1, m)]
    bot = [ring_index(k - 2 - i) for i in range(m)]
    return top + bot


class SlotSchedule(NamedTuple):
    """K3's layout above k = 96 (:func:`slot_schedule`)."""

    #: the index slot ``s`` holds in round 0: ``[top | bot] = [0 .. m-1 | m .. k-1]``
    order: list
    #: between rounds slot ``s`` takes the value slot ``move[s]`` held
    move: list
    #: ``P``: register pairs a half row of V, ``ceil(m / 2)``
    pairs: int
    #: ``L0``: the pairs of half 0, ``m - P`` (``P - 1`` or ``P``)
    first_half: int


def slot_schedule(k: int) -> SlotSchedule:
    """How K3 holds V above k = 96: row by row in slot order, where slot
    ``i < m`` is ``top_i`` and slot ``m + i`` is ``bot_i`` of the round at
    hand.  A round rotates slots ``(i, m + i)``; then every slot takes the
    value of slot ``move[s]``, so that slot order follows the pairing:
    ``top' = [top_0, bot_0, top_1 .. top_{m-2}]``, ``bot' = [bot_1 ..
    bot_{m-1}, top_{m-1}]``.  After ``r`` rounds the slots hold
    ``ring_pairing(k, r)``, and after the last round they are the output's
    columns.  Thread ``2 row + g`` holds half ``g`` of a row: pairs ``0 ..
    L0 - 1`` for ``g = 0`` and ``L0 .. m - 1`` for ``g = 1``, each in ``P``
    register pairs (half 0's last one a spare where ``L0 = P - 1``).
    """
    if k < 4 or k % 2:
        raise ValueError(f"round-robin Jacobi needs an even k >= 4, got {k}")
    m = k // 2
    move = ([0, m] + list(range(1, m - 1)) + list(range(m + 1, k)) + [m - 1])
    pairs = (m + 1) // 2
    return SlotSchedule(list(range(k)), move, pairs, m - pairs)


def work(name: str, batch: int, k: int, sweeps: int = 7):
    """``(flop, bytes)`` of ``sweeps`` Jacobi sweeps over a ``[batch, k, k]``
    batch by kernel ``name`` (``"parallel"`` or ``"cyclic"``).

    A rotation ``(x, y) <- (c x - s y, s x + c y)`` of one pair is 6 flop.  A
    round of the round-robin order rotates ``k^2`` pairs of A (rows, then
    columns) and ``k^2 / 2`` of V, and a sweep is ``k - 1`` rounds; a
    rotation of the sequential order rotates ``3 k`` pairs, and a sweep is
    ``k (k - 1) / 2`` rotations.  The rotation angles are lower order and
    not counted.  Bytes: A read once, V and ``lam`` written once, float32.
    """
    if name == "parallel":
        pairs = sweeps * (k - 1) * (3 * k * k // 2)
    elif name == "cyclic":
        pairs = sweeps * (k * (k - 1) // 2) * 3 * k
    else:
        raise ValueError(f"unknown kernel {name!r}")
    return 6 * pairs * batch, 4 * (2 * k * k + k) * batch


def log_bytes(k: int, sweeps: int = 7) -> int:
    """Bytes of K4's rotation log for one ``k x k`` matrix: 8 a rotation,
    ``sweeps k (k - 1) / 2`` rotations, above :data:`MID_K`; 0 for K3 and
    for K4 up to it."""
    if kernel_for(k) != "cyclic" or k <= MID_K:
        return 0
    return 8 * sweeps * (k * (k - 1) // 2)


def log_pieces(batch: int, k: int, sweeps: int = 7, cap=None) -> list:
    """``[(start, stop), ...]``: the pieces of a ``[batch, k, k]`` batch that
    K4 runs one launch each, so that no piece's rotation log passes ``cap``
    bytes (:data:`LOG_CAP_BYTES` by default) unless one matrix's log alone
    does: as many matrices a piece as fit, at least one.  One piece where
    there is no log."""
    per = log_bytes(k, sweeps)
    cap = LOG_CAP_BYTES if cap is None else cap
    n = batch if per == 0 else max(1, min(batch, cap // per))
    return [(s, min(s + n, batch)) for s in range(0, batch, n)]


def config(k: int) -> dict:
    """What a launch at ensemble size ``k`` uses on the current card, for
    the kernel :func:`kernel_for` picks: ``threads`` and ``matrices`` per
    block, dynamic ``smem_bytes``, ``registers`` per thread, resident
    ``blocks_per_sm`` and ``matrices_per_sm``, ``v_in_device_memory`` (1
    where V lives in the output: none now), ``v_in_registers`` (1 where it
    lives in registers) and ``v_from_log`` (1 where a second launch makes it
    from the rotation log, K4 above :data:`MID_K`; the other fields are then
    the chain's; all three 0: V in shared memory).  Builds the library if
    need be; launches nothing."""
    fn = cuda_build.load(SOURCE).jacobi_config
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(CONFIG_KEYS))()
    rc = fn(int(kernel_for(k) == "cyclic"), int(k), out)
    if rc != 0:
        raise RuntimeError(f"jacobi_config failed: CUDA error {rc}")
    cfg = dict(zip(CONFIG_KEYS, out))
    cfg["matrices_per_sm"] = cfg["matrices"] * cfg["blocks_per_sm"]
    return cfg


def bind(lib: ctypes.CDLL, name: str):
    """``jacobi_<name>_f32`` of a library built from :data:`SOURCE`, its
    argument types set: K3 takes ``(a, lam, v, batch, k, sweeps, stream)``,
    K4 also ``(log, log bytes)`` after the stream."""
    fn = getattr(lib, f"jacobi_{name}_f32")
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
                   + ([ctypes.c_void_p, ctypes.c_longlong] if name == "cyclic" else []))
    fn.restype = ctypes.c_int
    return fn


def _load(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = _fns[name] = bind(cuda_build.load(SOURCE), name)
    return fn


def chain_floor(a: torch.Tensor, *, sweeps: int = 7) -> torch.Tensor:
    """Launch the chain's link alone (``jacobi_chain_floor_f32``): one warp
    running the ``sweeps k (k - 1) / 2`` links of K4's chain (the Schur 2x2,
    the 2x2 block's a_pp, the next a_pq) from entries of ``a``'s first
    matrix held in registers, with no other work, for timing: its time over
    the links is the latency of one link.  Returns the 32 floats it ends
    with; counts no launch (it is not on any path).  ``a``: a CUDA float32
    ``[B, k, k]`` batch, 3 <= k <= :data:`MAX_K`."""
    cuda_build.check_batch(a, MAX_K)
    fn = cuda_build.load(SOURCE).jacobi_chain_floor_f32
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(32, dtype=a.dtype, device=a.device)
    rc = fn(a.data_ptr(), out.data_ptr(), a.shape[-1], int(sweeps),
            cuda_build.stream_of(a))
    if rc != 0:
        raise RuntimeError(f"jacobi_chain_floor_f32 launch failed: CUDA error {rc}")
    return out


def fast_path_check(device, pairs: int = 1 << 32) -> dict:
    """Hold K4's branch-free division and square root (``schur_fast`` in the
    source) against ``__fdiv_rn`` / ``__fsqrt_rn`` on ``device``: the square
    root on every float its range admits, the division on ``pairs``
    pseudo-random pairs in its window.  Returns ``{"sqrt_checked",
    "sqrt_differ", "div_checked", "div_differ"}``; for tests, counts no
    launch."""
    fn = cuda_build.load(SOURCE).jacobi_fast_path_check
    fn.argtypes = [ctypes.c_ulonglong, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    counts = torch.zeros(4, dtype=torch.int64, device=device)
    with torch.cuda.device(counts.device):
        stream = torch.cuda.current_stream().cuda_stream
    rc = fn(int(pairs), counts.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"jacobi_fast_path_check failed: CUDA error {rc}")
    return dict(zip(("sqrt_checked", "sqrt_differ", "div_checked", "div_differ"),
                    counts.tolist()))


def launch(a: torch.Tensor, *, sweeps: int = 7):
    """Launch the kernel for ``k`` on a CUDA float32 ``[B, k, k]`` batch.

    Returns the unsorted ``(lam [B, k], v [B, k, k])`` in the plain
    version's order, before the polish.  K4 above :data:`MID_K` takes its
    rotation log from torch's allocator on ``a``'s stream and runs the
    pieces of :func:`log_pieces`, one launch (and one count) each.  Raises
    ``ValueError`` for an input the kernels do not take and
    ``RuntimeError`` when a launch fails.  Does not synchronize.
    """
    cuda_build.check_batch(a, MAX_K)
    if sweeps < 0:
        raise ValueError(f"sweeps={sweeps} < 0")
    b, k, _ = a.shape
    name = kernel_for(k)
    fn = _load(name)
    lam = torch.empty((b, k), dtype=a.dtype, device=a.device)
    v = torch.empty_like(a)
    stream = cuda_build.stream_of(a)
    pieces = log_pieces(b, k, sweeps)
    extra = ()
    if name == "cyclic":
        ws_bytes = log_bytes(k, sweeps) * max(stop - start for start, stop in pieces)
        ws = torch.empty(ws_bytes, dtype=torch.uint8, device=a.device) if ws_bytes else None
        extra = (ws.data_ptr() if ws_bytes else None, ws_bytes)
    # a piece's pointers by byte offset (float32): no tensor view a launch
    pa, plam, pv = a.data_ptr(), lam.data_ptr(), v.data_ptr()
    for start, stop in pieces:
        rc = fn(pa + 4 * start * k * k, plam + 4 * start * k, pv + 4 * start * k * k,
                stop - start, k, int(sweeps), stream, *extra)
        if rc != 0:
            raise RuntimeError(f"jacobi_{name}_f32 launch failed: CUDA error {rc}")
        LAUNCHES[name] += 1
    return lam, v
