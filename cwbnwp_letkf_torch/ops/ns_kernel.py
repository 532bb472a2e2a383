"""Launch the CUDA Newton-Schulz kernels (``csrc/ns_invsqrt.cu``).

The kernels compute ``Z ~= (a_obs + inflat*I)^(-1/2)`` for a batch of
float32 ``[k, k]`` matrices, one thread block per matrix (a register tile of
the three products per thread, W, Z and one product in shared memory), each
matrix stopping on its own residual by the plain versions' rule.  Two compile-time
variants of one kernel, selected by ``packing``:

- ``"trio"`` (K1): ``Z' = T Z``, ``W' = T (T W)``; plain version
  :func:`cwbnwp_letkf_torch.ops.solver.ns_invsqrt`, reached from
  ``solver._ns_z`` for CUDA tensors;
- ``"rmul"`` (K2): ``U = W T``, ``Z' = Z T``, ``W' = U T``; plain version
  :func:`cwbnwp_letkf_torch.ops.solver.ns_invsqrt_rmul`, reached only by
  calling :func:`launch` with ``packing="rmul"``, as in the JAX package.

The library is built by :mod:`.cuda_build` at first use.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

#: kernel launches per packing since import (or since a caller reset them)
LAUNCHES = {"trio": 0, "rmul": 0}

#: largest ensemble size the kernel takes: a block's three padded k x k
#: fp32 buffers (192 KB at k=128) must fit the shared memory one block may
#: opt in to, 227 KB on an H100; one block is resident per SM from k=96 up,
#: as ``config(k)["blocks_per_sm"]`` reports.  Above it ``solver._ns_z``
#: takes the batched ``torch.matmul`` iteration, as the JAX package takes
#: XLA above its kernel's range
MAX_K = 128

SOURCE = cuda_build.CSRC / "ns_invsqrt.cu"

_fn = None


def work(batch: int, k: int, steps: float):
    """``(flop, bytes)`` of one solve of a ``[batch, k, k]`` batch that takes
    ``steps`` Newton-Schulz steps per matrix (the mean, where they differ).

    A step is three ``k x k`` products of ``2 k^3`` flop each; the scale,
    the residual and ``T`` are lower order and not counted.  Bytes: ``a_obs``
    read once and ``z`` written once, float32.
    """
    return 3 * 2 * k ** 3 * steps * batch, 2 * 4 * k * k * batch


def _load():
    global _fn
    if _fn is None:
        fn = cuda_build.load(SOURCE).ns_invsqrt_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def config(k: int, packing: str = "trio") -> dict:
    """What a launch at ensemble size ``k`` uses on the current card:
    ``threads`` per block, dynamic ``smem_bytes``, ``registers`` per thread,
    resident ``blocks_per_sm`` and the register tile's ``tile_rows``.
    Builds the library if need be; launches nothing."""
    if packing not in LAUNCHES:
        raise ValueError(f"unknown packing {packing!r}")
    fn = cuda_build.load(SOURCE).ns_invsqrt_config
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    rc = fn(int(k), int(packing == "rmul"), out)
    if rc != 0:
        raise RuntimeError(f"ns_invsqrt_config failed: CUDA error {rc}")
    return dict(zip(("threads", "smem_bytes", "registers", "blocks_per_sm",
                     "tile_rows"), out))


def launch(a_obs: torch.Tensor, inflat: float, *, tol: float = 1e-4,
           max_iters: int = 24, packing: str = "trio"):
    """Launch the kernel on a CUDA float32 ``[B, k, k]`` batch.

    Returns ``(z [B, k, k], iters [B] int32, residual [B] float32)``: each
    matrix's step count and last pre-step ``max|W - I|``.  Raises
    ``ValueError`` for an input the kernel does not take and ``RuntimeError``
    when the launch fails.  Does not synchronize.
    """
    if packing not in LAUNCHES:
        raise ValueError(f"unknown packing {packing!r}")
    cuda_build.check_batch(a_obs, MAX_K)
    b, k, _ = a_obs.shape
    fn = _load()
    z = torch.empty_like(a_obs)
    iters = torch.empty(b, dtype=torch.int32, device=a_obs.device)
    resid = torch.empty(b, dtype=torch.float32, device=a_obs.device)
    rc = fn(a_obs.data_ptr(), z.data_ptr(), iters.data_ptr(), resid.data_ptr(),
            b, k, float(inflat), float(tol), int(max_iters),
            int(packing == "rmul"), cuda_build.stream_of(a_obs))
    if rc != 0:
        raise RuntimeError(f"ns_invsqrt_f32 launch failed: CUDA error {rc}")
    LAUNCHES[packing] += 1
    return z, iters, resid


def ns_invsqrt_cuda(a_obs: torch.Tensor, inflat: float, *, tol: float = 1e-4,
                    max_iters: int = 24, packing: str = "trio"):
    """``(z, iters, residual)`` with the batch maxima of :func:`launch`'s
    per-matrix step counts and residuals, as 0-d device tensors."""
    z, iters, resid = launch(a_obs, inflat, tol=tol, max_iters=max_iters,
                             packing=packing)
    return z, iters.max(), resid.max()
