"""The card's peaks and the operations and bytes of the program's kernels.

Peaks are the published figures of one NVIDIA H100 SXM (NVIDIA's data
sheet, dense rates, at its 700 W limit); a card set to a lower power limit
runs below them, so every share is printed beside the card's limit.
"""
from __future__ import annotations

#: float32 outside the tensor cores, and device memory
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def least_seconds(flop: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations over
    the float32 peak and the bytes over the memory rate."""
    return max(flop / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)


def ns_invsqrt_work(batch: int, k: int, steps: float):
    """``(flop, bytes)`` of a Newton-Schulz inverse square root of a
    ``[batch, k, k]`` float32 batch whose matrices take ``steps`` steps in
    all: three ``k x k`` products of ``2 k^3`` operations a step (the scale,
    the residual and ``T`` are of lower order); ``a`` read once and ``z``
    written once."""
    return 3 * 2 * k ** 3 * steps, 2 * 4 * k * k * batch
