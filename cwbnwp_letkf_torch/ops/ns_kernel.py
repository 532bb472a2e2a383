"""Build, load and launch the CUDA Newton-Schulz kernel (``csrc/ns_invsqrt.cu``).

The kernel computes ``Z ~= (a_obs + inflat*I)^(-1/2)`` for a batch of
float32 ``[k, k]`` matrices, one thread block per matrix, each matrix
stopping on its own residual by the plain version's rule.  That plain
PyTorch version is :func:`cwbnwp_letkf_torch.ops.solver.ns_invsqrt`;
``solver._ns_z`` sends CUDA tensors here and CPU tensors there.

The library is compiled with ``nvcc`` at first use into
``cwbnwp_letkf_torch/_build/``, under a name keyed by a hash of the source and
the flags, so an edited ``.cu`` rebuilds.  It has a plain C interface and is
loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

#: kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0

#: largest ensemble size the kernel takes (four padded k x k fp32 buffers
#: must fit one block's shared memory)
MAX_K = 96

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "ns_invsqrt.cu"
BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_fn = None


def _nvcc() -> str:
    """``nvcc`` from PATH, else ``$CUDA_HOME/bin``, else ``/usr/local/cuda/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH, under $CUDA_HOME/bin or under "
        "/usr/local/cuda/bin: the CUDA toolkit is needed to build "
        f"{SOURCE.name}")


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"ns_invsqrt_{digest}.so"


def build() -> Path:
    """Compile the kernel unless this source is already built; return the path.

    The compiler's report (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside the library with the suffix ``.log``.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)   # atomic: concurrent builders never see a partial file
    return out


def _load():
    global _fn
    if _fn is None:
        fn = ctypes.CDLL(str(build())).ns_invsqrt_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def launch(a_obs: torch.Tensor, inflat: float, *, tol: float = 1e-4,
           max_iters: int = 24):
    """Launch the kernel on a CUDA float32 ``[B, k, k]`` batch.

    Returns ``(z [B, k, k], iters [B] int32, residual [B] float32)``: each
    matrix's step count and last pre-step ``max|W - I|``.  Raises
    ``ValueError`` for an input the kernel does not take and ``RuntimeError``
    when the launch fails.  Does not synchronize.
    """
    global LAUNCHES
    if a_obs.ndim != 3 or a_obs.shape[1] != a_obs.shape[2]:
        raise ValueError(f"need a [B, k, k] batch, got shape {tuple(a_obs.shape)}")
    if a_obs.dtype != torch.float32:
        raise ValueError(f"need float32, got {a_obs.dtype}")
    b, k, _ = a_obs.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside the kernel's range 1..{MAX_K}")
    if b == 0:
        raise ValueError("empty batch")
    if not a_obs.is_contiguous():
        raise ValueError("need a contiguous batch")
    if a_obs.device.type != "cuda":
        raise ValueError(f"need a CUDA tensor, got one on {a_obs.device}")
    fn = _load()
    z = torch.empty_like(a_obs)
    iters = torch.empty(b, dtype=torch.int32, device=a_obs.device)
    resid = torch.empty(b, dtype=torch.float32, device=a_obs.device)
    with torch.cuda.device(a_obs.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(a_obs.data_ptr(), z.data_ptr(), iters.data_ptr(),
                resid.data_ptr(), b, k, float(inflat), float(tol),
                int(max_iters), stream)
    if rc != 0:
        raise RuntimeError(f"ns_invsqrt_f32 launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return z, iters, resid


def ns_invsqrt_cuda(a_obs: torch.Tensor, inflat: float, *, tol: float = 1e-4,
                    max_iters: int = 24):
    """``(z, iters, residual)`` with the batch maxima of :func:`launch`'s
    per-matrix step counts and residuals, as 0-d device tensors."""
    z, iters, resid = launch(a_obs, inflat, tol=tol, max_iters=max_iters)
    return z, iters.max(), resid.max()
