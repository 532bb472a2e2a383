"""Build, load and feed the port's CUDA kernel libraries (``cwbnwp_letkf_torch/csrc``).

Every ``.cu`` source there has a plain C interface.  It is compiled with
``nvcc`` at first use into ``cwbnwp_letkf_torch/_build/``, under a name keyed
by a hash of the source and the flags, so an edited source rebuilds, and it
is loaded with ``ctypes``.  The compiler's report (``-Xptxas -v``: registers,
shared memory, spills) is kept beside each library with the suffix ``.log``.
:func:`build` starts one ``nvcc`` per source that is not built yet, all at
once, and waits for them together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: peaks of one NVIDIA H100 SXM (NVIDIA's data sheet): float32 outside the
#: tensor cores, and device memory
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12

_libs: dict = {}


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
        "/usr/local/cuda/bin: the CUDA toolkit is needed to build the kernels")


def library_path(source: Path) -> Path:
    """Where the library for ``source`` and the current flags lives."""
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}_{digest}.so"


def build(*sources: Path) -> list:
    """Compile every source that is not built yet, in parallel; return the
    library paths in the order of ``sources``.  Raises ``RuntimeError`` with
    the compiler's output if any build fails."""
    outs = [library_path(s) for s in sources]
    todo = [(s, o) for s, o in zip(sources, outs) if not o.exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for src, out in todo:
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
            procs.append((src, out, tmp, subprocess.Popen(
                [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, out, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {src.name} with code "
                              f"{proc.returncode}:\n{log}")
                continue
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)   # atomic: a concurrent build never sees a partial file
        if failed:
            raise RuntimeError("\n".join(failed))
    return outs


def load(source: Path) -> ctypes.CDLL:
    """The library built from ``source``, built first if need be."""
    lib = _libs.get(source)
    if lib is None:
        lib = _libs[source] = ctypes.CDLL(str(build(source)[0]))
    return lib


def resources(library: Path) -> dict:
    """``{entry function: {"registers", "stack", "spill_stores",
    "spill_loads"}}`` from the compiler's report beside ``library``
    (``-Xptxas -v``), stack and spills in bytes."""
    out, entry = {}, None
    for line in library.with_suffix(".log").read_text().splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            entry = out[found.group(1)] = {}
            continue
        if entry is None:
            continue
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
        if frame:
            entry.update(zip(("stack", "spill_stores", "spill_loads"),
                             map(int, frame.groups())))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            entry["registers"] = int(used.group(1))
    return out


def bound_ms(flop: float, nbytes: float) -> float:
    """The least time in ms an H100 could take for ``flop`` float32
    operations on ``nbytes`` of inputs and outputs: the larger of operations
    over the peak rate and bytes over the memory rate."""
    return 1e3 * max(flop / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)


def check_batch(a: torch.Tensor, max_k: int) -> None:
    """Raise ``ValueError`` unless ``a`` is a non-empty contiguous float32
    ``[B, k, k]`` CUDA batch with ``1 <= k <= max_k``."""
    if a.ndim != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"need a [B, k, k] batch, got shape {tuple(a.shape)}")
    if a.dtype != torch.float32:
        raise ValueError(f"need float32, got {a.dtype}")
    if not 1 <= a.shape[1] <= max_k:
        raise ValueError(f"k={a.shape[1]} outside the kernel's range 1..{max_k}")
    if a.shape[0] == 0:
        raise ValueError("empty batch")
    if not a.is_contiguous():
        raise ValueError("need a contiguous batch")
    if a.device.type != "cuda":
        raise ValueError(f"need a CUDA tensor, got one on {a.device}")


def stream_of(a: torch.Tensor) -> int:
    """The current CUDA stream of ``a``'s device, as an integer handle."""
    with torch.cuda.device(a.device):
        return torch.cuda.current_stream().cuda_stream
