"""ctypes bindings for the native obs parsers (``csrc/gts_parser.cpp``).

Port of the JAX package's ``io/native.py``.  The reference amortizes its
Fortran formatted READs over >= nmember MPI ranks (one member file each,
cwb_letkf.f90:39-52); a single host parses every member itself, so text
ingest sits on the host side of the critical path.  This is host code, not a
device kernel: the port's own copy of the C++ parser, in the package's
``csrc/``, is built with ``g++ -O3 -std=c++17 -shared -fPIC`` into
``cwbnwp_letkf_torch/_build/libobsparse.so`` at first use and whenever the
source is newer, and loaded with ``ctypes``.  Without a compiler, or with
``CWBNWP_NO_NATIVE`` set, :func:`get_library` returns None and the callers
use the Python parsers, which are the spec: the native ones are a faster
equal.

``PARSES`` counts the files each parser served (``"native"`` and
``"python"``), so a run can show which parser read its input.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Dict, Optional

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_FAILED = False

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "gts_parser.cpp")
_SO = os.path.join(_PKG, "_build", "libobsparse.so")

#: files parsed by each parser since the counts were last set to 0
PARSES: Dict[str, int] = {"native": 0, "python": 0}


def served(parser: str) -> None:
    """Count one file parsed by ``parser`` ("native" or "python")."""
    with _LOCK:
        PARSES[parser] += 1


def reset_parses() -> None:
    """Set the counts of ``PARSES`` to 0."""
    with _LOCK:
        for key in PARSES:
            PARSES[key] = 0


def _build_library() -> Optional[str]:
    """Compile the .so if missing or older than the source.

    The compiler writes a file of its own name beside the library, which
    then replaces the library in one rename, so processes building at once
    never load a half-written file."""
    if not os.path.exists(_SRC):
        return None
    if (os.path.exists(_SO)
            and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
        return _SO
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.{threading.get_ident()}"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return None
    return _SO


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.gts_parse.restype = c.c_void_p
    lib.gts_parse.argtypes = [c.c_char_p]
    lib.gts_error.restype = c.c_char_p
    lib.gts_error.argtypes = [c.c_void_p]
    lib.gts_num_families.restype = c.c_int
    lib.gts_num_families.argtypes = [c.c_void_p]
    lib.gts_family_name.restype = c.c_char_p
    lib.gts_family_name.argtypes = [c.c_void_p, c.c_int]
    lib.gts_family_nrec.restype = c.c_long
    lib.gts_family_nrec.argtypes = [c.c_void_p, c.c_int]
    lib.gts_family_nvar.restype = c.c_int
    lib.gts_family_nvar.argtypes = [c.c_void_p, c.c_int]
    lib.gts_family_copy.restype = None
    lib.gts_family_copy.argtypes = [c.c_void_p, c.c_int] + [c.c_void_p] * 9
    lib.gts_free.restype = None
    lib.gts_free.argtypes = [c.c_void_p]
    lib.radar_parse.restype = c.c_void_p
    lib.radar_parse.argtypes = [c.c_char_p]
    lib.radar_error.restype = c.c_char_p
    lib.radar_error.argtypes = [c.c_void_p]
    lib.radar_nobs.restype = c.c_long
    lib.radar_nobs.argtypes = [c.c_void_p]
    lib.radar_copy.restype = None
    lib.radar_copy.argtypes = [c.c_void_p, c.c_void_p]
    lib.radar_free.restype = None
    lib.radar_free.argtypes = [c.c_void_p]
    return lib


def get_library() -> Optional[ctypes.CDLL]:
    """The loaded native library, building it on first call; None if
    unavailable (no source / no compiler / ``CWBNWP_NO_NATIVE``): callers
    then use the Python parsers."""
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        if os.environ.get("CWBNWP_NO_NATIVE"):
            _LIB_FAILED = True
            return None
        so = _build_library()
        if so is None:
            _LIB_FAILED = True
            return None
        try:
            _LIB = _bind(ctypes.CDLL(so))
        except OSError:
            _LIB_FAILED = True
            return None
    return _LIB


class NativeGtsFamily:
    """One platform family's records as flat numpy arrays.

    Duck-type-compatible with obs.gts.GtsRecords for the consumers in
    read_gts_ensemble (np.asarray(rec.obs), len(rec.ids), zip(ids, level)).
    """

    __slots__ = ("ids", "lat", "lon", "pre", "level", "obs", "omb", "qc",
                 "err")

    def __init__(self, ids, lat, lon, pre, level, obs, omb, qc, err):
        self.ids = ids
        self.lat = lat
        self.lon = lon
        self.pre = pre
        self.level = level
        self.obs = obs
        self.omb = omb
        self.qc = qc
        self.err = err


def parse_member_file_native(path: str) -> Optional[Dict[str, NativeGtsFamily]]:
    """Native parse of one gts_omboma member file; None if lib unavailable."""
    lib = get_library()
    if lib is None:
        return None
    h = lib.gts_parse(path.encode())
    try:
        err = lib.gts_error(h)
        if err:
            raise IOError(f"gts parse failed: {err.decode()} ({path})")
        out: Dict[str, NativeGtsFamily] = {}
        for i in range(lib.gts_num_families(h)):
            name = lib.gts_family_name(h, i).decode()
            n = lib.gts_family_nrec(h, i)
            nvar = lib.gts_family_nvar(h, i)
            ids = np.zeros(n, dtype="S8")
            lat = np.empty(n, np.float32)
            lon = np.empty(n, np.float32)
            pre = np.empty(n, np.float32)
            level = np.empty(n, np.int32)
            obs = np.empty((n, nvar), np.float32)
            omb = np.empty((n, nvar), np.float32)
            qc = np.empty((n, nvar), np.int32)
            errv = np.empty((n, nvar), np.float32)
            lib.gts_family_copy(
                h, i,
                ids.ctypes.data_as(ctypes.c_void_p),
                lat.ctypes.data_as(ctypes.c_void_p),
                lon.ctypes.data_as(ctypes.c_void_p),
                pre.ctypes.data_as(ctypes.c_void_p),
                level.ctypes.data_as(ctypes.c_void_p),
                obs.ctypes.data_as(ctypes.c_void_p),
                omb.ctypes.data_as(ctypes.c_void_p),
                qc.ctypes.data_as(ctypes.c_void_p),
                errv.ctypes.data_as(ctypes.c_void_p))
            out[name] = NativeGtsFamily(
                ids=np.char.decode(ids, "ascii"), lat=lat, lon=lon, pre=pre,
                level=level, obs=obs, omb=omb, qc=qc, err=errv)
    finally:
        lib.gts_free(h)
    served("native")
    return out


def parse_radar_file_native(path: str) -> Optional[np.ndarray]:
    """Native parse of one radar file -> [nobs, 5] float32.

    Returns None when the native lib is unavailable; raises on parse errors.
    An empty file yields an empty [0, 5] array (caller treats as None).
    """
    lib = get_library()
    if lib is None:
        return None
    h = lib.radar_parse(path.encode())
    try:
        err = lib.radar_error(h)
        if err:
            raise IOError(f"radar parse failed: {err.decode()} ({path})")
        n = lib.radar_nobs(h)
        data = np.empty((n, 5), np.float32)
        if n:
            lib.radar_copy(h, data.ctypes.data_as(ctypes.c_void_p))
    finally:
        lib.radar_free(h)
    served("native")
    return data
