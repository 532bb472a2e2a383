"""Radar retrieval (dbz/vr/zdr/kdp) text-file parser.

Port of the JAX package's ``obs/radar.py`` (numpy only), which re-designs
``module_radar.f90`` (module_radar.f90:30-118).
Format per file (one file per member per retrieval type):

    <nobs:i10>
    then per obs: '(5(f10.4,1x))' -> obs, H(xb)_member, lon, lat, alt

Unlike GTS, the radar file stores H(xb) directly (no obs-omb conversion;
module_radar.f90:92).  File-to-member mapping comes from the 3-digit filename
suffix (module_radar.f90:42-44); retrieval type from the prefix VR/MR/MD/MK
(module_radar.f90:70-79).
"""
from __future__ import annotations

import concurrent.futures as cf
from typing import Dict, Optional, Sequence

import numpy as np

from .base import PlatformObs

#: file prefix -> platform name used in config (module_radar.f90:70-79)
PREFIX_TO_NAME = {"VR": "vr", "MR": "dbz", "MD": "zdr", "MK": "kdp"}


def parse_radar_file_fast(path: str) -> Optional[np.ndarray]:
    """Parse one radar file, preferring the native C++ parser
    (``io.native.PARSES`` counts which parser served it)."""
    from ..io.native import parse_radar_file_native, served

    data = parse_radar_file_native(path)
    if data is not None:
        return data if data.shape[0] else None
    out = parse_radar_file(path)
    served("python")
    return out


def parse_radar_file(path: str) -> Optional[np.ndarray]:
    """Parse one member's radar file -> [nobs, 5] float32 or None if empty."""
    with open(path) as fh:
        first = fh.readline()
        if not first.strip():
            return None
        nobs = int(first[:10])
        if nobs <= 0:
            return None
        data = np.empty((nobs, 5), np.float32)
        for n in range(nobs):
            line = fh.readline()
            for j in range(5):
                data[n, j] = float(line[j * 11: j * 11 + 10])
    return data


def read_radar_ensemble(
    member_paths: Sequence[str],
    proj,
    *,
    max_workers: int = 8,
) -> Optional[PlatformObs]:
    """Read one retrieval type's files for all members -> PlatformObs.

    Metadata (obs value, lon/lat/alt) from the first member; per-member
    H(xb) columns stacked (the reference's iallgatherv merge,
    module_radar.f90:120-186).  ``proj`` projects in numpy, in float32.
    """
    with cf.ThreadPoolExecutor(max_workers=max_workers) as ex:
        parsed = list(ex.map(parse_radar_file_fast, member_paths))
    if parsed[0] is None:
        return None
    n = parsed[0].shape[0]
    k = len(parsed)
    obs = parsed[0][:, 0]
    lon = parsed[0][:, 2]
    lat = parsed[0][:, 3]
    alt = parsed[0][:, 4]
    hdxb = np.empty((1, n, k), np.float32)
    for m, pm in enumerate(parsed):
        if pm is None or pm.shape[0] != n:
            raise ValueError(f"member {m} radar file inconsistent")
        hdxb[0, :, m] = pm[:, 1]
    x, y = proj.lonlat_to_xy(lon, lat)
    xyz = np.stack([np.asarray(x, np.float32),
                    np.asarray(y, np.float32), alt], axis=1)
    return PlatformObs(
        xyz=xyz, obs=obs[None, :].astype(np.float32),
        error=np.ones((1, n), np.float32),
        qc=np.zeros((1, n, k), np.float32), hdxb=hdxb)


def write_radar_file(path: str, data: np.ndarray):
    """Emit a radar file (round-trip oracle; module_radar.f90:106-111)."""
    with open(path, "w") as fh:
        fh.write(f"{data.shape[0]:10d}\n")
        for row in data:
            fh.write(" ".join(f"{v:10.4f}" for v in row) + " \n")
