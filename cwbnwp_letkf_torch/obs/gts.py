"""WRFDA "gts_omboma" conventional-obs parser + station-altitude lookup.

Port of the JAX package's ``obs/gts.py`` (numpy only), which re-designs
``module_gts_omboma.f90``.
The reference has every rank read its own member's text file and merge the
per-member ``omb`` columns with ``mpi_iallgatherv`` (gts_omboma.f90:508-611);
here a thread pool reads all member files and stacks the member axis
directly.

File format (gts_omboma.f90:93,132,135): repeated platform sections

    <iv_type:a20><nobs:i8>
    then per report: <nlev:i8><nreq:i8>
    then per level, one fixed-width record line
    '(2i8,a5,2f9.2,f17.7,5(2f17.7,i8,2f17.7))':
      kk(i8) l(i8) id(a5) lat(f9.2) lon(f9.2) pre(f17.7)
      then per observed variable: obs(f17.7) omb(f17.7) qc(i8) err(f17.7) oma(f17.7)

Platform families and their variable counts (gts_omboma.f90:101-500):
surface (synop/ships/buoy/metar/sonde_sfc/tamdar_sfc): 5 vars, 1 level/report;
wind-profile (pilot/profiler/geoamv/qscat/polaramv): 2 vars, multi-level;
gpspw: 1 var (the f17.7 slot holds altitude, not pressure);
upper-air (sound/tamdar/airep): 4 vars, multi-level;
gpsref: 1 var (slot holds altitude).

``hdxb = obs - omb`` (the file stores omb = obs - H(xb); gts_omboma.f90:171).
Station altitude comes from a string-ID join against the WRFDA ``obs_gts``
ASCII file (read_alt_info / get_alt, gts_omboma.f90:704-1049).
"""
from __future__ import annotations

import concurrent.futures as cf
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..constants import GtsType
from .base import PlatformObs

#: family name -> (obs_type enum, nvar, multi-level?, slot-is-altitude?)
FAMILY = {
    "synop": (GtsType.SYNOP, 5, False, False),
    "ships": (GtsType.SHIPS, 5, False, False),
    "buoy": (GtsType.BUOY, 5, False, False),
    "metar": (GtsType.METAR, 5, False, False),
    "sonde_sfc": (GtsType.SONDE_SFC, 5, False, False),
    "tamdar_sfc": (GtsType.TAMDAR_SFC, 5, False, False),
    "pilot": (GtsType.PILOT, 2, True, False),
    "profiler": (GtsType.PROFILER, 2, True, False),
    "geoamv": (GtsType.GEOAMV, 2, True, False),
    "qscat": (GtsType.QSCAT, 2, True, False),
    "polaramv": (GtsType.POLARAMV, 2, True, False),
    "gpspw": (GtsType.GPSPW, 1, False, True),
    "sound": (GtsType.SOUND, 4, True, False),
    "tamdar": (GtsType.TAMDAR, 4, True, False),
    "airep": (GtsType.AIREP, 4, True, False),
    "gpsref": (GtsType.GPSREF, 1, True, True),
}


@dataclass
class GtsRecords:
    """Parsed records of one platform from one member file."""

    ids: List[str] = field(default_factory=list)
    lat: List[float] = field(default_factory=list)
    lon: List[float] = field(default_factory=list)
    pre: List[float] = field(default_factory=list)   # pressure (or altitude)
    obs: List[List[float]] = field(default_factory=list)    # [nvar] per rec
    omb: List[List[float]] = field(default_factory=list)
    qc: List[List[int]] = field(default_factory=list)
    err: List[List[float]] = field(default_factory=list)
    #: per-record level index within its report (1-based) for get_alt
    level: List[int] = field(default_factory=list)


def _parse_record_line(line: str, nvar: int):
    """One fixed-width record line -> (id, lat, lon, slot, per-var tuples)."""
    # widths: 8,8,5,9,9,17 then nvar * (17,17,8,17,17)
    ident = line[16:21]
    lat = float(line[21:30])
    lon = float(line[30:39])
    slot = float(line[39:56])
    pos = 56
    obs, omb, qc, err = [], [], [], []
    for _ in range(nvar):
        obs.append(float(line[pos:pos + 17])); pos += 17
        omb.append(float(line[pos:pos + 17])); pos += 17
        qc.append(int(line[pos:pos + 8])); pos += 8
        err.append(float(line[pos:pos + 17])); pos += 17
        pos += 17  # oma, unused (gts_omboma.f90 reads into scratch)
    return ident, lat, lon, slot, obs, omb, qc, err


def parse_member_file_fast(path: str):
    """Parse one member file, preferring the native C++ parser.

    Returns ``{family: records}`` where records are either
    :class:`~cwbnwp_letkf_torch.io.native.NativeGtsFamily` (flat numpy
    arrays) or :class:`GtsRecords` — both duck-type for
    :func:`read_gts_ensemble`.  ``io.native.PARSES`` counts which parser
    served the file.
    """
    from ..io.native import parse_member_file_native, served

    native = parse_member_file_native(path)
    if native is not None:
        return native
    out = parse_member_file(path)
    served("python")
    return out


def parse_member_file(path: str) -> Dict[str, GtsRecords]:
    """Parse one member's gts_omboma file into per-family records."""
    out: Dict[str, GtsRecords] = {}
    with open(path) as fh:
        lines = fh.read().splitlines()
    i = 0
    n_lines = len(lines)
    while i < n_lines:
        header = lines[i]; i += 1
        if not header.strip():
            continue
        name = header[:20].strip().lower()
        nobs = int(header[20:28])
        fam = FAMILY.get(name)
        if fam is None or nobs <= 0:
            continue
        _, nvar, multilevel, _ = fam
        rec = out.setdefault(name, GtsRecords())
        for _ in range(nobs):
            hdr = lines[i]; i += 1
            nlev = int(hdr[:8])
            for lev in range(nlev):
                (ident, lat, lon, slot, obs, omb, qc, err) = \
                    _parse_record_line(lines[i], nvar)
                i += 1
                rec.ids.append(ident.strip())
                rec.lat.append(lat)
                rec.lon.append(lon)
                rec.pre.append(slot)
                rec.obs.append(obs)
                rec.omb.append(omb)
                rec.qc.append(qc)
                rec.err.append(err)
                rec.level.append(lev + 1)
    return out


# ---------------------------------------------------------------------------
# obs_gts station-altitude file (read_alt_info, gts_omboma.f90:704-1030)
# ---------------------------------------------------------------------------

#: WMO FM code -> (platform enum, single-level?, altitude-from-header?)
_FM_TABLE = {
    **{12: (GtsType.SYNOP, True, False)},
    **{fm: (GtsType.SHIPS, True, False) for fm in (13, 17)},
    **{fm: (GtsType.METAR, True, False) for fm in (15, 16)},
    **{fm: (GtsType.PILOT, False, False) for fm in (32, 33, 34)},
    **{fm: (GtsType.SOUND, False, False) for fm in (35, 36, 37, 38)},
    **{101: (GtsType.TAMDAR, False, False)},
    **{161: (GtsType.MTGIRS, False, False)},
    **{86: (GtsType.SATEM, False, False)},
    **{fm: (GtsType.AIREP, False, False) for fm in (42, 96, 97)},
    **{fm: (GtsType.GPSPW, True, True) for fm in (111, 114)},
    **{116: (GtsType.GPSREF, True, False)},
    **{121: (GtsType.SSMT1, False, False)},
    **{122: (GtsType.SSMT2, False, False)},
    **{281: (GtsType.QSCAT, False, False)},
    **{132: (GtsType.PROFILER, False, False)},
    **{135: (GtsType.BOGUS, False, False)},
    **{fm: (GtsType.BUOY, True, False) for fm in (18, 19)},
    **{133: (GtsType.AIRSR, False, False)},
}


class AltTable:
    """Station-ID -> per-level altitude lookup for each platform."""

    def __init__(self):
        self._tab: Dict[GtsType, Dict[str, List[float]]] = {}

    def add(self, platform: GtsType, ident: str, alts: List[float]):
        self._tab.setdefault(platform, {})[ident.strip()] = alts

    def get(self, platform: GtsType, ident: str, level: int) -> float:
        """get_alt (gts_omboma.f90:1032-1049); raises KeyError if absent."""
        alts = self._tab.get(platform, {}).get(ident.strip())
        if alts is None:
            raise KeyError(
                f"station id {ident!r} not found for {platform.name} "
                "(reference aborts with 'ID not found!!')")
        return alts[min(level, len(alts)) - 1]

    def has(self, platform: GtsType) -> bool:
        return platform in self._tab


_FMT_ITEM_RE = re.compile(r"(\d*)([AIFX])(\d+)(?:\.(\d+))?", re.IGNORECASE)


def parse_fortran_format(fmt: str) -> List[Tuple[str, int]]:
    """Expand a Fortran format spec into a flat list of (kind, width) ops.

    Supports what WRFDA's obs_gts formats use (gts_omboma.f90:767-790):
    ``A/I/F/X`` edit descriptors, item repeats (``3F7.2``) and group repeats
    (``3(F12.3,I4,F7.2)``).  Kinds: "A" str, "I" int, "F" float, "X" skip.
    """
    s = fmt.strip()
    if s.startswith("(") and s.endswith(")"):
        s = s[1:-1]

    def expand(spec: str) -> List[Tuple[str, int]]:
        ops: List[Tuple[str, int]] = []
        i = 0
        while i < len(spec):
            c = spec[i]
            if c in ", ":
                i += 1
                continue
            # group repeat: <n>( ... )
            m = re.match(r"(\d*)\(", spec[i:])
            if m:
                rep = int(m.group(1)) if m.group(1) else 1
                depth = 0
                j = i + len(m.group(0)) - 1
                for j in range(j, len(spec)):
                    depth += {"(": 1, ")": -1}.get(spec[j], 0)
                    if depth == 0:
                        break
                inner = expand(spec[i + len(m.group(0)):j])
                ops.extend(inner * rep)
                i = j + 1
                continue
            # nX is written with the count BEFORE the X
            m = re.match(r"(\d+)[Xx]", spec[i:])
            if m:
                ops.append(("X", int(m.group(1))))
                i += len(m.group(0))
                continue
            m = _FMT_ITEM_RE.match(spec, i)
            if not m:
                raise ValueError(f"unsupported format item at {spec[i:]!r} "
                                 f"in {fmt!r}")
            rep = int(m.group(1)) if m.group(1) else 1
            kind = m.group(2).upper()
            width = int(m.group(3))
            ops.extend([(kind, width)] * rep)
            i = m.end()
        return ops

    return expand(s)


def read_fortran_fields(line: str, ops: List[Tuple[str, int]]):
    """Fixed-slice a line per the format ops (Fortran-style fixed reads).

    Short lines are blank-padded; all-blank numeric fields read as 0 (the
    Fortran BLANK='NULL' default).  A non-blank, non-numeric field raises —
    the reference's ``iostat > 0: stop "Problem"`` (gts_omboma.f90:777-778).
    """
    out = []
    pos = 0
    width = sum(w for _, w in ops)
    line = line.ljust(width)
    for kind, w in ops:
        field = line[pos:pos + w]
        pos += w
        if kind == "X":
            continue
        if kind == "A":
            out.append(field)
        elif field.strip() == "":
            out.append(0 if kind == "I" else 0.0)
        elif kind == "I":
            out.append(int(field))
        else:
            out.append(float(field))
    return out


def parse_obs_gts(path: str, *, on_unknown_fm: str = "raise") -> AltTable:
    """Parse the WRFDA obs_gts ASCII for station altitudes.

    Mirrors ``read_alt_info`` (gts_omboma.f90:704-901): the INFO/SRFC/EACH
    record formats are read *from the file itself* (the three ``*_FMT =``
    header lines, gts_omboma.f90:767-770) and every subsequent line is
    sliced exactly per those formats — no guessed offsets.  Per report:
    one INFO line (platform A12 -> FM code, levels I6, elevation = 3rd
    F12.3, id = trailing A40), one skipped SRFC line, then ``levels`` EACH
    lines whose 4th (F12.3,I4,F7.2) triple leads with the height
    (single-level platforms read exactly one; GPSPW takes the INFO
    elevation and reads none, gts_omboma.f90:913-921).

    ``on_unknown_fm``: "raise" (default) mirrors the reference, which falls
    out of its select-case and dies on the next misaligned read
    (``stop "Problem"``, gts_omboma.f90:777-778); "skip" drops the report by
    scanning forward to the next line that matches an FM-xx INFO header —
    an unknown FM's own line count is NOT knowable from nlev (header-
    altitude layouts like GPSPW write no EACH lines at all), so resyncing
    on the INFO pattern is the only skip that cannot desynchronize the
    cursor.  Data lines are purely numeric per the file's own formats and
    can never match the pattern.
    """
    if on_unknown_fm not in ("raise", "skip"):
        raise ValueError("on_unknown_fm must be 'raise' or 'skip'")
    table = AltTable()
    with open(path) as fh:
        lines = fh.read().splitlines()

    # skip headers until the 'EACH  ' anchor line (gts_omboma.f90:763-766)
    i = 0
    while i < len(lines) and not lines[i].startswith("EACH"):
        i += 1
    if i >= len(lines):
        raise ValueError(f"{path}: no 'EACH' header line — not an obs_gts "
                         "file (gts_omboma.f90:763-766)")
    i += 1
    # three '<NAME>_FMT  = (<fortran format>)' lines
    fmts = {}
    for _ in range(3):
        if i >= len(lines):
            raise ValueError(f"{path}: truncated format header")
        name = lines[i][:10].strip().rstrip("=").strip()
        paren = lines[i].find("(")
        if paren < 0:
            raise ValueError(f"{path}: malformed format line {lines[i]!r}")
        fmts[name.upper()] = parse_fortran_format(lines[i][paren:])
        i += 1
    info_ops = fmts.get("INFO_FMT")
    each_ops = fmts.get("EACH_FMT")
    if info_ops is None or each_ops is None:
        raise ValueError(f"{path}: missing INFO_FMT/EACH_FMT headers "
                         f"(found {sorted(fmts)})")
    i += 1  # one column-header line (gts_omboma.f90:772)

    # EACH data order: PRES, SPEED, DIR | HEIGHT, TEMP, DEW — height is the
    # 10th numeric read, i.e. the first field of the 4th triple
    _HEIGHT_SLOT = 9

    while i < len(lines):
        line = lines[i]
        if not line.strip():
            i += 1
            continue
        info = read_fortran_fields(line, info_ops)
        platform_str = info[0]            # A12, e.g. 'FM-12 SYNOP '
        nlev = int(info[3])               # I6
        elv = float(info[6])              # 3rd F12.3
        ident = info[7].strip()           # trailing A40
        m = re.match(r"\s*FM-?\s*(\d+)", platform_str)
        if not m:
            raise ValueError(
                f"{path}:{i + 1}: expected an FM-xx INFO line, got "
                f"{platform_str!r} (gts_omboma.f90:784-790)")
        fm = int(m.group(1))

        entry = _FM_TABLE.get(fm)
        i += 1  # past INFO
        if entry is None:
            if on_unknown_fm == "raise":
                raise ValueError(
                    f"{path}:{i}: unknown FM code {fm} (the reference's "
                    "select-case has no branch for it and aborts on the "
                    "next read, gts_omboma.f90:777-778); pass "
                    "on_unknown_fm='skip' to drop such reports")
            # resync on the next INFO line: nlev does NOT give this
            # report's line count (header-altitude platforms write SRFC
            # only, no EACH lines), so a count-based skip could
            # desynchronize every report after it
            while i < len(lines) and not re.match(r"\s*FM-?\s*\d+",
                                                  lines[i]):
                i += 1
            continue
        platform, single, alt_from_header = entry
        i += 1  # skip the SRFC line (gts_omboma.f90:798 etc.)
        alts: List[float] = []
        if alt_from_header:
            alts = [elv]                  # GPSPW: no EACH lines read
        else:
            count = 1 if single else max(nlev, 1)
            for _ in range(count):
                if i >= len(lines):
                    raise ValueError(
                        f"{path}: truncated report for {ident!r} "
                        f"(expected {count} level lines)")
                fields = read_fortran_fields(lines[i], each_ops)
                alts.append(float(fields[_HEIGHT_SLOT]))
                i += 1
        if ident:
            table.add(platform, ident, alts if alts else [0.0])
    return table


# ---------------------------------------------------------------------------
# ensemble assembly
# ---------------------------------------------------------------------------

def read_gts_ensemble(
    member_paths: Sequence[str],
    proj,
    alt_table: Optional[AltTable] = None,
    *,
    max_workers: int = 8,
) -> Dict[str, PlatformObs]:
    """Read all members' omboma files -> {family: PlatformObs}.

    Observation metadata (ids, coords, obs, error) is taken from the first
    member; per-member omb columns become ``hdxb[..., m] = obs - omb``
    (gts_omboma.f90:171) and per-member qc columns are kept (the solver's
    gate is any-member qc >= 0, letkf_core.f90:429).

    Station altitudes come from ``alt_table`` (the obs_gts join,
    gts_omboma.f90:1032-1049).  When a table is given, a family or station
    id absent from it RAISES — the reference aborts with "ID not found!!".
    ``alt_table=None`` (no obs_gts file at
    all) keeps the toy-case behavior of altitude 0 — the reference cannot
    even start in that situation.  ``proj`` projects in numpy, in the
    float32 of the parsed coordinates.
    """
    with cf.ThreadPoolExecutor(max_workers=max_workers) as ex:
        parsed = list(ex.map(parse_member_file_fast, member_paths))
    k = len(parsed)
    out: Dict[str, PlatformObs] = {}
    for name, rec0 in parsed[0].items():
        fam = FAMILY[name]
        obs_type, nvar, _, slot_is_alt = fam
        n = len(rec0.ids)
        obs = np.asarray(rec0.obs, np.float32).T             # [nvar, n]
        err = np.asarray(rec0.err, np.float32).T
        hdxb = np.empty((nvar, n, k), np.float32)
        qc = np.empty((nvar, n, k), np.float32)
        for m, pm in enumerate(parsed):
            rm = pm.get(name)
            if rm is None or len(rm.ids) != n:
                raise ValueError(
                    f"member {m} has inconsistent obs count for {name}")
            omb = np.asarray(rm.omb, np.float32).T
            hdxb[:, :, m] = obs - omb
            qc[:, :, m] = np.asarray(rm.qc, np.float32).T
        lat = np.asarray(rec0.lat, np.float32)
        lon = np.asarray(rec0.lon, np.float32)
        if slot_is_alt:
            alt = np.asarray(rec0.pre, np.float32)
        elif alt_table is not None:
            if not alt_table.has(obs_type):
                raise KeyError(
                    f"obs_gts has no altitude entries for {obs_type.name} "
                    f"but {name!r} reports are present (the reference "
                    "aborts: gts_omboma.f90:1046)")
            alt = np.asarray(
                [alt_table.get(obs_type, i, l)
                 for i, l in zip(rec0.ids, rec0.level)], np.float32)
        else:
            alt = np.zeros(n, np.float32)
        x, y = proj.lonlat_to_xy(lon, lat)
        xyz = np.stack([np.asarray(x, np.float32),
                        np.asarray(y, np.float32), alt], axis=1)
        out[name] = PlatformObs(xyz=xyz, obs=obs, error=err, qc=qc,
                                hdxb=hdxb)
    return out


# ---------------------------------------------------------------------------
# writer (round-trip oracle, the reference's write_gts echo hooks)
# ---------------------------------------------------------------------------

def write_member_file(path: str, families: Dict[str, GtsRecords]):
    """Emit a gts_omboma-format file, including multi-level reports.

    Mirrors the reference's echo writer (write_gts_omboma,
    gts_omboma.f90:613-702): per family a ``(a20,i8)`` header whose count
    is the number of REPORTS, then per report a ``(2i8)`` nlev/nreq line
    and nlev record lines in the
    ``(2i8,a5,2f9.2,f17.7,5(2f17.7,i8,2f17.7))`` layout.  Flattened
    :class:`GtsRecords` levels are regrouped into reports wherever
    ``level`` restarts at 1 (the inverse of :func:`parse_member_file`).
    """
    with open(path, "w") as fh:
        for name, rec in families.items():
            nvar = FAMILY[name][1]
            n = len(rec.ids)
            levels = rec.level if rec.level else [1] * n
            reports: List[List[int]] = []
            for r in range(n):
                if levels[r] == 1 or not reports:
                    reports.append([])
                reports[-1].append(r)
            fh.write(f"{name:<20s}{len(reports):8d}\n")
            for rep in reports:
                fh.write(f"{len(rep):8d}{nvar:8d}\n")
                for li, r in enumerate(rep):
                    parts = [f"{len(rep):8d}{li + 1:8d}{rec.ids[r]:<5.5s}"
                             f"{rec.lat[r]:9.2f}{rec.lon[r]:9.2f}"
                             f"{rec.pre[r]:17.7f}"]
                    for v in range(nvar):
                        parts.append(
                            f"{rec.obs[r][v]:17.7f}{rec.omb[r][v]:17.7f}"
                            f"{rec.qc[r][v]:8d}{rec.err[r][v]:17.7f}"
                            f"{0.0:17.7f}")
                    fh.write("".join(parts) + "\n")
