"""Run configuration schema and Fortran-namelist importer.

Port of the JAX package's ``config.py`` (pure Python, unchanged): the
reference's ``module_config.f90`` as frozen dataclasses.  Array-valued
options (``hclr``, ``vclr``, ``is_assim``, ``multi_infl``, ``RTPP_Alpha``...)
are indexed by the *position of the analysis variable in* ``var_update``
(config.f90:59,63-68; usage at module_letkf_core.f90:68 and
module_localization.f90:74-80).  ``LetkfConfig.from_namelist`` imports the
reference's ``input.nml`` format verbatim.
"""
from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

MAX_VARS = 16  # analysis variables per run (config.f90:4)


def _floats(n: int, value: float) -> Tuple[float, ...]:
    return tuple([value] * n)


def _bools(n: int, value: bool) -> Tuple[bool, ...]:
    return tuple([value] * n)


@dataclass(frozen=True)
class GtsVarConfig:
    """Per-observed-variable knobs for a GTS platform (config.f90:16-20)."""

    err_muti: float = 1.0
    err_rej: float = 5.0
    is_assim: Tuple[bool, ...] = field(default_factory=lambda: _bools(MAX_VARS, False))


@dataclass(frozen=True)
class GtsPlatformConfig:
    """Per-platform GTS config (config.f90:28-34)."""

    use_it: bool = False
    max_lz_pts: int = 500
    hclr: Tuple[float, ...] = field(default_factory=lambda: _floats(MAX_VARS, -1.0))
    vclr: Tuple[float, ...] = field(default_factory=lambda: _floats(MAX_VARS, -1.0))
    u: GtsVarConfig = field(default_factory=GtsVarConfig)
    v: GtsVarConfig = field(default_factory=GtsVarConfig)
    t: GtsVarConfig = field(default_factory=GtsVarConfig)
    p: GtsVarConfig = field(default_factory=GtsVarConfig)
    q: GtsVarConfig = field(default_factory=GtsVarConfig)
    tpw: GtsVarConfig = field(default_factory=GtsVarConfig)
    ref: GtsVarConfig = field(default_factory=GtsVarConfig)

    def var(self, name: str) -> GtsVarConfig:
        return getattr(self, name)


@dataclass(frozen=True)
class RadarVarConfig:
    """Per-radar-retrieval config (config.f90:7-14)."""

    use_it: bool = False
    max_lz_pts: int = 500
    error: float = 1.0
    err_rej: float = 5.0
    hclr: Tuple[float, ...] = field(default_factory=lambda: _floats(MAX_VARS, -1.0))
    vclr: Tuple[float, ...] = field(default_factory=lambda: _floats(MAX_VARS, -1.0))


@dataclass(frozen=True)
class RadarConfig:
    """All four radar retrievals (config.f90:24-26)."""

    dbz: RadarVarConfig = field(default_factory=RadarVarConfig)
    vr: RadarVarConfig = field(default_factory=RadarVarConfig)
    zdr: RadarVarConfig = field(default_factory=RadarVarConfig)
    kdp: RadarVarConfig = field(default_factory=RadarVarConfig)

    def var(self, name: str) -> RadarVarConfig:
        return getattr(self, name)


@dataclass(frozen=True)
class ProjectionConfig:
    """Lambert conformal parameters (config.f90:71-75)."""

    cen_lon: float = 120.814
    cen_lat: float = 23.7644
    truelat1: float = 10.0
    truelat2: float = 40.0
    sta_lon: float = 120.0


@dataclass(frozen=True)
class InflationConfig:
    """Per-analysis-variable inflation (config.f90:63-68)."""

    multi_infl: Tuple[float, ...] = field(default_factory=lambda: _floats(MAX_VARS, 1.0))
    use_rtps: Tuple[bool, ...] = field(default_factory=lambda: _bools(MAX_VARS, False))
    rtps_alpha: Tuple[float, ...] = field(default_factory=lambda: _floats(MAX_VARS, 0.85))
    use_rtpp: Tuple[bool, ...] = field(default_factory=lambda: _bools(MAX_VARS, False))
    rtpp_alpha: Tuple[float, ...] = field(default_factory=lambda: _floats(MAX_VARS, 0.85))


@dataclass(frozen=True)
class LetkfConfig:
    """Full run configuration: the four namelist groups of config.f90:83-113."""

    # --- control (config.f90:46-59)
    nmember: int = -1
    var_update: Tuple[str, ...] = ()
    weight_function: int = 0       # 0: Gaussian, 1: Gaspari-Cohn 1999
    norain_value: float = -5.0
    write_analy_mean: bool = True
    deterministic_update: bool = False
    wrf_mp_physics: int = -1
    wrf_mp_hail_opt: int = -1
    wrf_hypsometric_opt: int = 2
    nt2log: bool = False
    nt2dm: bool = False
    nt2d0: bool = False
    nt2de: bool = False
    nt2d6: bool = False

    # --- projection
    projection: ProjectionConfig = field(default_factory=ProjectionConfig)

    # --- observations
    radar: RadarConfig = field(default_factory=RadarConfig)
    synop: GtsPlatformConfig = field(default_factory=GtsPlatformConfig)
    ships: GtsPlatformConfig = field(default_factory=GtsPlatformConfig)
    metar: GtsPlatformConfig = field(default_factory=GtsPlatformConfig)
    sound: GtsPlatformConfig = field(default_factory=GtsPlatformConfig)
    gpspw: GtsPlatformConfig = field(default_factory=GtsPlatformConfig)

    # --- inflation
    inflation: InflationConfig = field(default_factory=InflationConfig)

    # --- extensions of the JAX package (no reference equivalent)
    solver_dtype: str = "float32"    # "float32" | "float64" (parity mode)
    #: float32 normal-term accumulation precision of the JAX package: "high"
    #: (bf16_3x there) or "highest" (full float32).  The port accepts both
    #: names and accumulates in full float32 under either (TF32 is off,
    #: :mod:`.device`, and CUDA cores have no bf16_3x).
    accum_precision: str = "high"
    grid_chunk: int = 1024           # analysis points per on-device batch
    #: Reproduce the reference's U/V stagger behavior: only the unstaggered
    #: (nx, ny) extent is analyzed and the staggered extra column/row keeps
    #: its background (letkf_core.f90:188-206,209-210).  False analyzes every
    #: staggered point (clean mode).  Default True for reference parity.
    replicate_stagger_quirk: bool = True

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.nmember == -1:
            raise ValueError(
                "Please input ensemble size in control_nml: nmember"
            )  # config.f90:146

    @property
    def nvars(self) -> int:
        """Number of active analysis variables (driver loop bound,
        module_letkf_core.f90:59-60)."""
        return len(self.var_update)

    def gts_platform(self, name: str) -> GtsPlatformConfig:
        return getattr(self, name)

    # ------------------------------------------------------------------
    @staticmethod
    def from_namelist(path_or_text: str) -> "LetkfConfig":
        """Import a reference-format ``input.nml`` (config.f90:79-148)."""
        if "\n" in path_or_text or "&" == path_or_text.lstrip()[:1]:
            text = path_or_text
        else:
            with open(path_or_text) as fh:
                text = fh.read()
        groups = parse_namelist(text)
        return _config_from_groups(groups)

    def replace(self, **kw) -> "LetkfConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Fortran namelist parsing
# ---------------------------------------------------------------------------
_TOKEN_RE = re.compile(
    r"""
    '(?:[^']|'')*'          # single-quoted string
    | "(?:[^"]|"")*"        # double-quoted string
    | [^\s,]+               # bare token
    """,
    re.VERBOSE,
)


def _parse_value_token(tok: str):
    tok = tok.strip()
    if tok.startswith("'") or tok.startswith('"'):
        return tok[1:-1]
    low = tok.lower().rstrip(",")
    if low in (".true.", "t", "true"):
        return True
    if low in (".false.", "f", "false"):
        return False
    # repeat syntax: 3*1.5
    m = re.fullmatch(r"(\d+)\*(.*)", tok)
    if m:
        return [("__repeat__", int(m.group(1)), _parse_value_token(m.group(2)))]
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok.replace("d", "e").replace("D", "E"))
    except ValueError:
        return tok


def parse_namelist(text: str) -> Dict[str, Dict[str, list]]:
    """Parse Fortran namelist text into {group: {key: [values...]}}.

    Keys are lowercased with ``%`` component separators normalized to ``.``
    and whitespace removed (``radar_nml % dbz % use_it`` ->
    ``radar_nml.dbz.use_it``).  Handles comments (``!``), ``T``/``F``
    logicals, ``n*v`` repeats and multi-line arrays.
    """
    groups: Dict[str, Dict[str, list]] = {}
    current: Optional[Dict[str, list]] = None
    current_key: Optional[str] = None

    for raw_line in text.splitlines():
        line = raw_line.split("!")[0].strip()
        if not line:
            continue
        if line.startswith("&"):
            gname = line[1:].strip().lower()
            groups.setdefault(gname, {})
            current = groups[gname]
            current_key = None
            continue
        if line == "/" or line.startswith("/"):
            current = None
            current_key = None
            continue
        if current is None:
            continue
        # may contain one or more `key = values` segments; assume one per line
        if "=" in line:
            key_part, _, val_part = line.partition("=")
            key = re.sub(r"\s+", "", key_part).replace("%", ".").lower()
            current_key = key
            current[key] = []
        else:
            val_part = line
            if current_key is None:
                continue
        for tok in _TOKEN_RE.findall(val_part):
            v = _parse_value_token(tok)
            if isinstance(v, list) and v and v[0][0] == "__repeat__":
                _, n, rv = v[0]
                current[current_key].extend([rv] * n)
            else:
                current[current_key].append(v)
    return groups


def _scalar(vals: list, default):
    if not vals:
        return default
    return vals[0]


def _vec(vals: list, default_each, n: int = MAX_VARS) -> tuple:
    out = list(vals[:n])
    while len(out) < n:
        out.append(default_each)
    return tuple(out)


def _gts_var_from(g: Dict[str, list], prefix: str) -> GtsVarConfig:
    d = GtsVarConfig()
    return GtsVarConfig(
        err_muti=float(_scalar(g.get(f"{prefix}.err_muti", []), d.err_muti)),
        err_rej=float(_scalar(g.get(f"{prefix}.err_rej", []), d.err_rej)),
        is_assim=_vec(g.get(f"{prefix}.is_assim", []), False),
    )


def _gts_platform_from(g: Dict[str, list], nml: str) -> GtsPlatformConfig:
    d = GtsPlatformConfig()
    return GtsPlatformConfig(
        use_it=bool(_scalar(g.get(f"{nml}.use_it", []), d.use_it)),
        max_lz_pts=int(_scalar(g.get(f"{nml}.max_lz_pts", []), d.max_lz_pts)),
        hclr=_vec(g.get(f"{nml}.hclr", []), -1.0),
        vclr=_vec(g.get(f"{nml}.vclr", []), -1.0),
        **{vn: _gts_var_from(g, f"{nml}.{vn}")
           for vn in ("u", "v", "t", "p", "q", "tpw", "ref")},
    )


def _radar_var_from(g: Dict[str, list], prefix: str) -> RadarVarConfig:
    d = RadarVarConfig()
    return RadarVarConfig(
        use_it=bool(_scalar(g.get(f"{prefix}.use_it", []), d.use_it)),
        max_lz_pts=int(_scalar(g.get(f"{prefix}.max_lz_pts", []), d.max_lz_pts)),
        error=float(_scalar(g.get(f"{prefix}.error", []), d.error)),
        err_rej=float(_scalar(g.get(f"{prefix}.err_rej", []), d.err_rej)),
        hclr=_vec(g.get(f"{prefix}.hclr", []), -1.0),
        vclr=_vec(g.get(f"{prefix}.vclr", []), -1.0),
    )


def _config_from_groups(groups: Dict[str, Dict[str, list]]) -> LetkfConfig:
    ctl = groups.get("control", {})
    proj = groups.get("projection", {})
    obs = groups.get("observations", {})
    infl = groups.get("inflation", {})

    var_update = tuple(
        str(v).strip() for v in ctl.get("var_update", []) if str(v).strip()
    )

    dp = ProjectionConfig()
    di = InflationConfig()
    dc = LetkfConfig.__dataclass_fields__

    return LetkfConfig(
        nmember=int(_scalar(ctl.get("nmember", []), -1)),
        var_update=var_update,
        weight_function=int(_scalar(ctl.get("weight_function", []), 0)),
        norain_value=float(_scalar(ctl.get("norain_value", []), -5.0)),
        write_analy_mean=bool(_scalar(ctl.get("write_analy_mean", []), True)),
        deterministic_update=bool(
            _scalar(ctl.get("deterministic_update", []), False)),
        wrf_mp_physics=int(_scalar(ctl.get("wrf_mp_physics", []), -1)),
        wrf_mp_hail_opt=int(_scalar(ctl.get("wrf_mp_hail_opt", []), -1)),
        wrf_hypsometric_opt=int(
            _scalar(ctl.get("wrf_hypsometric_opt", []), 2)),
        nt2log=bool(_scalar(ctl.get("nt2log", []), False)),
        nt2dm=bool(_scalar(ctl.get("nt2dm", []), False)),
        nt2d0=bool(_scalar(ctl.get("nt2d0", []), False)),
        nt2de=bool(_scalar(ctl.get("nt2de", []), False)),
        nt2d6=bool(_scalar(ctl.get("nt2d6", []), False)),
        projection=ProjectionConfig(
            cen_lon=float(_scalar(proj.get("cen_lon", []), dp.cen_lon)),
            cen_lat=float(_scalar(proj.get("cen_lat", []), dp.cen_lat)),
            truelat1=float(_scalar(proj.get("truelat1", []), dp.truelat1)),
            truelat2=float(_scalar(proj.get("truelat2", []), dp.truelat2)),
            sta_lon=float(_scalar(proj.get("sta_lon", []), dp.sta_lon)),
        ),
        radar=RadarConfig(
            dbz=_radar_var_from(obs, "radar_nml.dbz"),
            vr=_radar_var_from(obs, "radar_nml.vr"),
            zdr=_radar_var_from(obs, "radar_nml.zdr"),
            kdp=_radar_var_from(obs, "radar_nml.kdp"),
        ),
        synop=_gts_platform_from(obs, "synop_nml"),
        ships=_gts_platform_from(obs, "ships_nml"),
        metar=_gts_platform_from(obs, "metar_nml"),
        sound=_gts_platform_from(obs, "sound_nml"),
        gpspw=_gts_platform_from(obs, "gpspw_nml"),
        inflation=InflationConfig(
            multi_infl=_vec(infl.get("multi_infl", []), 1.0),
            use_rtps=_vec(infl.get("use_rtps", []), False),
            rtps_alpha=_vec(infl.get("rtps_alpha", []), 0.85),
            use_rtpp=_vec(infl.get("use_rtpp", []), False),
            rtpp_alpha=_vec(infl.get("rtpp_alpha", []), 0.85),
        ),
    )
