"""Analysis-variable registry: stagger rules and moisture tagging.

Port of the JAX package's ``models/variables.py`` (unchanged): the
dispatch tables of ``letkf_driver`` (module_letkf_core.f90:74-162,243-291):
which state array
each ``var_update`` name addresses, its horizontal stagger (0 none, 1 U,
2 V) and vertical stagger (0 mass levels, 1 w levels, -1 surface/2-D), and
whether the positivity fix ``tune_q`` applies after its update
(letkf_core.f90:252-278).
"""
from __future__ import annotations

from typing import Dict, NamedTuple


class VarSpec(NamedTuple):
    field: str   # attribute key in WrfEnsemble.fields
    hstag: int   # 0: none, 1: U (nx+1), 2: V (ny+1)
    vstag: int   # 0: mass, 1: w/ph (nz+1), -1: 2-D (MU)
    tune_q: bool


VAR_TABLE: Dict[str, VarSpec] = {
    "U":         VarSpec("u", 1, 0, False),
    "V":         VarSpec("v", 2, 0, False),
    "W":         VarSpec("w", 0, 1, False),
    "T":         VarSpec("t", 0, 0, False),
    "P":         VarSpec("p", 0, 0, False),       # full pressure
    "PH":        VarSpec("ph", 0, 1, False),      # full geopotential
    "MU":        VarSpec("mu", 0, -1, False),     # full dry-air mass
    "QVAPOR":    VarSpec("qv", 0, 0, True),
    "QRAIN":     VarSpec("qr", 0, 0, True),
    "QSNOW":     VarSpec("qs", 0, 0, True),
    "QGRAUP":    VarSpec("qg", 0, 0, True),
    "QHAIL":     VarSpec("qh", 0, 0, True),
    "QNRAIN":    VarSpec("nqr", 0, 0, True),
    "QNSNOW":    VarSpec("nqs", 0, 0, True),
    "QNGRAUPEL": VarSpec("nqg", 0, 0, True),
    "QNHAIL":    VarSpec("nqh", 0, 0, True),
}


def is_moisture_var(name: str) -> bool:
    spec = VAR_TABLE.get(name)
    return bool(spec and spec.tune_q)
