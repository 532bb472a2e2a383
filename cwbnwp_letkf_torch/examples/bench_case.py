"""The bench case of the JAX package's ``bench.py``, built by the port.

The production-grouped 16-variable cycle at k=40 on a 128x128x20 idealized
grid at dx = 10 km (327,680 points): synop 2,000 records x 5 observed
variables (cap 100), vr 20,000 (cap 300) and dbz 20,000 (cap 300), the
radii of the production namelist's five variable groups, inflation 1.6 for
the dynamics and 1.1 for the moisture, RTPP = RTPS = 0.95 (bench.py:47-112,
141-152).  numpy only: the same seed gives the same arrays, bit for bit, as
``bench.build_case()``.
"""
from __future__ import annotations

import numpy as np

K = 40
N_VARS = 16        # the production cycle updates 16 variables (input.nml:7)

#: var_update positions (input.nml:7):
#: 0:U 1:V 2:W 3:T 4:QVAPOR 5-12:hydrometeors 13:MU 14:P 15:PH
HYDRO = tuple(range(5, 13))

#: production variable groups by localization signature (input.nml:38-55):
#: (name, ivars, per-platform radii {platform: (hclr km, vclr km)})
PROD_GROUPS = (
    ("UV",    (0, 1),   {"synop": (50.0, 3.0), "vr": (36.0, 3.0)}),
    ("W",     (2,),     {"synop": (50.0, 3.0), "vr": (12.0, 3.0)}),
    ("TQv",   (3, 4),   {"synop": (50.0, 3.0), "vr": (24.0, 3.0)}),
    ("hydro", HYDRO,    {"dbz": (8.0, 2.0)}),
    ("MuPPh", (13, 14, 15), {"synop": (50.0, -1.0), "vr": (24.0, -1.0)}),
)

#: multiplicative inflation (input.nml:160-170): 1.6 dynamics, 1.1 moisture
MULTI_INFL = tuple(1.1 if i >= 4 else 1.6 for i in range(N_VARS))
RTPP = 0.95
RTPS = 0.95

#: per platform: (name, records, observed variables, cap, obs error)
PLATFORMS = (("synop", 2000, 5, 100, 0.5),
             ("vr", 20000, 1, 300, 1.0),
             ("dbz", 20000, 1, 300, 2.5))

#: the fused cycle's solve batch and accumulation sub-chunk
CHUNK = 4096
SUBCHUNK = 512


def build_case():
    """``(pts [B, 3], xb [B, K], [(PlatformStatic, PlatformObs)])``, seed 0.

    Observations cover the whole domain (``extent_frac=1.0``), so spatial
    culling behaves as it would on the production domain, whose extent
    (450 x 3 km) this grid matches.
    """
    from ..config import MAX_VARS
    from ..obs.base import PlatformStatic
    from ..obs.synthetic import (correlated_ensemble, idealized_grid,
                                 synthetic_gts_platform)

    rng = np.random.default_rng(0)
    pts = idealized_grid(128, 128, 20, dx_m=10e3)
    truth, xb = correlated_ensemble(rng, pts, K, n_bumps=8, length_m=1.5e5)

    def radii(plat):
        h = [-1.0] * MAX_VARS
        v = [-1.0] * MAX_VARS
        for _, ivars, rmap in PROD_GROUPS:
            if plat in rmap:
                for iv in ivars:
                    h[iv], v[iv] = rmap[plat]
        return tuple(h), tuple(v)

    plats = []
    for name, nobs, nvar, cap, err in PLATFORMS:
        st0, po = synthetic_gts_platform(
            rng, pts, truth, xb, name=name, nobs=nobs, nvar=nvar,
            obs_err=err, max_lz_pts=cap, extent_frac=1.0)
        h, v = radii(name)
        st = PlatformStatic(
            name=name, kind=st0.kind, nvar=nvar, max_lz_pts=cap,
            hclr=h, vclr=v, err_muti=st0.err_muti, err_rej=st0.err_rej,
            is_assim=st0.is_assim)
        plats.append((st, po))
    return pts, xb, plats


def prod_cycle_groups():
    """The five production groups as the port's ``cycle.CycleGroup``s."""
    from ..ops.cycle import CycleGroup

    return tuple(
        CycleGroup(ivars=ivars,
                   inflats=tuple((K - 1) / MULTI_INFL[iv] for iv in ivars),
                   rtpp_alpha=(RTPP,) * len(ivars),
                   rtps_alpha=(RTPS,) * len(ivars))
        for _, ivars, _ in PROD_GROUPS)
