"""Constants the ported modules read (module_param.f90)."""
import math

# WRF microphysics scheme ids (module_param.f90:13-24)
WRF_MP_LIN = 2
WRF_MP_WSM5 = 4
WRF_MP_WSM6 = 6
WRF_MP_GSFCGCE = 7
WRF_MP_THOMPSON = 8
WRF_MP_MILBRANDT = 9
WRF_MP_MORR = 10
WRF_MP_WDM5 = 14
WRF_MP_WDM6 = 16
WRF_MP_NSSL2MOM = 17
WRF_MP_NSSL1MOM = 19
WRF_MP_NSSL2MOMG = 22

# Physical constants (module_param.f90:105-116)
D2R = math.pi / 180.0
EARTH_RADIUS = 6.37122e6
GRAVITY = 9.81
P1000MB = 100000.0
R_D = 287.0
CP = 7.0 * R_D * 0.5
CVPM = -(CP - R_D) / CP
#: Gaspari-Cohn (1999) compact-support radius in localization-normalized
#: coordinates: 2*sqrt(10/3)  (module_param.f90:116).
GC1999 = 2.0 * math.sqrt(10.0 / 3.0)
#: Squared search radius of the fixed-radius neighbor query
#: (module_localization.f90:202).
GC1999_SQ = GC1999 * GC1999
