"""Constants of the reference (module_param.f90)."""
import enum
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


class GtsType(enum.IntEnum):
    """Conventional (GTS) observation platform ids (module_param.f90:28-57).

    Values match the reference's 1-based Fortran enums so that parsed files,
    debug dumps and config tables line up exactly.
    """

    SOUND = 1
    SYNOP = 2
    PILOT = 3
    SATEM = 4
    GEOAMV = 5
    POLARAMV = 6
    AIREP = 7
    GPSPW = 8
    GPSREF = 9
    METAR = 10
    SHIPS = 11
    SSMI_RV = 12
    SSMI_TB = 13
    SSMT1 = 14
    SSMT2 = 15
    QSCAT = 16
    PROFILER = 17
    BUOY = 18
    BOGUS = 19
    PSEUDO = 20
    RADAR = 21
    RADIANCE = 22
    AIRSR = 23
    SONDE_SFC = 24
    MTGIRS = 25
    TAMDAR = 26
    TAMDAR_SFC = 27
    RAIN = 28
    GPSEPH = 29


NUM_GTS_INDEXES = 29

GTS_NAMES = {
    GtsType.SOUND: "sound",
    GtsType.SYNOP: "synop",
    GtsType.PILOT: "pilot",
    GtsType.SATEM: "satem",
    GtsType.GEOAMV: "geoamv",
    GtsType.POLARAMV: "polaramv",
    GtsType.AIREP: "airep",
    GtsType.GPSPW: "gpspw",
    GtsType.GPSREF: "gpsrf",
    GtsType.METAR: "metar",
    GtsType.SHIPS: "ships",
    GtsType.SSMI_RV: "ssmi_rv",
    GtsType.SSMI_TB: "ssmi_tb",
    GtsType.SSMT1: "ssmt1",
    GtsType.SSMT2: "ssmt2",
    GtsType.QSCAT: "qscat",
    GtsType.PROFILER: "profiler",
    GtsType.BUOY: "buoy",
    GtsType.BOGUS: "bogus",
    GtsType.PSEUDO: "pseudo",
    GtsType.RADAR: "radar",
    GtsType.RADIANCE: "radiance",
    GtsType.AIRSR: "airs retrieval",
    GtsType.SONDE_SFC: "sonde_sfc",
    GtsType.MTGIRS: "mtgirs",
    GtsType.TAMDAR: "tamdar",
    GtsType.TAMDAR_SFC: "tamdar_sfc",
    GtsType.RAIN: "rain",
    GtsType.GPSEPH: "gpseph",
}


class RadarType(enum.IntEnum):
    """Radar retrieval types (module_param.f90:93-100)."""

    DBZ = 1  # reflectivity ("MR" files)
    VR = 2   # radial velocity ("VR" files)
    ZDR = 3  # differential reflectivity ("MD" files)
    KDP = 4  # specific differential phase ("MK" files)


NUM_RADAR_INDEXES = 4
RADAR_NAMES = {RadarType.DBZ: "MR", RadarType.VR: "VR",
               RadarType.ZDR: "ZDR", RadarType.KDP: "KDP"}

# Observed quantities per GTS platform family
# (module_gts_omboma.f90:101-500 allocation shapes).
GTS_NVAR = {
    GtsType.SYNOP: 5, GtsType.SHIPS: 5, GtsType.BUOY: 5, GtsType.METAR: 5,
    GtsType.SONDE_SFC: 5, GtsType.TAMDAR_SFC: 5,       # u, v, t, p, q
    GtsType.PILOT: 2, GtsType.PROFILER: 2, GtsType.GEOAMV: 2,
    GtsType.QSCAT: 2, GtsType.POLARAMV: 2,             # u, v
    GtsType.GPSPW: 1,                                  # tpw
    GtsType.SOUND: 4, GtsType.TAMDAR: 4, GtsType.AIREP: 4,  # u, v, t, q
    GtsType.GPSREF: 1,                                 # refractivity
}

# Observed-variable names per platform family, in file/column order
# (letkf_yoyb's is_assim/err tables, module_letkf_core.f90:349-418).
GTS_VAR_NAMES = {
    5: ("u", "v", "t", "p", "q"),
    4: ("u", "v", "t", "q"),
    2: ("u", "v"),
}

# The GTS platforms the solver assimilates (module_letkf_core.f90:338-418,
# the build_tree platform switch of localization.f90:59-72).
ASSIMILABLE_GTS = (GtsType.SYNOP, GtsType.METAR, GtsType.SHIPS,
                   GtsType.SOUND, GtsType.GPSPW)


# Physical constants (module_param.f90:105-116)
PI = math.pi
D2R = PI / 180.0
R2D = 180.0 / PI
EARTH_RADIUS = 6.37122e6
GRAVITY = 9.81
P1000MB = 100000.0
T0 = 300.0
R_D = 287.0
CP = 7.0 * R_D * 0.5
CV = CP - R_D
CVPM = -CV / CP
#: Gaspari-Cohn (1999) compact-support radius in localization-normalized
#: coordinates: 2*sqrt(10/3)  (module_param.f90:116).
GC1999 = 2.0 * math.sqrt(10.0 / 3.0)
#: Squared search radius of the fixed-radius neighbor query
#: (module_localization.f90:202).
GC1999_SQ = GC1999 * GC1999
