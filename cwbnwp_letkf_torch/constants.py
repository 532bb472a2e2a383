"""Constants the ported modules read (module_param.f90)."""
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
