"""Constants the ported modules read (module_param.f90)."""
import math

#: Gaspari-Cohn (1999) compact-support radius in localization-normalized
#: coordinates: 2*sqrt(10/3)  (module_param.f90:116).
GC1999 = 2.0 * math.sqrt(10.0 / 3.0)
#: Squared search radius of the fixed-radius neighbor query
#: (module_localization.f90:202).
GC1999_SQ = GC1999 * GC1999
