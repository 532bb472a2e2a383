"""WRF model-state handling: ensemble container, I/O, vertical coordinates."""

from .state import MpScheme, WrfEnsemble, read_ensemble, write_ensemble, write_mean
from .variables import VAR_TABLE, is_moisture_var

__all__ = [
    "MpScheme",
    "WrfEnsemble",
    "read_ensemble",
    "write_ensemble",
    "write_mean",
    "VAR_TABLE",
    "is_moisture_var",
]
