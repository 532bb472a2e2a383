"""File I/O: WRF NetCDF ensembles (``netcdf``) and the native observation
parsers (``native``); port of the JAX package's ``io``."""

from .netcdf import NetcdfReader, NetcdfWriter, open_wrf

__all__ = ["NetcdfReader", "NetcdfWriter", "open_wrf"]
