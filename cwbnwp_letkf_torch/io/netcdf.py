"""WRF NetCDF read/write with header-cloning semantics.

Port of the JAX package's ``io/netcdf.py`` (numpy and scipy, unchanged):
the reference's ``module_netcdf_io.f90`` on two libraries:

* **classic NetCDF** (CDF-1/CDF-2, the default WRF io_form) via
  ``scipy.io.netcdf_file`` — mmap'd reads, plain writes;
* **NetCDF-4/HDF5** (the reference's ``-DNC4`` build, Makefile:63-67) via
  ``h5py`` when the file is HDF5, imported only then: classic files need
  no h5py.

Semantics preserved from the reference writer (netcdf_io.f90:177-374):
``copy_header_from`` clones every dimension, global attribute and variable
definition (+ its attributes) of the input file; ``write_variable`` writes an
analysis field; untouched variables are byte-copied through
(``write_variable_others``).  WRF files carry a leading unlimited ``Time``
dimension of extent 1; the reference reads/writes timestep 0 implicitly
(get_variable 3d reads var(:,:,:,1)) and so do we — arrays returned to the
solver are squeezed of ``Time``.

Variables are returned transposed to Fortran-ish (x, y, z) index order so
shapes match the reference's (west_east, south_north, bottom_top) arrays.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

_HDF5_MAGIC = b"\x89HDF"
_CDF_MAGICS = (b"CDF\x01", b"CDF\x02", b"CDF\x05")


def _is_hdf5(path: str) -> bool:
    with open(path, "rb") as fh:
        return fh.read(4) == _HDF5_MAGIC


class NetcdfReader:
    """Read handle for a WRF file (classic or NC4).

    Mirrors ``read_nc`` (netcdf_io.f90:11-29): ``get_dimension``,
    ``get_attribute`` (global), ``get_variable`` (0d-3d + Times strings).
    """

    def __init__(self, path: str):
        self.path = path
        self._h5 = None
        self._nc = None
        if _is_hdf5(path):
            import h5py

            self._h5 = h5py.File(path, "r")
        else:
            from scipy.io import netcdf_file

            self._nc = netcdf_file(path, "r", mmap=True,
                                   maskandscale=False)

    # -- dimensions --------------------------------------------------------
    def get_dimension(self, name: str) -> int:
        if self._nc is not None:
            d = self._nc.dimensions[name]
            if d is None:  # unlimited: infer from a variable
                for v in self._nc.variables.values():
                    if name in v.dimensions:
                        return v.shape[list(v.dimensions).index(name)]
                return 0
            return int(d)
        # h5py: netCDF4 stores dims as scale datasets
        obj = self._h5[name]
        return int(obj.shape[0]) if obj.shape else 0

    # -- attributes --------------------------------------------------------
    def get_attribute(self, name: str, var: Optional[str] = None):
        if self._nc is not None:
            src = self._nc.variables[var] if var else self._nc
            val = getattr(src, name)
        else:
            src = self._h5[var] if var else self._h5
            val = src.attrs[name]
        if isinstance(val, bytes):
            return val.decode()
        return val

    # -- variables ---------------------------------------------------------
    def variable_names(self) -> List[str]:
        if self._nc is not None:
            return list(self._nc.variables.keys())
        names = []
        self._h5.visit(lambda n: names.append(n))
        return [n for n in names
                if isinstance(self._h5[n], type(self._h5[n])) and n in self._h5]

    def get_variable(self, name: str) -> np.ndarray:
        """Return timestep 0, transposed to (x, y, z) order, as float32.

        WRF layout on disk is (Time, bottom_top, south_north, west_east);
        the reference's arrays are (west_east, south_north, bottom_top)
        (module_grid.f90:267-280) — we transpose to match.
        """
        raw = self._raw(name)
        if raw.ndim >= 1 and self._leading_time(name):
            raw = raw[0]
        out = np.ascontiguousarray(raw.T) if raw.ndim > 1 else np.array(raw)
        # classic NetCDF stores big-endian; torch rejects non-native dtypes
        if out.dtype.byteorder not in ("=", "|") and out.dtype.byteorder != (
                "<" if np.little_endian else ">"):
            out = out.astype(out.dtype.newbyteorder("="))
        return out

    def get_scalar(self, name: str) -> float:
        raw = self._raw(name)
        return float(np.ravel(raw)[0])

    def _leading_time(self, name: str) -> bool:
        dims = self._dims_of(name)
        return bool(dims) and dims[0] == "Time"

    def _dims_of(self, name: str) -> Tuple[str, ...]:
        if self._nc is not None:
            return tuple(self._nc.variables[name].dimensions)
        ds = self._h5[name]
        out = []
        for i in range(ds.ndim):
            scales = ds.dims[i].keys() if hasattr(ds.dims[i], "keys") else []
            lab = ds.dims[i].label
            out.append(lab if lab else (list(scales)[0] if scales else f"d{i}"))
        return tuple(out)

    def _raw(self, name: str) -> np.ndarray:
        if self._nc is not None:
            return np.asarray(self._nc.variables[name].data)
        return np.asarray(self._h5[name][...])

    def close(self):
        if self._nc is not None:
            self._nc.close()
        if self._h5 is not None:
            self._h5.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NetcdfWriter:
    """Header-cloning writer (semantics of ``write_nc``, netcdf_io.f90:177-374).

    Usage::

        with NetcdfReader(inp) as src, NetcdfWriter(outp) as dst:
            dst.copy_header_from(src)
            dst.write_variable("T", t_xyz)        # (x, y, z) order
            dst.write_others(src)                 # byte-copy the rest

    Output is always classic CDF-2 (64-bit offset capable via scipy), which
    every WRF toolchain reads; NC4 input is transparently converted.
    """

    def __init__(self, path: str):
        from scipy.io import netcdf_file

        self.path = path
        self._nc = netcdf_file(path, "w", version=2, maskandscale=False)
        self._src_dims: Dict[str, Optional[int]] = {}
        self._written: set = set()
        self._var_meta: Dict[str, Tuple[Tuple[str, ...], np.dtype]] = {}

    def copy_header_from(self, src: NetcdfReader):
        # global attributes
        if src._nc is not None:
            for k, v in src._nc._attributes.items():
                setattr(self._nc, k, v)
            dims = dict(src._nc.dimensions)
            # unlimited dim (Time) -> keep unlimited (None)
            for name, size in dims.items():
                self._nc.createDimension(name, size)
                self._src_dims[name] = size
            for name, var in src._nc.variables.items():
                dt = var.data.dtype
                nv = self._nc.createVariable(name, dt, var.dimensions)
                for ak, av in var._attributes.items():
                    setattr(nv, ak, av)
                self._var_meta[name] = (tuple(var.dimensions), dt)
        else:
            h5 = src._h5
            for k, v in h5.attrs.items():
                if isinstance(v, bytes):
                    v = v.decode()
                setattr(self._nc, k, v)
            # dimensions: collect from variable dim labels and sizes
            dim_sizes: Dict[str, int] = {}
            names = [n for n in h5.keys()]
            for n in names:
                ds = h5[n]
                if getattr(ds.attrs, "get", lambda *_: None)("CLASS") == b"DIMENSION_SCALE":
                    continue
                dims = src._dims_of(n)
                for d, s in zip(dims, ds.shape):
                    dim_sizes.setdefault(d, s)
            for d, s in dim_sizes.items():
                self._nc.createDimension(d, None if d == "Time" else s)
                self._src_dims[d] = s
            for n in names:
                ds = h5[n]
                if ds.attrs.get("CLASS") == b"DIMENSION_SCALE":
                    continue
                dims = src._dims_of(n)
                dt = ds.dtype
                nv = self._nc.createVariable(n, dt, dims)
                for ak, av in ds.attrs.items():
                    if ak in ("CLASS", "DIMENSION_LIST", "NAME",
                              "REFERENCE_LIST", "_Netcdf4Coordinates",
                              "_Netcdf4Dimid"):
                        continue
                    if isinstance(av, bytes):
                        av = av.decode()
                    setattr(nv, ak, av)
                self._var_meta[n] = (tuple(dims), dt)

    def write_variable(self, name: str, data_xyz: np.ndarray):
        """Write one analysis field given in (x, y, z) order."""
        var = self._nc.variables[name]
        dims, dt = self._var_meta[name]
        arr = np.asarray(data_xyz)
        if arr.ndim > 1:
            arr = arr.T  # back to (z, y, x)
        if dims and dims[0] == "Time":
            var[0] = arr.astype(dt, copy=False)
        else:
            var[:] = arr.astype(dt, copy=False)
        self._written.add(name)

    def write_others(self, src: NetcdfReader):
        """Copy through every variable not explicitly written
        (write_variable_others, netcdf_io.f90:325-374)."""
        for name in self._var_meta:
            if name in self._written:
                continue
            raw = src._raw(name)
            var = self._nc.variables[name]
            var[:] = raw
            self._written.add(name)

    def close(self):
        self._nc.flush()
        self._nc.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NetcdfAppender:
    """Rewrite variables of an EXISTING classic-NetCDF file in place.

    The streaming pipeline (models/state.StreamingWrfEnsemble) pre-creates
    each analysis file as a full copy of its prior member, then overwrites
    one analysis variable at a time as each variable group completes — the
    analog of the reference's one-variable-resident scatter/update/
    gather loop (module_letkf_core.f90:59-297): nothing larger than one
    field is ever held per member.  Classic NetCDF has a fixed on-disk
    layout, so an in-place variable rewrite touches exactly that variable's
    bytes.
    """

    def __init__(self, path: str):
        from scipy.io import netcdf_file

        self.path = path
        self._nc = netcdf_file(path, "a", mmap=False, maskandscale=False)

    def write_variable(self, name: str, data_xyz: np.ndarray):
        """Overwrite one variable given in (x, y, z) order (like
        :meth:`NetcdfWriter.write_variable`)."""
        var = self._nc.variables[name]
        arr = np.asarray(data_xyz)
        if arr.ndim > 1:
            arr = arr.T  # back to (z, y, x)
        if var.dimensions and var.dimensions[0] == "Time":
            var[0] = arr.astype(var.data.dtype, copy=False)
        else:
            var[:] = arr.astype(var.data.dtype, copy=False)

    def close(self):
        self._nc.flush()
        self._nc.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def clone_file(src_path: str, dst_path: str) -> None:
    """Create ``dst`` as a full classic-NetCDF copy of ``src`` (header +
    every variable) — the pre-created sink the streaming writer appends
    into.  NC4/HDF5 sources are transparently converted to classic."""
    if not _is_hdf5(src_path):
        import shutil

        shutil.copyfile(src_path, dst_path)
        return
    with NetcdfReader(src_path) as src, NetcdfWriter(dst_path) as dst:
        dst.copy_header_from(src)
        dst.write_others(src)


def open_wrf(path: str) -> NetcdfReader:
    return NetcdfReader(path)
