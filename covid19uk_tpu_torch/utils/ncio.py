"""netCDF4-profile grouped-array IO on HDF5.

The reference pipeline communicates through netCDF files with groups
``constant_data`` / ``observations`` / ``predictions`` /
``posterior_predictive`` (``/root/reference/covid19uk/data/assemble.py:15-16``
and ``posterior/*``).  netCDF4 *is* an HDF5 profile — dimension-scale
datasets (``CLASS=DIMENSION_SCALE``) that variables attach via
``DIMENSION_LIST`` — and this environment has h5py but not netCDF4/xarray,
so :func:`save_group` emits that profile directly:

* every declared dimension becomes a dimension-scale dataset in the group
  (holding coordinate values when provided, else a placeholder marked with
  netCDF's "not a netCDF variable" NAME convention);
* every variable attaches its scales axis by axis, exactly as netCDF4-c
  lays them out, so xarray/netCDF4 on the reference side can
  ``open_dataset(path, group=...)`` files written here;
* :func:`load_group` reads both directions: files written by this module,
  by netCDF4/xarray (the reference's outputs), and round-1 legacy files
  (``_coord_`` prefix convention).

Port of ``covid19uk_tpu/utils/ncio.py``; ``h5py`` is imported inside the
functions that read or write, so importing this module needs no h5py.
"""

from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np

_LEGACY_COORD_PREFIX = "_coord_"
# netCDF4-c's marker for a dimension without a coordinate variable.
_PHONY_DIM_NAME = "This is a netCDF dimension but not a netCDF variable."


@dataclass
class Group:
    """An in-memory grouped dataset: variables + coords + attrs."""

    variables: Dict[str, np.ndarray] = field(default_factory=dict)
    dims: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    coords: Dict[str, np.ndarray] = field(default_factory=dict)
    attrs: Dict[str, object] = field(default_factory=dict)

    def __getitem__(self, name):
        return self.variables[name]

    def __contains__(self, name):
        return name in self.variables


def _encode(arr):
    arr = np.asarray(arr)
    if arr.dtype.kind == "M":  # datetime64 -> ISO strings
        return np.asarray(arr.astype("datetime64[D]").astype(str), dtype="S")
    if arr.dtype.kind == "U":
        return arr.astype("S")
    return arr


def _decode(arr):
    arr = np.asarray(arr)
    if arr.dtype.kind == "S" or arr.dtype == object:
        out = arr.astype(str)
        try:
            return out.astype("datetime64[D]")
        except ValueError:
            return out
    return arr


def save_group(path, group_name, group: Group, mode="a"):
    """Writes a Group to ``path`` under HDF5 group ``group_name`` in the
    netCDF4 profile (dimension scales + DIMENSION_LIST attachments)."""
    import h5py

    # Resolve each named dimension's size from variables' declared dims,
    # falling back to coord lengths.
    dim_sizes = {}
    for name, arr in group.variables.items():
        arr = np.asarray(arr)
        for axis, dim in enumerate(group.dims.get(name, ())):
            dim_sizes.setdefault(dim, arr.shape[axis])
    for dim, coord in group.coords.items():
        dim_sizes.setdefault(dim, len(np.asarray(coord)))

    with h5py.File(path, mode) as f:
        # netCDF4-c stamps every file it writes; emit the same marker so
        # format-sniffing readers recognize the profile
        # (tools/nc4_validate.py documents the spec references).
        if "_NCProperties" not in f.attrs:
            f.attrs["_NCProperties"] = np.bytes_(
                "version=2,netcdf=4.8.1,hdf5=1.12.1"
            )
        if group_name in f:
            del f[group_name]
        g = f.create_group(group_name)
        for k, v in group.attrs.items():
            g.attrs[k] = v

        scales = {}
        for dimid, (dim, size) in enumerate(dim_sizes.items()):
            if dim in group.coords:
                d = g.create_dataset(dim, data=_encode(group.coords[dim]))
                d.make_scale(dim)
            elif dim in group.variables:  # coordinate variable
                d = g.create_dataset(
                    dim, data=_encode(group.variables[dim])
                )
                d.make_scale(dim)
            else:
                d = g.create_dataset(dim, shape=(size,), dtype="f4")
                d.make_scale(f"{_PHONY_DIM_NAME} {size}")
            # netCDF4-c's dimension-id bookkeeping: unique per group, in
            # creation order — netcdf-c uses it to reconstruct dimension
            # ordering on open.
            d.attrs["_Netcdf4Dimid"] = np.int32(dimid)
            scales[dim] = d

        for name, arr in group.variables.items():
            if name in scales:  # a coordinate variable doubles as its scale
                continue
            d = g.create_dataset(name, data=_encode(arr))
            for axis, dim in enumerate(group.dims.get(name, ())):
                d.dims[axis].attach_scale(scales[dim])

        # Coords that are not a dimension of any variable (auxiliary
        # coordinates) were still written as scales above; nothing more.


def _is_dimension_scale(item):
    cls = item.attrs.get("CLASS")
    if isinstance(cls, bytes):
        cls = cls.decode()
    return cls == "DIMENSION_SCALE"


def _scale_is_phony(item):
    name = item.attrs.get("NAME", b"")
    if isinstance(name, bytes):
        name = name.decode(errors="replace")
    return str(name).startswith(_PHONY_DIM_NAME)


def load_group(path, group_name) -> Group:
    """Reads a Group from netCDF4-profile files (written here or by
    netCDF4/xarray) and from round-1 legacy files (``_coord_`` prefix).
    Reads through h5py where it is installed, else through
    :func:`hdf5_plain.read_group` (the part of HDF5 these files use)."""
    try:
        import h5py
    except ImportError:
        from covid19uk_tpu_torch.utils import hdf5_plain

        return _group(*hdf5_plain.read_group(path, group_name))

    with h5py.File(path, "r") as f:
        g = f[group_name]
        datasets = [_H5Dataset(name, item) for name, item in g.items()
                    if isinstance(item, h5py.Dataset)]
        return _group(g.attrs, datasets)


class _H5Dataset:
    """An h5py dataset as :func:`_group` reads it: ``hdf5_plain.Dataset``'s
    ``name``, ``key``, ``attrs``, ``dim_keys`` and ``read``."""

    def __init__(self, name, item):
        self.name, self.key, self.attrs, self._item = (
            name, item.id, item.attrs, item)
        self.dim_keys = None
        if "DIMENSION_LIST" in item.attrs:
            self.dim_keys = [[s.id for _, s in item.dims[axis].items()]
                             for axis in range(len(item.dims))]

    def read(self):
        return self._item[()]


def _group(attrs, datasets) -> Group:
    out = Group()
    out.attrs = {k: v for k, v in attrs.items() if not k.startswith("_NC")}
    scale_names = {d.key: d.name for d in datasets
                   if _is_dimension_scale(d)}
    for d in datasets:
        name = d.name
        if name.startswith(_LEGACY_COORD_PREFIX):  # round-1 files
            out.coords[name[len(_LEGACY_COORD_PREFIX):]] = _decode(d.read())
            continue
        if d.key in scale_names:
            if not _scale_is_phony(d):
                out.coords[name] = _decode(d.read())
            continue
        out.variables[name] = _decode(d.read())
        if d.dim_keys is not None:
            out.dims[name] = tuple(
                scale_names.get(keys[0], f"dim_{axis}") if keys
                else f"dim_{axis}"
                for axis, keys in enumerate(d.dim_keys)
            )
        elif "dims" in d.attrs:  # round-1 legacy attr
            dims_attr = d.attrs["dims"]
            if isinstance(dims_attr, bytes):
                dims_attr = dims_attr.decode()
            out.dims[name] = tuple(dims_attr.split(","))
    return out


def copy_attrs(src_path, dest_path):
    """Copies root attrs between files (reference ``util.py:16-22``)."""
    import h5py

    with h5py.File(src_path, "r") as s:
        attrs = dict(s.attrs)
    with h5py.File(dest_path, "a") as d:
        for k, v in attrs.items():
            d.attrs[k] = v
