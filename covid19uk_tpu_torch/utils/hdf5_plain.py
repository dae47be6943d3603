"""Reads the groups of the HDF5 files that :mod:`ncio` reads, without h5py.

:func:`ncio.load_group` reads through h5py where it is installed and
through :func:`read_group` where it is not (the card's machine has no
h5py).  This is the part of the HDF5 format (the HDF Group's "HDF5 File
Format Specification", version 2) that netCDF4-profile files written with
the earliest file-format bounds use:

* superblock version 0 with 8-byte offsets and lengths;
* version-1 object headers, with their continuation blocks, and
  version-1 dataspace and attribute messages;
* groups held in a symbol table (a version-1 B-tree over symbol-table
  nodes, names in a local heap);
* contiguous datasets (layout message version 3) of little-endian
  integers, floats and fixed-length strings; an unallocated one reads as
  zeros, as h5py reads its default fill value;
* attributes of those types, variable-length strings (read as ``str``,
  as h5py reads them) and ``DIMENSION_LIST``: variable-length sequences
  of object references, read from the global heap as the object-header
  addresses of the dimension scales.

Anything else (chunked or compressed data, other message versions,
groups with link messages) raises ``ValueError`` naming what it met.
Attributes of other types (``REFERENCE_LIST``'s compound) are left out.
"""

from typing import NamedTuple

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEFINED = 0xFFFFFFFFFFFFFFFF
# object-header message types
_DATASPACE, _DATATYPE, _LAYOUT, _ATTRIBUTE = 0x1, 0x3, 0x8, 0xC
_CONTINUATION, _SYMBOL_TABLE = 0x10, 0x11
# datatype classes
_FIXED, _FLOAT, _STRING, _REFERENCE, _VLEN = 0, 1, 3, 7, 9


class Dataset(NamedTuple):
    """One dataset of a group: ``key`` is its object-header address,
    ``dim_keys`` the keys of each axis's dimension scales (None without a
    ``DIMENSION_LIST``)."""

    name: str
    key: int
    attrs: dict
    dim_keys: list
    shape: tuple
    dtype: np.dtype
    address: int  # of the data (undefined: not allocated)
    buf: bytes

    def read(self):
        count = int(np.prod(self.shape, dtype=np.int64))
        if self.address == _UNDEFINED:
            flat = np.zeros(count, self.dtype)
        else:
            flat = np.frombuffer(self.buf, self.dtype, count, self.address)
        return flat.reshape(self.shape).copy()


def _u(buf, pos, n):
    return int.from_bytes(buf[pos:pos + n], "little")


def _pad8(n):
    return (n + 7) & ~7


def _messages(buf, address):
    """``[(type, data)]`` of the version-1 object header at ``address``,
    its continuation blocks included."""
    if buf[address] != 1:
        raise ValueError(f"object header version {buf[address]} at "
                         f"{address}: only version 1 is read")
    count = _u(buf, address + 2, 2)
    blocks = [(address + 16, _u(buf, address + 8, 4))]
    out = []
    while blocks and len(out) < count:
        pos, size = blocks.pop(0)
        end = pos + size
        while pos + 8 <= end and len(out) < count:
            kind, length = _u(buf, pos, 2), _u(buf, pos + 2, 2)
            data = buf[pos + 8:pos + 8 + length]
            out.append((kind, data))
            if kind == _CONTINUATION:
                blocks.append((_u(data, 0, 8), _u(data, 8, 8)))
            pos += 8 + length
    return out


def _dataspace(data):
    """The dims of a dataspace message (``()`` for a scalar)."""
    if data[0] != 1:
        raise ValueError(f"dataspace message version {data[0]}")
    return tuple(_u(data, 8 + 8 * i, 8) for i in range(data[1]))


def _datatype(data):
    """``(class, numpy dtype or None, element bytes, base)`` of a
    datatype message; a variable-length type's base is "str" for a
    string, else its element's class."""
    cls, bits, size = data[0] & 0x0F, _u(data, 1, 3), _u(data, 4, 4)
    if cls in (_FIXED, _FLOAT):
        if bits & 1:
            raise ValueError("big-endian data is not read")
        kind = "f" if cls == _FLOAT else ("i" if bits & 0x8 else "u")
        return cls, np.dtype(f"<{kind}{size}"), size, None
    if cls == _STRING:
        return cls, np.dtype(f"S{size}"), size, None
    if cls == _VLEN:  # an element is its length and a global heap id
        return cls, None, 16, "str" if bits & 0x0F == 1 else data[8] & 0x0F
    return cls, None, size, None


def _global_heap_object(buf, collection, index):
    if buf[collection:collection + 4] != b"GCOL":
        raise ValueError(f"no global heap collection at {collection}")
    end = collection + _u(buf, collection + 8, 8)
    pos = collection + 16
    while pos + 16 <= end:
        obj, size = _u(buf, pos, 2), _u(buf, pos + 8, 8)
        if obj == index:
            return buf[pos + 16:pos + 16 + size]
        if obj == 0:
            break
        pos += 16 + _pad8(size)
    raise ValueError(f"global heap object {index} not in {collection}")


def _attribute(buf, data):
    """``(name, value)`` of an attribute message; value None for a type
    not read."""
    if data[0] != 1:
        raise ValueError(f"attribute message version {data[0]}")
    name_size, type_size, space_size = (_u(data, 2, 2), _u(data, 4, 2),
                                        _u(data, 6, 2))
    pos = 8  # name, datatype and dataspace, each padded to 8 bytes
    name = data[pos:pos + name_size].split(b"\0")[0].decode()
    pos += _pad8(name_size)
    cls, dtype, _, base = _datatype(data[pos:pos + type_size])
    pos += _pad8(type_size)
    shape = _dataspace(data[pos:pos + space_size])
    pos += _pad8(space_size)
    count = int(np.prod(shape, dtype=np.int64))
    if dtype is not None:
        value = np.frombuffer(data, dtype, count, pos).reshape(shape)
        return name, value[()] if shape == () else value.copy()
    if cls != _VLEN or base not in ("str", _REFERENCE):
        return name, None
    out = []
    for i in range(count):
        at = pos + 16 * i
        n = _u(data, at, 4)
        item = _global_heap_object(buf, _u(data, at + 4, 8),
                                   _u(data, at + 12, 4)) if n else b""
        if base == "str":  # h5py reads a str
            out.append(item[:n].decode())
        else:  # DIMENSION_LIST: object-header addresses
            out.append([_u(item, 8 * j, 8) for j in range(n)])
    if base == "str":
        return name, out[0] if shape == () else np.array(out, object)
    return name, out


def _symbol_table(buf, btree, heap):
    """``{name: object-header address}`` of a symbol-table group."""
    if buf[heap:heap + 4] != b"HEAP":
        raise ValueError(f"no local heap at {heap}")
    names = _u(buf, heap + 24, 8)
    out = {}
    nodes = [btree]
    while nodes:
        node = nodes.pop()
        if buf[node:node + 4] != b"TREE":
            raise ValueError(f"no B-tree node at {node}")
        level, used = buf[node + 5], _u(buf, node + 6, 2)
        # keys and children alternate after the 24-byte header
        children = [_u(buf, node + 24 + 8 + 16 * i, 8) for i in range(used)]
        if level > 0:
            nodes.extend(children)
            continue
        for child in children:
            if buf[child:child + 4] != b"SNOD":
                raise ValueError(f"no symbol-table node at {child}")
            for i in range(_u(buf, child + 6, 2)):
                entry = child + 8 + 40 * i
                at = names + _u(buf, entry, 8)
                name = buf[at:buf.index(b"\0", at)].decode()
                out[name] = _u(buf, entry + 8, 8)
    return dict(sorted(out.items()))  # h5py's order: by name


def _members(buf, address):
    for kind, data in _messages(buf, address):
        if kind == _SYMBOL_TABLE:
            return _symbol_table(buf, _u(data, 0, 8), _u(data, 8, 8))
    raise ValueError(f"the group at {address} holds no symbol table "
                     f"(groups with link messages are not read)")


def _attrs(buf, messages):
    out = {}
    for kind, data in messages:
        if kind == _ATTRIBUTE:
            name, value = _attribute(buf, data)
            if value is not None:
                out[name] = value
    return out


def _dataset(buf, name, address, messages):
    """A Dataset, or None where the object is not one (a group)."""
    found = {kind: data for kind, data in messages
             if kind in (_DATASPACE, _DATATYPE, _LAYOUT)}
    if len(found) < 3:
        return None
    cls, dtype, _, _ = _datatype(found[_DATATYPE])
    if dtype is None:
        raise ValueError(f"dataset {name}: datatype class {cls} is not read")
    layout = found[_LAYOUT]
    if layout[0] != 3 or layout[1] != 1:
        raise ValueError(f"dataset {name}: layout message version "
                         f"{layout[0]}, class {layout[1]} (1: contiguous) "
                         f"is not read")
    attrs = _attrs(buf, messages)
    dims = attrs.pop("DIMENSION_LIST", None)
    return Dataset(name=name, key=address, attrs=attrs, dim_keys=dims,
                   shape=_dataspace(found[_DATASPACE]), dtype=dtype,
                   address=_u(layout, 2, 8), buf=buf)


def read_group(path, group_name):
    """``(attrs, [Dataset])`` of the group ``group_name`` (a path from
    the root, ``/``-separated) of the HDF5 file at ``path``."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _SIGNATURE:
        raise ValueError(f"{path} is not an HDF5 file")
    if buf[8] != 0 or buf[13] != 8 or buf[14] != 8:
        raise ValueError(f"{path}: superblock version {buf[8]} with "
                         f"{buf[13]}-byte offsets is not read")
    address = _u(buf, 64, 8)  # the root group's entry at 56: its header
    for part in filter(None, group_name.split("/")):
        members = _members(buf, address)
        if part not in members:
            raise KeyError(f"{group_name} not in {path}")
        address = members[part]
    datasets = []
    for name, at in _members(buf, address).items():
        ds = _dataset(buf, name, at, _messages(buf, at))
        if ds is not None:
            datasets.append(ds)
    return _attrs(buf, _messages(buf, address)), datasets
