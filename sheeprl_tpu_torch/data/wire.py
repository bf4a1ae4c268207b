"""Pickle-free byte framing for str-keyed trees of numpy arrays (the port's
copy of the `pack_tree`/`unpack_tree` half of sheeprl_tpu/data/wire.py).

Every array is byte-viewed through its itemsize-class integer carrier (int
carriers are bit-exact by construction, so arbitrary NaN payloads survive
where a float-typed carrier could be canonicalized), concatenated into ONE
blob per width class, and described by a static layout of
`(key, dtype_str, shape, group, offset, size)` rows. The inverse slices
each value back out of its class blob and bit-views it to the true dtype —
an exact bit-level roundtrip.

Frame grammar (all integers little-endian, `struct` — no pickle anywhere):

    tree  := MAGIC_TREE u32(header_len) header_json group_bytes*
    header_json := {"layout": [[key, dtype_str, [dims...], group, off, size]...],
                    "groups": [[group_name, nbytes]...]}
"""

from __future__ import annotations

import json
import struct
from typing import Mapping

import numpy as np

__all__ = ["MAGIC_TREE", "WireFormatError", "pack_tree", "unpack_tree"]

MAGIC_TREE = b"SFT1"

# width-class carriers, one per itemsize
_WIRE_GROUP = {1: "w1", 2: "w2", 4: "w4", 8: "w8"}
_WIRE_VIEW = {
    "w1": np.uint8,
    "w2": np.uint16,
    "w4": np.uint32,
    "w8": np.uint64,
}

_U32 = struct.Struct("<I")


class WireFormatError(ValueError):
    """Malformed or version-mismatched wire frame."""


def _as_wire_array(v) -> np.ndarray:
    a = np.asarray(v)
    if a.dtype.hasobject:
        raise WireFormatError(f"object dtype {a.dtype} cannot ride the wire")
    return a


def pack_tree(tree: Mapping[str, "np.ndarray"]) -> bytes:
    """One framed blob for a str-keyed mapping of arrays. Bit-exact: raw
    carrier bytes, no float transit."""
    layout: list[list] = []
    groups: dict[str, list[np.ndarray]] = {}
    offsets: dict[str, int] = {}
    for k, v in tree.items():
        a = _as_wire_array(v)
        g = _WIRE_GROUP.get(a.dtype.itemsize)
        if g is None:
            raise WireFormatError(f"unsupported itemsize {a.dtype.itemsize} for {k!r}")
        # ascontiguousarray AFTER capturing a.shape: it promotes 0-d to 1-d
        view = np.ascontiguousarray(a).reshape(-1).view(_WIRE_VIEW[g])
        off = offsets.get(g, 0)
        groups.setdefault(g, []).append(view)
        layout.append([str(k), a.dtype.str, list(a.shape), g, off, int(a.size)])
        offsets[g] = off + a.size
    order = sorted(groups)
    blobs = {g: np.concatenate(groups[g]) for g in order}
    header = json.dumps(
        {
            "layout": layout,
            "groups": [[g, int(blobs[g].nbytes)] for g in order],
        }
    ).encode()
    parts = [MAGIC_TREE, _U32.pack(len(header)), header]
    parts.extend(blobs[g].tobytes() for g in order)
    return b"".join(parts)


def unpack_tree(data: bytes) -> dict[str, np.ndarray]:
    """Inverse of `pack_tree`; returns writable host arrays."""
    if len(data) < 8 or data[:4] != MAGIC_TREE:
        raise WireFormatError("bad tree frame magic")
    (header_len,) = _U32.unpack_from(data, 4)
    end = 8 + header_len
    if end > len(data):
        raise WireFormatError("truncated tree frame header")
    header = json.loads(data[8:end].decode())
    blobs: dict[str, np.ndarray] = {}
    off = end
    for g, nbytes in header["groups"]:
        if g not in _WIRE_VIEW or off + nbytes > len(data):
            raise WireFormatError("truncated tree frame payload")
        blobs[g] = np.frombuffer(data, dtype=_WIRE_VIEW[g], count=nbytes // np.dtype(_WIRE_VIEW[g]).itemsize, offset=off)
        off += nbytes
    out: dict[str, np.ndarray] = {}
    for k, ds, shape, g, start, size in header["layout"]:
        dt = np.dtype(ds)
        seg = blobs[g][start : start + size]
        if seg.shape[0] != size:
            raise WireFormatError(f"layout overruns group {g!r} for key {k!r}")
        # copy() both detaches from the shared frombuffer view and makes
        # the result writable (frombuffer arrays are read-only)
        out[k] = seg.view(dt).reshape(shape).copy()
    return out
