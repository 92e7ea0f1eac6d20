"""Pytree checkpoints in the reference's file format — counterpart of
``repro/train/checkpoint.py``, with no msgpack dependency.

A file is one msgpack map ``{path: {"dtype", "shape", "data"}}``: each
leaf under its ``/``-joined tree path, in the reference's order (dict keys
sorted at every level, list items by index), its bytes in the reference's
layout (conv weights HWIO, ``interop.params_to_numpy``'s rule for every
4-D leaf).  So a file this module writes is byte for byte the reference's
file of the same converted tree, and each package loads the other's.

``packb`` / ``unpackb`` encode and decode the subset of msgpack these files
use (maps, str, bin, ints and lists of ints) exactly as ``msgpack.packb(...,
use_bin_type=True)`` does: the smallest format for each value.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

# -- the msgpack subset --------------------------------------------------------


def _head(n: int, fix: int, fix_max: int, wide: tuple) -> bytes:
    """A length prefix: the fix form up to ``fix_max``, else the first of
    ``wide``'s (tag, struct format, limit) that holds ``n``."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for tag, fmt, limit in wide:
        if n <= limit:
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"length {n} too large for msgpack")


_STR = ((0xd9, ">B", 0xff), (0xda, ">H", 0xffff), (0xdb, ">I", 0xffffffff))
_BIN = ((0xc4, ">B", 0xff), (0xc5, ">H", 0xffff), (0xc6, ">I", 0xffffffff))
_ARR = ((0xdc, ">H", 0xffff), (0xdd, ">I", 0xffffffff))
_MAP = ((0xde, ">H", 0xffff), (0xdf, ">I", 0xffffffff))
_UINT = ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff), (0xce, ">I", 0xffffffff),
         (0xcf, ">Q", 0xffffffffffffffff))
_INT = ((0xd0, ">b", 0x80), (0xd1, ">h", 0x8000), (0xd2, ">i", 0x80000000),
        (0xd3, ">q", 0x8000000000000000))


def _pack(obj, out: list) -> None:
    if isinstance(obj, dict):
        out.append(_head(len(obj), 0x80, 15, _MAP))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out += [_head(len(b), 0xa0, 31, _STR), b]
    elif isinstance(obj, (bytes, bytearray)):
        out += [_head(len(obj), None, 0, _BIN), bytes(obj)]
    elif isinstance(obj, (list, tuple)):
        out.append(_head(len(obj), 0x90, 15, _ARR))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, int) and not isinstance(obj, bool):
        if 0 <= obj < 0x80:
            out.append(bytes([obj]))
        elif -0x20 <= obj < 0:
            out.append(struct.pack(">b", obj))
        elif obj >= 0:
            out.append(_head(obj, None, 0, _UINT))
        else:
            for tag, fmt, limit in _INT:
                if -obj <= limit:
                    out.append(bytes([tag]) + struct.pack(fmt, obj))
                    break
            else:
                raise ValueError(f"integer {obj} too large for msgpack")
    else:
        raise TypeError(f"cannot pack {type(obj).__name__} (this msgpack "
                        "subset holds maps, str, bytes, ints and lists)")


def packb(obj) -> bytes:
    out: list = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        view = self.data[self.pos:self.pos + n]
        self.pos += n
        return view

    def num(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        tag = self.num(">B")
        if tag < 0x80:
            return tag
        if tag >= 0xe0:
            return tag - 0x100
        if tag & 0xf0 == 0x80:
            return self.map(tag & 0x0f)
        if tag & 0xf0 == 0x90:
            return [self.obj() for _ in range(tag & 0x0f)]
        if tag & 0xe0 == 0xa0:
            return str(self.take(tag & 0x1f), "utf-8")
        fmt = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xd9: ">B", 0xda: ">H",
               0xdb: ">I", 0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I",
               0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
               0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}.get(tag)
        if fmt is None:
            raise ValueError(f"msgpack type 0x{tag:02x} is outside this "
                             "subset")
        n = self.num(fmt)
        if tag in (0xc4, 0xc5, 0xc6):
            return bytes(self.take(n))
        if tag in (0xd9, 0xda, 0xdb):
            return str(self.take(n), "utf-8")
        if tag in (0xdc, 0xdd):
            return [self.obj() for _ in range(n)]
        if tag in (0xde, 0xdf):
            return self.map(n)
        return n

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def unpackb(data: bytes):
    r = _Reader(data)
    obj = r.obj()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return obj


# -- trees in the reference's order and layout ---------------------------------


def tree_paths(tree, prefix=()):
    """(path, leaf) pairs in the reference's flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], (*prefix, str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, (*prefix, str(i)))
    elif tree is not None:
        yield "/".join(prefix), tree


def map_paths(fn, tree, prefix=()):
    """``tree_map`` of ``fn(path, leaf)``, keeping ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: map_paths(fn, v, (*prefix, str(k)))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_paths(fn, v, (*prefix, str(i)))
                          for i, v in enumerate(tree))
    return None if tree is None else fn("/".join(prefix), tree)


def ref_shape(shape) -> tuple:
    """A port leaf's shape in the reference's layout (OIHW -> HWIO)."""
    shape = tuple(shape)
    if len(shape) == 4:
        o, i, h, w = shape
        return (h, w, i, o)
    return shape


def record(leaf) -> dict:
    """One leaf's ``{"dtype", "shape", "data"}`` in the reference's layout:
    a tensor (port layout) is transposed like ``interop.params_to_numpy``;
    a numpy array is taken as already in the reference's layout."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dim() == 4:
            t = t.permute(2, 3, 1, 0)
        t = t.contiguous()
        if t.dtype == torch.bfloat16:        # numpy has no bfloat16
            return {"dtype": "bfloat16", "shape": list(t.shape),
                    "data": t.view(torch.int16).numpy().tobytes()}
        a = t.numpy()
    else:
        a = np.ascontiguousarray(leaf)
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "data": a.tobytes()}


def tensor_of(rec: dict, device) -> torch.Tensor:
    """A record -> a tensor in the port's layout on ``device``."""
    shape = [int(n) for n in rec["shape"]]
    if rec["dtype"] == "bfloat16":
        t = torch.from_numpy(np.frombuffer(rec["data"], np.int16).copy()) \
            .view(torch.bfloat16).reshape(shape)
    else:
        t = torch.from_numpy(np.frombuffer(
            rec["data"], np.dtype(rec["dtype"])).copy()).reshape(shape)
    if t.dim() == 4:
        t = t.permute(3, 2, 0, 1)            # HWIO -> OIHW
    return t.contiguous().to(device)


def records(tree) -> dict:
    """Every leaf of ``tree`` as ``{path: record}``, in the reference's
    order."""
    return {k: record(v) for k, v in tree_paths(tree)}


def write(path: str, payload: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(packb(payload))


def read(path: str):
    with open(path, "rb") as f:
        return unpackb(f.read())


def save(path: str, tree) -> None:
    """Write ``tree`` (tensors in the port's layout) as the reference's
    checkpoint file."""
    write(path, records(tree))


def load(path: str, like):
    """Restore into the structure of ``like`` (names must match): each
    leaf a tensor of the file's dtype and shape, in the port's layout, on
    the device of ``like``'s leaf."""
    payload = read(path)
    return map_paths(lambda k, ref: tensor_of(payload[k], ref.device), like)
