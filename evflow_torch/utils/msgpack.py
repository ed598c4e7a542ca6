"""A msgpack reader for the reference package's checkpoints, without the
``msgpack`` package.

``evflow.utils.checkpoint.save_checkpoint`` writes ``model.msgpack`` with
``flax.serialization.to_bytes``: a msgpack map of ``{params, batch_stats,
opt_state, epoch, loss, loss_variance}``, tuples and named tuples (optax's
states) as maps keyed ``"0"``, ``"1"``, ... or by field, arrays as ext type
1 (a msgpack ``[shape, dtype name, C-order bytes]``), numpy scalars as ext
type 3, complex numbers as ext type 2, and arrays over 1 GiB as a map of
chunks. ``unpackb`` decodes maps, arrays, str, bin, ints, floats, nil, bool
and those ext types; bfloat16 arrays come back as float32 (numpy has no
bfloat16; the widening is exact). ``packb`` writes the same subset as
flax does (a numpy array as ext type 1), so that a host without flax can
write a checkpoint that ``flax.serialization.from_bytes`` reads.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict

import numpy as np

__all__ = ["unpackb", "packb", "read_flax_checkpoint", "is_flax_checkpoint", "MSGPACK_NAME"]

MSGPACK_NAME = "model.msgpack"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


def _ndarray(data: bytes) -> np.ndarray:
    shape, name, buf = unpackb(data)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape).copy()


def _ext(code: int, data: bytes) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    if code == _EXT_COMPLEX:
        re, im = unpackb(data)
        return complex(re, im)
    raise ValueError(f"msgpack ext type {code} is not one flax writes")


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ("bin", "B"), 0xC5: ("bin", "H"), 0xC6: ("bin", "I"),
                 0xC7: ("ext", "B"), 0xC8: ("ext", "H"), 0xC9: ("ext", "I"),
                 0xD9: ("str", "B"), 0xDA: ("str", "H"), 0xDB: ("str", "I"),
                 0xDC: ("array", "H"), 0xDD: ("array", "I"),
                 0xDE: ("map", "H"), 0xDF: ("map", "I")}
        if b in sized:
            kind, fmt = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.take(n).decode()
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            code = self.unpack("b")
            return _ext(code, self.take(n))
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                   0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            code = self.unpack("b")
            return _ext(code, self.take(1 << (b - 0xD4)))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not decoded here")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if tree.get("__msgpack_chunked_array__"):
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data: bytes) -> Any:
    """The object that ``data`` (msgpack bytes, flax's ext types) encodes."""
    reader = _Reader(data)
    out = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the msgpack object")
    return out


def is_flax_checkpoint(path: str) -> bool:
    """Whether ``path`` is a ``model.msgpack`` file or a directory holding one."""
    if os.path.isdir(path):
        return os.path.isfile(os.path.join(path, MSGPACK_NAME))
    return path.endswith(".msgpack")


def read_flax_checkpoint(path: str) -> Dict[str, Any]:
    """The state dict of a reference checkpoint (``model.msgpack`` or its
    directory): nested dicts of numpy arrays and scalars."""
    if os.path.isdir(path):
        path = os.path.join(path, MSGPACK_NAME)
    with open(path, "rb") as f:
        return _unchunk(unpackb(f.read()))



def _header(out: bytearray, n: int, fix: int, fix_max: int, codes: tuple):
    if n <= fix_max and fix is not None:
        out.append(fix | n)
    elif n < 1 << 8 and codes[0] is not None:
        out += bytes([codes[0]]) + struct.pack(">B", n)
    elif n < 1 << 16:
        out += bytes([codes[1]]) + struct.pack(">H", n)
    else:
        out += bytes([codes[2]]) + struct.pack(">I", n)


def _pack(o: Any, out: bytearray):
    if o is None or isinstance(o, bool):
        out.append({None: 0xC0, False: 0xC2, True: 0xC3}[o])
    elif isinstance(o, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, packb([list(o.shape), o.dtype.name,
                                            np.ascontiguousarray(o).tobytes()]))
    elif isinstance(o, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, packb([[], o.dtype.name, o.tobytes()]))
    elif isinstance(o, int):
        out += b"\xd3" + struct.pack(">q", o)
    elif isinstance(o, float):
        out += b"\xcb" + struct.pack(">d", o)
    elif isinstance(o, str):
        b = o.encode()
        _header(out, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(o, (bytes, bytearray)):
        _header(out, len(o), None, -1, (0xC4, 0xC5, 0xC6))
        out += o
    elif isinstance(o, dict):
        _header(out, len(o), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in o.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(o, (list, tuple)):
        _header(out, len(o), 0x90, 15, (None, 0xDC, 0xDD))
        for v in o:
            _pack(v, out)
    else:
        raise TypeError(f"cannot msgpack a {type(o).__name__}")


def _pack_ext(out: bytearray, code: int, data: bytes):
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _header(out, len(data), None, -1, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code) + data


def packb(obj: Any) -> bytes:
    """``obj`` (dicts, lists, str, bytes, ints, floats, None, bool, numpy
    arrays and scalars) as msgpack bytes, arrays in flax's ext type."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)
