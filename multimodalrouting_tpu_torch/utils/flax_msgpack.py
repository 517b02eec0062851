"""Reader of flax's msgpack checkpoints (counterpart of
``flax.serialization.msgpack_restore``), with no ``msgpack``, ``flax``,
``jax`` or ``ml_dtypes`` import.

The JAX package writes each checkpoint as ``<dir>/<name>.msgpack``: the
state dict of its train state, serialised by ``msgpack_serialize``. That is
plain msgpack (maps with string keys, arrays, strings, bin, nil, booleans,
integers, floats) plus two extension types:

- ext 1, an ndarray: its payload is itself a msgpack array
  ``(shape, dtype name, C-order bytes)``;
- ext 3, a numpy scalar, encoded as a 0-d ndarray.

Ext 2 (a Python complex) is refused. Leaves larger than flax's chunk size
(2**30 bytes) are written as ``{"__msgpack_chunked_array__": True, "shape":
{"0": ...}, "chunks": {"0": array, ...}}`` and joined back here, as flax
joins them.

The file is read once into a writable buffer and decoded over a
``memoryview`` of it: every ndarray of a numpy dtype comes back as a numpy
array over that buffer (no copy), and every ``bfloat16`` one as a torch
``bfloat16`` tensor over it (read as ``uint16`` and viewed as bf16, since
numpy has no bf16 of its own). Msgpack arrays come back as lists, maps as
dicts, as ``msgpack_restore`` gives them.
"""
from __future__ import annotations

import os
import struct
from typing import Any, Tuple

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


class _Decoder:
    def __init__(self, buf: memoryview):
        self.buf, self.pos = buf, 0

    def _take(self, n: int) -> memoryview:
        start, self.pos = self.pos, self.pos + n
        if self.pos > len(self.buf):
            raise ValueError(f"truncated msgpack data: {n} bytes wanted at offset {start} of {len(self.buf)}")
        return self.buf[start : self.pos]

    def _unpack(self, fmt: str):
        value = struct.unpack_from(fmt, self.buf, self.pos)[0]
        self.pos += struct.calcsize(fmt)
        return value

    def _str(self, n: int) -> str:
        return str(self._take(n), "utf-8")

    def _array(self, n: int) -> list:
        return [self.decode() for _ in range(n)]

    def _map(self, n: int) -> dict:
        return {self.decode(): self.decode() for _ in range(n)}

    def _ext(self, n: int):
        code = self._unpack(">b")
        start = self.pos
        self._take(n)
        return _ext_value(code, self.buf, start, n)

    def decode(self) -> Any:
        b = self._unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self._map(b & 0x0F)
        if b <= 0x9F:
            return self._array(b & 0x0F)
        if b <= 0xBF:
            return self._str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self._take(self._unpack((">B", ">H", ">I")[b - 0xC4])))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            return self._ext(self._unpack((">B", ">H", ">I")[b - 0xC7]))
        if b in (0xCA, 0xCB):
            return self._unpack(">f" if b == 0xCA else ">d")
        if 0xCC <= b <= 0xD3:  # uint 8-64, int 8-64
            return self._unpack((">B", ">H", ">I", ">Q", ">b", ">h", ">i", ">q")[b - 0xCC])
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            return self._ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return self._str(self._unpack((">B", ">H", ">I")[b - 0xD9]))
        if b in (0xDC, 0xDD):
            return self._array(self._unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self._map(self._unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"byte 0x{b:02x} at offset {self.pos - 1} starts no msgpack value")


def _header(buf: memoryview, start: int, n: int) -> Tuple[list, str, int, int]:
    """An ndarray payload's (shape, dtype name, data offset, data length):
    its last element is a bin whose bytes stay in the buffer."""
    dec = _Decoder(buf[: start + n])
    dec.pos = start
    b = dec._unpack(">B")
    size = b & 0x0F if 0x90 <= b <= 0x9F else dec._unpack(">H" if b == 0xDC else ">I") if b in (0xDC, 0xDD) else -1
    if size != 3:
        raise ValueError(f"ndarray payload at offset {start} is not a 3-element msgpack array")
    shape, name = dec.decode(), dec.decode()
    name = name.decode() if isinstance(name, bytes) else name
    b = dec._unpack(">B")
    if b not in (0xC4, 0xC5, 0xC6):
        raise ValueError(f"ndarray payload at offset {start}: its data is not msgpack bin")
    length = dec._unpack((">B", ">H", ">I")[b - 0xC4])
    if dec.pos + length != start + n:
        raise ValueError(f"ndarray payload at offset {start}: {length} data bytes in a {n}-byte extension")
    return list(shape), name, dec.pos, length


def _ndarray(buf: memoryview, start: int, n: int):
    shape, name, offset, length = _header(buf, start, n)
    if name == "bfloat16":
        flat = np.frombuffer(buf, dtype=np.uint16, count=length // 2, offset=offset)
        return torch.from_numpy(flat).view(torch.bfloat16).reshape(shape)
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise ValueError(f"ndarray of dtype {name!r}: not a numpy dtype, and only bfloat16 is read besides") from e
    if dtype.hasobject:
        raise ValueError(f"ndarray of object dtype {name!r}")
    return np.frombuffer(buf, dtype=dtype, count=length // max(dtype.itemsize, 1), offset=offset).reshape(shape)


def _ext_value(code: int, buf: memoryview, start: int, n: int):
    if code == EXT_NDARRAY:
        return _ndarray(buf, start, n)
    if code == EXT_NPSCALAR:
        arr = _ndarray(buf, start, n)
        return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
    if code == EXT_COMPLEX:
        raise ValueError("msgpack ext 2 (a Python complex) is not a checkpoint leaf the port reads")
    raise ValueError(f"msgpack ext type {code} is not one flax writes")


def _unchunk(d: dict):
    shape = [d["shape"][str(i)] for i in range(len(d["shape"]))]
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_tree(tree):
    """flax's ``_unchunk_array_leaves_in_place``: a chunked leaf at the top
    or as any dict's value is joined back into one array."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        return _unchunk(tree)
    for k, v in tree.items():
        if isinstance(v, dict):
            tree[k] = _unchunk(v) if CHUNKED in v else _unchunk_tree(v)
    return tree


def msgpack_restore(data) -> Any:
    """Decode flax msgpack bytes into dicts, lists and array leaves, which
    share the buffer (read-only input is copied once, so that every leaf is
    writable)."""
    buf = memoryview(data)
    if buf.readonly:
        buf = memoryview(bytearray(buf))
    dec = _Decoder(buf)
    tree = dec.decode()
    if dec.pos != len(buf):
        raise ValueError(f"{len(buf) - dec.pos} bytes after the msgpack value")
    return _unchunk_tree(tree)


def read_msgpack(path: str) -> Any:
    """``msgpack_restore`` of the file at `path`, read once into memory."""
    buf = bytearray(os.path.getsize(path))
    with open(path, "rb") as f:
        if f.readinto(buf) != len(buf):
            raise ValueError(f"{path}: short read")
    return msgpack_restore(buf)
