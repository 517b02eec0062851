"""Reader of the JAX package's orbax checkpoints (``<dir>/<name>.orbax/``),
with no ``orbax``, ``tensorstore``, ``jax`` or ``ml_dtypes`` import: numpy
and pyarrow (its zstd codec) only.

``read_orbax(path)`` gives the tree ``utils/flax_msgpack.read_msgpack``
gives for the same state: nested dicts of numpy arrays, ``bfloat16`` leaves
as torch ``bfloat16`` tensors, an empty dict where the state had one.

What orbax-checkpoint (0.11, ``StandardCheckpointer``) writes, as read here
from the bytes:

- ``_METADATA``: JSON whose ``tree_metadata`` maps each leaf's path (the
  string of its key tuple) to ``key_metadata`` (the keys, in order) and
  ``value_metadata``. An empty dict is a ``value_type: "Dict"`` entry with
  ``skip_deserialize: true`` and no array, and None a ``"None"`` one. ``use_ocdbt`` is true and
  ``use_zarr3`` false: every array is a zarr v2 array in one OCDBT
  key-value store.
- The store (tensorstore's OCDBT): ``manifest.ocdbt`` names the root of a
  B-tree whose leaves hold the keys ``<path joined by ".">/.zarray`` (the
  array's zarr JSON) and ``<path>/<i>.<j>...`` (its chunks; ``0`` for a
  0-d array). A save by several processes writes one
  ``ocdbt.process_<k>/`` each; the top-level tree refers into them, so it
  is read the same way.
- A manifest or a B-tree node is ``magic`` (big-endian u32:
  ``0x0cdb3a2a`` manifest, ``0x0cdb20de`` node), its own length (u64 LE),
  varint version 0, varint compression (0 none, 1 zstd), the body (one
  zstd frame under compression 1; a large node's frame does not state its
  size) and crc32c of all that (u32 LE). Varints
  are LEB128; every per-entry field is stored as a column (all entries'
  values of one field, then the next field).
- Manifest body: uuid (16 bytes), varint manifest kind (0: this single
  file), varints max inline value bytes and max decoded node bytes, u8
  version tree arity log2, varint compression method (1 = zstd, then its
  level as i32 LE), then the version tree: a data file table, varint n
  versions, then the columns generation, root height (u8), data file,
  offset, length, num keys, num tree bytes, num indirect value bytes (all
  varints) and commit time (u64 LE); older versions in version-tree nodes
  follow and are not read: the newest version is the one the manifest
  holds last.
- Data file table: varint n files, varint path prefix length (shared with
  the previous path) for files 1..n-1, varint suffix length and varint base
  path length for every file, then the suffixes. A path is relative to the
  directory that holds the top-level manifest (``d/<hex>`` or
  ``ocdbt.process_0/d/<hex>``).
- Node body: u8 height, a data file table, varint n entries, varint key
  prefix length (shared with the previous key) for entries 1..n-1, varint
  key suffix length for every entry, then (interior nodes only) varint
  subtree common prefix length per entry, then the key suffixes. A leaf
  (height 0) then has varint value length, u8 value kind (0 inline, 1 in a
  data file), and, for the data file values only, varint data file and
  varint offset; the inline values follow, concatenated in entry order. An
  interior node has varint data file, offset, length, num keys, num tree
  bytes and num indirect value bytes per child. Every key of a node is
  stored without its subtree's common prefix: the parent's entry holds it
  as the first ``subtree common prefix length`` bytes of its own key, after
  the parent's prefix.
- A value in a data file is the raw bytes at (offset, length); a zarr
  chunk is itself one zstd frame (zarr's compressor, ``level`` 1), of the
  chunk's full shape (edge chunks are padded) in C order.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

MANIFEST_MAGIC, NODE_MAGIC = 0x0CDB3A2A, 0x0CDB20DE
ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
MANIFEST = "manifest.ocdbt"

_CRC32C = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC32C.append(_c)


def crc32c(data) -> int:
    """CRC-32C (Castagnoli), the OCDBT files' checksum."""
    c, table = 0xFFFFFFFF, _CRC32C
    for b in bytes(data):
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def zstd_content_size(frame) -> Optional[int]:
    """The decompressed size a zstd frame's header states (its frame
    content size field), or None where the header leaves it out."""
    frame = bytes(frame[:18])
    if frame[:4] != ZSTD_MAGIC:
        raise ValueError("not a zstd frame: its magic number is missing")
    fhd = frame[4]
    fcs_flag, single_segment, dict_flag = fhd >> 6, (fhd >> 5) & 1, fhd & 3
    pos = 5 + (0 if single_segment else 1) + (0, 1, 2, 4)[dict_flag]
    n = (1 if single_segment else 0, 2, 4, 8)[fcs_flag]
    if n == 0:
        return None
    size = int.from_bytes(frame[pos : pos + n], "little")
    return size + 256 if n == 2 else size


def zstd_decompress(frame, size: Optional[int] = None) -> bytes:
    """One zstd frame's content, by pyarrow's codec: in one call where the
    size is known (`size`, else the frame header's), else streamed (large
    B-tree nodes are written without their size)."""
    import pyarrow as pa

    if size is None:
        size = zstd_content_size(frame)
    if size is None:
        return pa.CompressedInputStream(pa.BufferReader(frame), "zstd").read()
    return pa.Codec("zstd").decompress(frame, decompressed_size=size, asbytes=True)


class _Cursor:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        start, self.pos = self.pos, self.pos + n
        if self.pos > len(self.data):
            raise ValueError(f"{self.what}: truncated at byte {start} ({n} wanted of {len(self.data)})")
        return self.data[start : self.pos]

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            b = self.u8()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint longer than 64 bits at byte {self.pos}")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]


def _unframe(data: bytes, magic: int, what: str) -> _Cursor:
    """The body of a manifest or node file: header, checksum and
    compression checked and undone."""
    if len(data) < 18:
        raise ValueError(f"{what}: {len(data)} bytes is too short for an OCDBT file")
    got_magic, length = struct.unpack_from(">I", data)[0], struct.unpack_from("<Q", data, 4)[0]
    if got_magic != magic:
        raise ValueError(f"{what}: magic 0x{got_magic:08x}, expected 0x{magic:08x}")
    if length != len(data):
        raise ValueError(f"{what}: states {length} bytes, holds {len(data)}")
    want = struct.unpack_from("<I", data, len(data) - 4)[0]
    if crc32c(data[:-4]) != want:
        raise ValueError(f"{what}: crc32c checksum mismatch")
    cur = _Cursor(data[:-4], what)
    cur.pos = 12
    version, compression = cur.varint(), cur.varint()
    if version != 0:
        raise ValueError(f"{what}: format version {version}, only 0 is read")
    body = cur.data[cur.pos :]
    if compression == 1:
        body = zstd_decompress(body)
    elif compression != 0:
        raise ValueError(f"{what}: compression {compression} (0 none and 1 zstd are read)")
    return _Cursor(body, what)


def _data_file_table(cur: _Cursor) -> List[str]:
    n = cur.varint()
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    cur.varints(n)  # base path lengths: the path is whole either way
    paths: List[str] = []
    for i in range(n):
        path = (paths[-1][: prefix[i]] if i else "") + cur.take(suffix[i]).decode()
        paths.append(path)
    return paths


def _keys(cur: _Cursor, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    common = cur.varints(n) if interior else [0] * n
    keys: List[bytes] = []
    for i in range(n):
        keys.append((keys[-1][: prefix[i]] if i else b"") + cur.take(suffix[i]))
    return keys, common


class OcdbtStore:
    """The key-value pairs of one OCDBT tree (the newest version), read
    from the directory that holds its ``manifest.ocdbt``: ``store[key]``
    gives the value's bytes."""

    def __init__(self, root: str):
        self.root = root
        manifest = os.path.join(root, MANIFEST)
        if not os.path.isfile(manifest):
            raise FileNotFoundError(f"{root} holds no {MANIFEST}: not an OCDBT checkpoint (or an unfinished save)")
        with open(manifest, "rb") as f:
            cur = _unframe(f.read(), MANIFEST_MAGIC, manifest)
        cur.take(16)  # uuid
        kind = cur.varint()
        if kind != 0:
            raise ValueError(f"{manifest}: manifest kind {kind}; only a single-file manifest (0) is read")
        cur.varints(2)  # max inline value bytes, max decoded node bytes
        cur.u8()  # version tree arity
        if cur.varint() == 1:
            cur.take(4)  # zstd level
        files = _data_file_table(cur)
        n = cur.varint()
        if n == 0:
            raise ValueError(f"{manifest}: no version")
        cur.varints(n)  # generation numbers, ascending: the newest version is the last
        height = [cur.u8() for _ in range(n)][-1]
        file_id, offset, length, num_keys = (cur.varints(n)[-1] for _ in range(4))
        self._entries: Dict[bytes, Any] = {}
        if num_keys:
            self._node(files[file_id], offset, length, height, b"")

    def _read(self, path: str, offset: int, length: int) -> bytes:
        with open(os.path.join(self.root, path), "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"{path}: {length} bytes wanted at offset {offset}, {len(data)} there")
        return data

    def _node(self, path: str, offset: int, length: int, height: int, key_prefix: bytes) -> None:
        what = f"{path}@{offset}"
        cur = _unframe(self._read(path, offset, length), NODE_MAGIC, what)
        if cur.u8() != height:
            raise ValueError(f"{what}: node height is not the {height} its parent states")
        files = _data_file_table(cur)
        n = cur.varint()
        keys, common = _keys(cur, n, interior=height > 0)
        if height > 0:
            file_id, off, size = cur.varints(n), cur.varints(n), cur.varints(n)
            cur.varints(3 * n)  # num keys, num tree bytes, num indirect value bytes
            for i in range(n):
                self._node(files[file_id[i]], off[i], size[i], height - 1, key_prefix + keys[i][: common[i]])
            return
        keys = [key_prefix + k for k in keys]
        sizes = cur.varints(n)
        kinds = [cur.u8() for _ in range(n)]
        indirect = [i for i in range(n) if kinds[i] == 1]
        if any(k not in (0, 1) for k in kinds):
            raise ValueError(f"{what}: value kinds {sorted(set(kinds))} (0 inline, 1 indirect)")
        file_id, off = cur.varints(len(indirect)), cur.varints(len(indirect))
        for j, i in enumerate(indirect):
            self._entries[keys[i]] = (files[file_id[j]], off[j], sizes[i])
        for i in range(n):
            if kinds[i] == 0:
                self._entries[keys[i]] = cur.take(sizes[i])
        if cur.pos != len(cur.data):
            raise ValueError(f"{what}: {len(cur.data) - cur.pos} bytes after the leaf's values")

    def keys(self) -> List[str]:
        return sorted(k.decode() for k in self._entries)

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._entries

    def __getitem__(self, key: str) -> bytes:
        value = self._entries.get(key.encode())
        if value is None:
            raise KeyError(f"{key!r} is not in the OCDBT store at {self.root}")
        return value if isinstance(value, bytes) else self._read(*value)


def _zarr_array(store: OcdbtStore, prefix: str):
    """The zarr v2 array at `prefix`, every chunk read and assembled."""
    spec = json.loads(store[f"{prefix}/.zarray"])
    if spec.get("zarr_format") != 2 or spec.get("order", "C") != "C" or spec.get("filters"):
        raise ValueError(f"{prefix}: zarr array {spec} (zarr v2, C order, no filters is read)")
    compressor = spec.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{prefix}: compressor {compressor['id']!r}; zstd or none is read")
    name = spec["dtype"]
    dtype = np.dtype(np.uint16 if name == "bfloat16" else name)
    shape, chunks = tuple(spec["shape"]), tuple(spec["chunks"]) or ()
    sep = spec.get("dimension_separator", ".")
    out = np.empty(shape, dtype=dtype.newbyteorder("="))
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    for index in np.ndindex(*grid):
        key = f"{prefix}/{sep.join(map(str, index)) if index else '0'}"
        if key not in store:
            raise ValueError(f"{prefix}: chunk {key!r} is missing (fill_value {spec.get('fill_value')!r})")
        raw = store[key]
        data = zstd_decompress(raw, chunk_bytes) if compressor is not None else raw
        if len(data) != chunk_bytes:
            raise ValueError(f"{key}: {len(data)} bytes, a chunk of {chunks} holds {chunk_bytes}")
        block = np.frombuffer(data, dtype=dtype).reshape(chunks)
        where = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))
        out[where] = block[tuple(slice(0, w.stop - w.start) for w in where)]
    if name == "bfloat16":
        return torch.from_numpy(out).view(torch.bfloat16)
    return out


# the unstored leaves a JAX train state's payload holds: an empty optimizer
# state ({}), an absent EMA (None)
_EMPTY = {"Dict": dict, "None": lambda: None}


def read_orbax(path: str) -> Any:
    """The state an orbax ``StandardCheckpointer`` saved at `path`, as nested
    dicts of arrays (``read_msgpack``'s tree for the same state)."""
    meta_path = os.path.join(path, "_METADATA")
    if not os.path.isfile(meta_path):
        raise FileNotFoundError(f"{path} holds no _METADATA: not an orbax checkpoint (or an unfinished save)")
    with open(meta_path) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(f"{path}: use_ocdbt={meta.get('use_ocdbt')}, use_zarr3={meta.get('use_zarr3')}; "
                         "the reader takes OCDBT with zarr v2 (orbax's default)")
    store = OcdbtStore(path)
    tree: Dict[str, Any] = {}
    for entry in meta["tree_metadata"].values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        value = entry["value_metadata"]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        if value.get("skip_deserialize"):
            kind = value.get("value_type")
            if kind not in _EMPTY:
                raise ValueError(f"{path}: leaf {keys} of type {kind!r} is not stored; the reader cannot rebuild it")
            node[keys[-1]] = _EMPTY[kind]()
        else:
            node[keys[-1]] = _zarr_array(store, ".".join(keys))
    return tree
