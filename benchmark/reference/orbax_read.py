"""Read orbax checkpoints without JAX, orbax or tensorstore (a frozen copy
of the measured package's reader, so that the reference reads the trained
trees by itself).

An orbax ``StandardCheckpointer`` directory, as the JAX package's
``weights/checkpoints.save_checkpoint`` writes it and as the trained trees
under ``omniparser_tpu/weights/`` are committed, holds:

- ``_METADATA``: JSON whose ``tree_metadata`` maps each leaf's key tuple to
  its ``key_metadata`` (the tree path) and ``value_metadata``;
- an OCDBT key-value store (tensorstore's "optionally-cooperative
  distributed B+tree"): ``manifest.ocdbt``, B+tree and version-tree nodes
  and data files under ``d/`` and ``ocdbt.process_N/d/``;
- in that store, one zarr (format 2) array per leaf, under the leaf's path
  joined by ``.``: its ``.zarray`` JSON and its chunks (``0``, ``0.0``, ...).

Every OCDBT file (and every node within a data file) starts with a magic
number, its length as 8 little-endian bytes, a varint format version (0)
and a varint compression (0 none, 1 zstd), and ends with the CRC-32C of
all the bytes before it.  Integers in the bodies are varints; arrays of
records are stored column by column.  Anything this reader does not know
raises ``ValueError``; it never guesses.  Compressed nodes and chunks go
through the zstd decoder beside this file (``zstd.py``).

``read_orbax_tree(path)`` gives the nested dict of numpy arrays that the
JAX package's ``load_checkpoint(path)`` gives, bit for bit (a bfloat16
array comes back widened to float32, exactly).
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import struct
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np

from benchmark.reference import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
VERSION_NODE_MAGIC = 0x0CDB1234
BTREE_NODE_MAGIC = 0x0CDB20DE
_NO_ADDRESS = (1 << 64) - 1  # offset and length of an empty tree's root
# a manifest's decoded body holds a config and at most a few hundred
# version records; its own nodes are bounded by its max_decoded_node_bytes
_MANIFEST_LIMIT = 1 << 24


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as the OCDBT files' trailers hold it."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Cursor:
    """Reads the fields of one decoded body; every read is bounds-checked."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def fail(self, msg: str):
        raise ValueError(f"{self.what}: {msg} (at byte {self.pos})")

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            self.fail(f"truncated: {n} bytes wanted")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def varint(self) -> int:
        out = shift = 0
        while True:
            if self.pos >= len(self.data):
                self.fail("truncated varint")
            b = self.data[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if b < 0x80:
                break
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")
        if out >= 1 << 64:
            self.fail("varint larger than 64 bits")
        return out

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def end(self) -> None:
        if self.pos != len(self.data):
            self.fail(f"{len(self.data) - self.pos} bytes left over")


def _unwrap(buf: bytes, magic: int, what: str, limit: int) -> bytes:
    """Check one file's (or node's) header and trailer; its decoded body,
    of at most `limit` bytes where the zstd frame does not state its size."""
    if len(buf) < 4 + 8 + 1 + 1 + 4:
        raise ValueError(f"{what}: {len(buf)} bytes is shorter than a header and trailer")
    got = struct.unpack(">I", buf[:4])[0]
    if got != magic:
        raise ValueError(f"{what}: magic {got:#010x}, expected {magic:#010x}")
    length = struct.unpack("<Q", buf[4:12])[0]
    if length != len(buf):
        raise ValueError(f"{what}: header says {length} bytes, the file holds {len(buf)}")
    want = struct.unpack("<I", buf[-4:])[0]
    if crc32c(buf[:-4]) != want:
        raise ValueError(f"{what}: CRC-32C mismatch")
    head = _Cursor(buf[:-4], what)
    head.pos = 12
    version = head.varint()
    if version != 0:
        raise ValueError(f"{what}: format version {version}, only 0 is known")
    compression = head.varint()
    body = buf[head.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body, limit=limit).tobytes()
    raise ValueError(f"{what}: compression {compression}, only 0 (none) and 1 (zstd) are known")


def _data_file_table(c: _Cursor) -> List[str]:
    """Data file paths, relative to the store's root: each is a base path
    and a relative path, stored as a shared prefix with the previous one."""
    n = c.varint()
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    base = c.varints(n)
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            c.fail("data file path prefix longer than the previous path")
        full = prev[:prefix[i]] + c.take(suffix[i])
        if base[i] > len(full):
            c.fail("data file base path longer than the path")
        paths.append(full.decode())
        prev = full
    return paths


@dataclass(frozen=True)
class _Location:
    file: str
    offset: int
    length: int


def _locations(c: _Cursor, files: List[str], n: int) -> List[Optional[_Location]]:
    ids, offsets, lengths = c.varints(n), c.varints(n), c.varints(n)
    out: List[Optional[_Location]] = []
    for i, o, ln in zip(ids, offsets, lengths):
        if o == _NO_ADDRESS and ln == _NO_ADDRESS:
            out.append(None)
            continue
        if i >= len(files):
            c.fail(f"data file id {i} outside a table of {len(files)}")
        out.append(_Location(files[i], o, ln))
    return out


@dataclass(frozen=True)
class Version:
    generation: int
    root_height: int
    root: Optional[_Location]  # None: the empty tree
    num_keys: int


def _versions(c: _Cursor, files: List[str]) -> List[Version]:
    n = c.varint()
    generations = c.varints(n)
    heights = [c.u8() for _ in range(n)]
    roots = _locations(c, files, n)
    num_keys = c.varints(n)
    c.varints(n)  # num_tree_bytes
    c.varints(n)  # num_indirect_value_bytes
    for _ in range(n):
        c.u64()  # commit time, ns
    return [Version(*v) for v in zip(generations, heights, roots, num_keys)]


@dataclass(frozen=True)
class _VersionNodeRef:
    generation: int  # the newest generation under the node
    location: _Location
    num_generations: int
    height: int


def _version_node_refs(c: _Cursor, files: List[str], heights: Optional[List[int]] = None
                       ) -> List[_VersionNodeRef]:
    """References to version-tree nodes: the manifest's carry their
    heights in a last column, an interior node's children are one lower
    (`heights` given)."""
    n = c.varint()
    generations = c.varints(n)
    locations = _locations(c, files, n)
    num_generations = c.varints(n)
    for _ in range(n):
        c.u64()  # commit time, ns
    if heights is None:
        heights = [c.u8() for _ in range(n)]
    else:
        heights = heights * n
    if any(loc is None for loc in locations):
        c.fail("a version-tree node reference without an address")
    return [_VersionNodeRef(*v) for v in zip(generations, locations, num_generations, heights)]


class OcdbtStore:
    """One OCDBT store on the local disk, at its latest version."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        manifest = os.path.join(self.root, "manifest.ocdbt")
        with open(manifest, "rb") as f:
            c = _Cursor(_unwrap(f.read(), MANIFEST_MAGIC, manifest, _MANIFEST_LIMIT), manifest)
        c.take(16)  # uuid
        kind = c.varint()
        if kind != 0:
            c.fail(f"manifest kind {kind}: only a single-file manifest (0) is known")
        c.varint()  # max_inline_value_bytes
        self.max_node_bytes = c.varint()
        self.arity_log2 = c.u8()
        compression = c.varint()
        if compression == 1:
            c.take(4)  # zstd level, int32
        elif compression != 0:
            c.fail(f"compression method {compression}, only 0 (none) and 1 (zstd) are known")
        files = _data_file_table(c)
        versions = _versions(c, files)
        refs = _version_node_refs(c, files)
        c.end()
        self.version_nodes = 0  # version-tree nodes read (older generations)
        for ref in refs:
            versions.extend(self._version_node(ref))
        if not versions:
            c.fail("no version")
        gens = sorted(v.generation for v in versions)
        if gens != list(range(1, len(gens) + 1)):
            c.fail(f"generations {gens[:3]}...{gens[-3:]} are not 1..{len(gens)}")
        self.version = max(versions, key=lambda v: v.generation)
        self._entries: Optional[Dict[bytes, Any]] = None

    def _node(self, loc: _Location, magic: int, what: str) -> _Cursor:
        path = os.path.join(self.root, loc.file)
        with open(path, "rb") as f:
            f.seek(loc.offset)
            buf = f.read(loc.length)
        name = f"{what} {loc.file}@{loc.offset}+{loc.length}"
        if len(buf) != loc.length:
            raise ValueError(f"{name}: the file ends after {len(buf)} bytes")
        return _Cursor(_unwrap(buf, magic, name, self.max_node_bytes), name)

    def _version_node(self, ref: _VersionNodeRef) -> List[Version]:
        c = self._node(ref.location, VERSION_NODE_MAGIC, "version-tree node")
        self.version_nodes += 1
        arity = c.u8()
        if arity != self.arity_log2:
            c.fail(f"arity log2 {arity}, the manifest says {self.arity_log2}")
        height = c.u8()
        if height != ref.height:
            c.fail(f"height {height}, its reference says {ref.height}")
        files = _data_file_table(c)
        if height == 0:
            out = _versions(c, files)
            c.end()
        else:
            children = _version_node_refs(c, files, [height - 1])
            c.end()
            out = [v for child in children for v in self._version_node(child)]
        gens = sorted(v.generation for v in out)
        if len(gens) != ref.num_generations or (gens and gens[-1] != ref.generation):
            c.fail(f"{len(gens)} generations up to {gens[-1] if gens else None}, its "
                   f"reference says {ref.num_generations} up to {ref.generation}")
        return out

    def _walk(self, loc: _Location, height: int, prefix: bytes) -> Iterator[Tuple[bytes, Any]]:
        c = self._node(loc, BTREE_NODE_MAGIC, "B+tree node")
        got = c.u8()
        if got != height:
            c.fail(f"height {got}, its reference says {height}")
        files = _data_file_table(c)
        n = c.varint()
        prefix_len = [0] + c.varints(n - 1) if n else []
        suffix_len = c.varints(n)
        # an interior node stores, before the key bytes, how much of each
        # child's first key all keys under that child share
        common = c.varints(n) if height else []
        keys, prev = [], b""
        for p, s in zip(prefix_len, suffix_len):
            if p > len(prev):
                c.fail("key prefix longer than the previous key")
            prev = prev[:p] + c.take(s)
            keys.append(prev)
        if height == 0:
            lengths = c.varints(n)
            kinds = c.varints(n)
            if any(k not in (0, 1) for k in kinds):
                c.fail(f"value kinds {sorted(set(kinds))}: only 0 (inline) and 1 (indirect)")
            indirect = [i for i, k in enumerate(kinds) if k == 1]
            ids, offsets = c.varints(len(indirect)), c.varints(len(indirect))
            values: List[Any] = [None] * n
            for i, fid, off in zip(indirect, ids, offsets):
                if fid >= len(files):
                    c.fail(f"data file id {fid} outside a table of {len(files)}")
                values[i] = _Location(files[fid], off, lengths[i])
            for i in range(n):
                if kinds[i] == 0:
                    values[i] = c.take(lengths[i])
            c.end()
            for k, v in zip(keys, values):
                yield prefix + k, v
            return
        children = _locations(c, files, n)
        c.varints(n)  # num_keys
        c.varints(n)  # num_tree_bytes
        c.varints(n)  # num_indirect_value_bytes
        c.end()
        for k, cp, child in zip(keys, common, children):
            if cp > len(k) or child is None:
                c.fail("bad child reference")
            yield from self._walk(child, height - 1, prefix + k[:cp])

    def entries(self) -> Dict[bytes, Any]:
        """Every key -> its value (inline bytes or a data-file location)."""
        if self._entries is None:
            v = self.version
            entries: Dict[bytes, Any] = {}
            if v.root is not None:
                for k, val in self._walk(v.root, v.root_height, b""):
                    if entries and k <= next(reversed(entries)):
                        raise ValueError(f"{self.root}: keys out of order at {k!r}")
                    entries[k] = val
            if len(entries) != v.num_keys:
                raise ValueError(f"{self.root}: {len(entries)} keys, the version says {v.num_keys}")
            self._entries = entries
        return self._entries

    def keys(self) -> List[bytes]:
        return list(self.entries())

    def read(self, key: bytes) -> Optional[bytes]:
        """The value of `key`, or None where the store lacks it."""
        val = self.entries().get(key)
        if val is None or isinstance(val, bytes):
            return val
        path = os.path.join(self.root, val.file)
        with open(path, "rb") as f:
            f.seek(val.offset)
            out = f.read(val.length)
        if len(out) != val.length:
            raise ValueError(f"{path}: value of {key!r} ends after {len(out)} of {val.length} bytes")
        return out


# zarr format 2 dtypes the reader handles; bfloat16 has no numpy dtype: it
# is read as its 16 bits and widened to float32, which holds every value
_DTYPES = {"<f4": np.float32, "<f2": np.float16, "<f8": np.float64, "<i4": np.int32,
           "<i8": np.int64, "<u4": np.uint32, "|u1": np.uint8, "|i1": np.int8,
           "|b1": np.bool_, "bfloat16": np.uint16}


def _fill(value, dtype: np.dtype, name: str):
    if value is None:
        return 0
    if dtype == np.bool_ or isinstance(value, (int, float, bool)):
        return value
    if value in ("NaN", "Infinity", "-Infinity") and dtype.kind == "f":
        return float(value.replace("Infinity", "inf"))
    raise ValueError(f"{name}: fill_value {value!r} is not understood")


def read_zarr_array(store: OcdbtStore, name: str) -> np.ndarray:
    """The zarr 2 array stored under `name` (its ``.zarray`` and chunks)."""
    raw = store.read(f"{name}/.zarray".encode())
    if raw is None:
        raise ValueError(f"{store.root}: no array {name!r}")
    meta = json.loads(raw)
    where = f"{store.root}: {name}"
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{where}: zarr_format {meta.get('zarr_format')}, only 2 is known")
    if meta.get("dtype") not in _DTYPES:
        raise ValueError(f"{where}: dtype {meta.get('dtype')!r} is not handled")
    dtype = np.dtype(_DTYPES[meta["dtype"]])
    order = meta.get("order", "C")
    if order not in ("C", "F"):
        raise ValueError(f"{where}: order {order!r}")
    if meta.get("filters"):
        raise ValueError(f"{where}: filters {meta['filters']} are not handled")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{where}: compressor {comp.get('id')!r}, only zstd or none")
    sep = meta.get("dimension_separator", ".")
    if sep != ".":
        raise ValueError(f"{where}: dimension separator {sep!r}, only '.'")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or any(c <= 0 for c in chunks) or any(s < 0 for s in shape):
        raise ValueError(f"{where}: shape {shape} and chunks {chunks} disagree")
    if meta["dtype"] == "bfloat16" and meta.get("fill_value") not in (None, 0):
        raise ValueError(f"{where}: bfloat16 fill_value {meta['fill_value']!r} is not handled")
    out = np.full(shape, _fill(meta.get("fill_value"), dtype, where), dtype)
    chunk_bytes = math.prod(chunks) * dtype.itemsize
    grid = [range(math.ceil(s / c)) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*[len(g) for g in grid]) if shape else [()]:
        key = ".".join(str(i) for i in idx) if idx else "0"
        value = store.read(f"{name}/{key}".encode())
        if value is None:
            continue  # a chunk equal to fill_value need not be stored
        data = zstd.decompress(value, chunk_bytes) if comp is not None else value
        data = np.frombuffer(data, np.uint8)
        if data.size != chunk_bytes:
            raise ValueError(f"{where}/{key}: {data.size} bytes, a chunk holds {chunk_bytes}")
        chunk = data.view(dtype).reshape(chunks, order=order)
        sl = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[sl] = chunk[tuple(slice(0, s.stop - s.start) for s in sl)]
    if meta["dtype"] == "bfloat16":
        return (out.astype(np.uint32) << 16).view(np.float32)
    return out


def is_orbax_dir(path: str) -> bool:
    """Whether `path` is an orbax checkpoint of an OCDBT store."""
    return (os.path.isfile(os.path.join(path, "_METADATA"))
            and os.path.isfile(os.path.join(path, "manifest.ocdbt")))


def read_orbax_tree(path: str) -> Dict[str, Any]:
    """The nested dict of numpy arrays an orbax ``StandardCheckpointer``
    saved at `path`.  The tree comes from ``_METADATA``'s key tuples (dict
    keys only); each leaf is the zarr array under its keys joined by '.'."""
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"{path}: zarr 3 arrays are not handled")
    if meta.get("use_ocdbt") is False:
        raise ValueError(f"{path}: only OCDBT checkpoints are handled")
    store = OcdbtStore(path)
    tree: Dict[str, Any] = {}
    for flat, entry in meta["tree_metadata"].items():
        keys = entry["key_metadata"]
        if not keys or any(k.get("key_type") != 2 for k in keys):
            raise ValueError(f"{path}: {flat}: only dict keys (key_type 2) are handled")
        value = entry["value_metadata"]
        if value.get("value_type") != "np.ndarray" or value.get("skip_deserialize"):
            raise ValueError(f"{path}: {flat}: value {value} is not a stored numpy array")
        names = [str(k["key"]) for k in keys]
        node = tree
        for k in names[:-1]:
            node = node.setdefault(k, {})
            if not isinstance(node, dict):
                raise ValueError(f"{path}: {flat} lies under a leaf")
        if names[-1] in node:
            raise ValueError(f"{path}: {flat} appears twice")
        node[names[-1]] = read_zarr_array(store, ".".join(names))
    return tree


def tree_digest(tree: Mapping) -> str:
    """sha256 over a nested dict of arrays: for each leaf, in the order of
    its '/'-joined key, the key, dtype, shape and bytes (C order)."""
    leaves = []

    def walk(node, prefix):
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                walk(v, key)
            else:
                leaves.append((key, np.ascontiguousarray(v)))

    walk(tree, "")
    h = hashlib.sha256()
    for key, arr in sorted(leaves, key=lambda kv: kv[0]):
        h.update(f"{key}\0{arr.dtype.str}\0{arr.shape}\0".encode())
        h.update(arr.tobytes())
    return h.hexdigest()
