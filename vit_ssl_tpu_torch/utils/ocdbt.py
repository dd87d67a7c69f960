"""A read-only OCDBT store: the key-value format under an orbax checkpoint's
``tree/`` directory (tensorstore's "optionally-cooperative distributed
B+tree"), read without tensorstore.

:func:`open_store` reads the root ``manifest.ocdbt``, takes its newest
version and walks that version's B-tree down to its leaves, wherever the
nodes lie (a checkpoint that orbax wrote through several processes keeps
the root's nodes in ``d/`` and the leaves' data in ``ocdbt.process_<n>/d/``).
:meth:`Store.list` gives the keys, :meth:`Store.read` a value, whether it is
inline in its leaf node or in a data file (file, offset, length).

The format, as the tests pin it on files that tensorstore wrote:

- A manifest and every B-tree node is ``magic (u32 big-endian) | length (u64
  little-endian, of the whole record) | format version (varint, 0) |
  compression (varint: 0 none, 1 zstd) | body | CRC-32C (u32 little-endian,
  of every byte before it)``; magic ``0x0cdb3a2a`` for a manifest,
  ``0x0cdb20de`` for a B-tree node. Nodes lie in data files ``d/<name>``
  beside the raw bytes of out-of-line values; the data files have no header.
- The manifest's body: the config (uuid (16 bytes), manifest kind (varint;
  0 single, the only kind read here), max inline value bytes, max decoded
  node bytes (varints), version-tree arity log2 (u8), compression method
  (varint; 1 zstd, then its level as i32 little-endian)), then the newest
  versions inline: a data-file table, their count and, one column each,
  generation, root height (u8), the root's data file, offset and length,
  key count, tree bytes and out-of-line value bytes (varints) and commit
  time (u64). Older versions follow in version-tree nodes; only the newest
  version is read. An empty tree's root has offset and length 2^64 - 1.
- A data-file table: count, then for files 1.. the length shared with the
  previous file's path, for each file its path's remaining length and its
  base path's length, then the remaining bytes; the file is
  ``<base path><relative path>`` under the store's directory.
- A B-tree node's body: height (u8), a data-file table, the entry count,
  the keys (for entries 1.. the length shared with the previous key, each
  key's remaining length, in an interior node each child's common
  key-prefix length, then the remaining bytes). A leaf (height 0) then has
  each value's length, its kind (one byte: 0 inline, 1 in a data file),
  the data file and offset of each out-of-line value and the inline values'
  bytes. An interior node has each child's data file, offset and length,
  and three statistics (key count, tree bytes, out-of-line value bytes).
  A child's keys continue the prefix its parent's key gives it.

Each record's CRC-32C is checked; an unknown magic, format version,
compression or manifest kind is refused by name (:class:`OcdbtError`).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, NamedTuple, Optional, Tuple

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_NODE_MAGIC = 0x0CDB20DE
MANIFEST_FILE = "manifest.ocdbt"
_HEADER = 14  # magic, length, version and compression, when each varint is one byte
_MISSING = (1 << 64) - 1


class OcdbtError(ValueError):
    """A store this reader refuses: damaged, or of a kind it does not read."""


class Ref(NamedTuple):
    """Where a node or an out-of-line value lies: a path under the store's
    directory, a byte offset and a length."""

    path: str
    offset: int
    length: int


class _Cursor:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def fail(self, message: str):
        raise OcdbtError(f"{self.what}: byte {self.pos} of its body: {message}")

    def varint(self) -> int:
        value = shift = 0
        while True:
            if self.pos >= len(self.data):
                self.fail("varint runs past the end")
            b = self.data[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            self.fail(f"{n} bytes run past the end")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8s(self, n: int) -> bytes:
        return self.take(n)

    def u64s(self, n: int) -> List[int]:
        return list(struct.unpack(f"<{n}Q", self.take(8 * n)))

    def done(self) -> bool:
        return self.pos == len(self.data)


def _record_body(raw: bytes, magic: int, what: str) -> bytes:
    """The decoded body of one manifest or node record, its header and
    CRC-32C checked."""
    if len(raw) < _HEADER + 4:
        raise OcdbtError(f"{what}: {len(raw)} bytes, too short for a record")
    got_magic, length = struct.unpack_from(">I", raw)[0], struct.unpack_from("<Q", raw, 4)[0]
    if got_magic != magic:
        raise OcdbtError(f"{what}: magic {got_magic:#010x}, expected {magic:#010x}")
    if length != len(raw):
        raise OcdbtError(f"{what}: header says {length} bytes, the record has {len(raw)}")
    want = struct.unpack_from("<I", raw, len(raw) - 4)[0]
    got = zstd.crc32c(memoryview(raw)[:len(raw) - 4])
    if want != got:
        raise OcdbtError(f"{what}: CRC-32C mismatch (record says {want:#010x}, "
                         f"its bytes give {got:#010x})")
    head = _Cursor(raw[12:len(raw) - 4], what)
    version = head.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version} (only 0 is read)")
    compression = head.varint()
    body = raw[12 + head.pos:len(raw) - 4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body)
    raise OcdbtError(f"{what}: compression {compression} (only 0, none, and 1, zstd, "
                     "are read)")


def _data_file_table(c: _Cursor) -> List[str]:
    n = c.varint()
    shared = [0] + c.varints(max(n - 1, 0))
    rest = c.varints(n)
    base = c.varints(n)
    paths, prev = [], b""
    for i in range(n):
        if shared[i] > len(prev):
            c.fail(f"data file {i} shares {shared[i]} bytes of a {len(prev)}-byte path")
        full = prev[:shared[i]] + c.take(rest[i])
        if base[i] > len(full):
            c.fail(f"data file {i}'s base path is longer than its path")
        paths.append(full.decode())
        prev = full
    return paths


def _keys(c: _Cursor, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    """The node's keys and, in an interior node, each child's common
    key-prefix length (its column lies between the lengths and the bytes)."""
    shared = [0] + c.varints(max(n - 1, 0))
    rest = c.varints(n)
    common = c.varints(n) if interior else []
    keys, prev = [], b""
    for i in range(n):
        if shared[i] > len(prev):
            c.fail(f"key {i} shares {shared[i]} bytes of a {len(prev)}-byte key")
        prev = prev[:shared[i]] + c.take(rest[i])
        keys.append(prev)
    return keys, common


def _file(paths: List[str], index: int, c: _Cursor) -> str:
    if index >= len(paths):
        c.fail(f"data file {index} of a table of {len(paths)}")
    return paths[index]


class Config(NamedTuple):
    uuid: bytes
    max_inline_value_bytes: int
    max_decoded_node_bytes: int
    version_tree_arity_log2: int
    compression: Optional[int]  # the zstd level, None for none


class Version(NamedTuple):
    generation: int
    root_height: int
    root: Optional[Ref]  # None: the empty tree
    num_keys: int


def _read_manifest(body: bytes, what: str) -> Tuple[Config, List[Version]]:
    c = _Cursor(body, what)
    uuid = c.take(16)
    kind = c.varint()
    if kind != 0:
        c.fail(f"manifest kind {kind} (only 0, a single manifest file, is read)")
    max_inline, max_node = c.varint(), c.varint()
    arity = c.u8s(1)[0]
    method = c.varint()
    if method == 0:
        level = None
    elif method == 1:
        level = struct.unpack("<i", c.take(4))[0]
    else:
        c.fail(f"compression method {method} (only 0, none, and 1, zstd, are read)")
    config = Config(uuid, max_inline, max_node, arity, level)
    paths = _data_file_table(c)
    n = c.varint()
    generation = c.varints(n)
    height = c.u8s(n)
    files, offsets, lengths = c.varints(n), c.varints(n), c.varints(n)
    num_keys = c.varints(n)
    c.varints(n)  # tree bytes
    c.varints(n)  # out-of-line value bytes
    c.u64s(n)  # commit times
    versions = []
    for i in range(n):
        root = None
        if not (offsets[i] == _MISSING and lengths[i] == _MISSING):
            root = Ref(_file(paths, files[i], c), offsets[i], lengths[i])
        versions.append(Version(generation[i], height[i], root, num_keys[i]))
    return config, versions


class Store:
    """The newest version of an OCDBT store in ``root`` (a directory), read
    once: :meth:`list` the keys, :meth:`read` a value."""

    def __init__(self, root: str):
        self.root = root
        path = os.path.join(root, MANIFEST_FILE)
        with open(path, "rb") as f:
            raw = f.read()
        self.config, versions = _read_manifest(
            _record_body(raw, MANIFEST_MAGIC, path), path)
        if not versions:
            raise OcdbtError(f"{path}: no version")
        self.version = max(versions, key=lambda v: v.generation)
        self._values: Dict[str, object] = {}  # key -> bytes (inline) or Ref
        self._files: Dict[str, bytes] = {}
        if self.version.root is not None:
            self._walk(self.version.root, self.version.root_height, b"")
        if len(self._values) != self.version.num_keys:
            raise OcdbtError(f"{path}: version {self.version.generation} has "
                             f"{self.version.num_keys} keys, its tree {len(self._values)}")

    def _read_ref(self, ref: Ref) -> bytes:
        path = os.path.join(self.root, ref.path)
        with open(path, "rb") as f:
            f.seek(ref.offset)
            data = f.read(ref.length)
        if len(data) != ref.length:
            raise OcdbtError(f"{path}: {ref.length} bytes at offset {ref.offset} run past "
                             f"the file's end")
        return data

    def _walk(self, ref: Ref, height: int, prefix: bytes) -> None:
        what = f"{os.path.join(self.root, ref.path)} at offset {ref.offset}"
        body = _record_body(self._read_ref(ref), BTREE_NODE_MAGIC, what)
        c = _Cursor(body, what)
        got = c.u8s(1)[0]
        if got != height:
            c.fail(f"node of height {got} where its parent says {height}")
        paths = _data_file_table(c)
        n = c.varint()
        keys, common = _keys(c, n, interior=height > 0)
        if height == 0:
            lengths = c.varints(n)
            kinds = c.u8s(n)
            outside = [i for i in range(n) if kinds[i] == 1]
            if any(k > 1 for k in kinds):
                c.fail(f"value kind {max(kinds)} (0 inline, 1 in a data file)")
            files = c.varints(len(outside))
            offsets = c.varints(len(outside))
            refs = {i: Ref(_file(paths, f, c), o, lengths[i])
                    for i, f, o in zip(outside, files, offsets)}
            for i in range(n):
                key = (prefix + keys[i]).decode()
                self._values[key] = refs[i] if i in refs else c.take(lengths[i])
        else:
            files, offsets, lengths = c.varints(n), c.varints(n), c.varints(n)
            for _ in range(3):  # key count, tree bytes, out-of-line value bytes
                c.varints(n)
            for i in range(n):
                if common[i] > len(keys[i]):
                    c.fail(f"child {i}'s common prefix is longer than its key")
                child = Ref(_file(paths, files[i], c), offsets[i], lengths[i])
                self._walk(child, height - 1, prefix + keys[i][:common[i]])
        if not c.done():
            c.fail(f"{len(body) - c.pos} bytes left after the node's entries")

    def list(self) -> List[str]:
        """Every key, in order."""
        return sorted(self._values)

    def __contains__(self, key: str) -> bool:
        return key in self._values

    def ref(self, key: str) -> Optional[Ref]:
        """Where ``key``'s value lies in a data file; None for an inline value."""
        value = self._values[key]
        return value if isinstance(value, Ref) else None

    def read(self, key: str) -> bytes:
        """The value of ``key`` (KeyError when the store has none)."""
        value = self._values[key]
        if isinstance(value, Ref):
            return self._read_ref(value)
        return value


def open_store(tree_dir: str) -> Store:
    """The OCDBT store whose root manifest is ``<tree_dir>/manifest.ocdbt``."""
    if not os.path.exists(os.path.join(tree_dir, MANIFEST_FILE)):
        raise OcdbtError(f"{tree_dir} holds no {MANIFEST_FILE}: not an OCDBT store")
    return Store(tree_dir)
