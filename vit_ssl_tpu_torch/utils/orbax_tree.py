"""Orbax pytree checkpoints (the JAX package's ``<run>/<name>/tree``) read
and written without orbax, tensorstore or JAX.

:func:`read_tree` rebuilds the nested structure that ``orbax``'s
``PyTreeCheckpointer().restore(tree_dir)`` returns, from ``_METADATA``:

- ``tree_metadata`` maps each leaf's key path to its keys (``key_type`` 2 a
  dict key, 1 a sequence index: the sequence comes back as a list, as orbax
  gives it without a template; an optax NamedTuple is a dict of its field
  names) and its ``value_type``;
- ``jax.Array`` and ``np.ndarray`` leaves are zarr v2 arrays in the
  checkpoint's OCDBT store (:mod:`.ocdbt`) under the dotted key path
  (``opt_state.0.mu.a.kernel/.zarray``, chunks ``…/0.0``); ``scalar`` leaves
  are 0-d arrays given back as Python numbers; ``None``, ``Dict`` and
  ``List`` leaves (optax's empty states, ``MaskedNode``, empty containers)
  are ``None``, ``{}`` and ``[]``.

A zarr array is read in C order with ``dimension_separator`` ".", compressor
zstd (:mod:`.zstd`) or none, no filters, and dtype ``<f4``, ``<f2``,
``<f8``, ``<i4``, ``<i8``, ``|b1``, ``|u1`` or ``bfloat16``; its chunks are
assembled, and a chunk the store does not hold takes ``fill_value``. The
arrays come back as numpy arrays, except ``bfloat16`` ones, which numpy has
no type for: they come back as ``torch.bfloat16`` tensors. Anything else
(zarr v3, another compressor, F order, a missing chunk with no fill value,
an unknown value type) is refused with :class:`OrbaxTreeError`, naming the
leaf and the field; so is a tree written with ``use_ocdbt`` false, which
the JAX package's ``PyTreeCheckpointer()`` does not write.

:func:`write_tree` writes the same layout from nested dicts, lists, ``None``
and arrays (numpy or torch): one zarr chunk an array, each a zstd frame of
Raw blocks, every value and one OCDBT leaf node in one data file, and a
single-version manifest, so that orbax restores it. It exists for machines
without orbax; the trainers save the port's own ``state.pt``.
"""

from __future__ import annotations

import base64
import json
import os
import shutil
import struct
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from . import ocdbt, zstd

METADATA_FILE = "_METADATA"
_ZARRAY = ".zarray"
_DICT_KEY, _SEQUENCE_KEY = 2, 1
_ARRAY_TYPES = ("jax.Array", "np.ndarray")
_EMPTY = {"None": lambda: None, "Dict": dict, "List": list}
_DTYPES = {"<f4": np.float32, "<f2": np.float16, "<f8": np.float64, "<i4": np.int32,
           "<i8": np.int64, "|b1": np.bool_, "|u1": np.uint8, "bfloat16": np.uint16}
_MAX_INLINE = 1024


class OrbaxTreeError(ValueError):
    """An orbax tree this reader refuses, naming the leaf and the field."""


def _fail(leaf: str, field: str, message: str):
    raise OrbaxTreeError(f"orbax tree leaf {leaf!r}, {field}: {message}")


def _read_array(store, leaf: str):
    if leaf + "/" + _ZARRAY not in store:
        _fail(leaf, _ZARRAY, "the store holds no array metadata for it")
    meta = json.loads(store.read(f"{leaf}/{_ZARRAY}"))
    if meta.get("zarr_format") != 2:
        _fail(leaf, "zarr_format", f"{meta.get('zarr_format')!r} (only 2 is read)")
    if meta.get("order", "C") != "C":
        _fail(leaf, "order", f"{meta['order']!r} (only C is read)")
    if meta.get("filters"):
        _fail(leaf, "filters", f"{meta['filters']!r} (none are read)")
    sep = meta.get("dimension_separator", ".")
    if sep != ".":
        _fail(leaf, "dimension_separator", f"{sep!r} (only '.' is read)")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        _fail(leaf, "compressor", f"{compressor.get('id')!r} (only zstd or none is read)")
    code = meta.get("dtype")
    if code not in _DTYPES:
        _fail(leaf, "dtype", f"{code!r} (read: {sorted(_DTYPES)})")
    dtype = np.dtype(_DTYPES[code])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or any(c <= 0 for c in chunks):
        _fail(leaf, "chunks", f"{list(chunks)} for shape {list(shape)}")
    out = np.empty(shape, dtype)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    single = chunks == shape  # one chunk, the whole array: decoded in place
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    for index in np.ndindex(*grid):
        key = f"{leaf}/{'.'.join(map(str, index)) if index else '0'}"
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(index, chunks, shape))
        if key not in store:
            out[region] = _fill(meta.get("fill_value"), code, dtype, leaf, key)
            continue
        data = store.read(key)
        target = out if single else np.empty(chunks, dtype)
        if compressor is None:
            if len(data) != chunk_bytes:
                _fail(leaf, key, f"{len(data)} bytes, a chunk holds {chunk_bytes}")
            target.reshape(-1).view(np.uint8)[:] = np.frombuffer(data, np.uint8)
        else:
            try:
                zstd.decompress_into(data, target)
            except ValueError as e:
                _fail(leaf, key, str(e))
        if not single:  # zarr v2 stores edge chunks whole: keep what lies inside
            out[region] = target[tuple(slice(0, r.stop - r.start) for r in region)]
    if code == "bfloat16":
        return torch.from_numpy(out).view(torch.bfloat16)
    return out


def _fill(fill, code: str, dtype: np.dtype, leaf: str, key: str):
    """The value of an absent chunk's elements."""
    if fill is None:
        _fail(leaf, "fill_value", f"chunk {key!r} is absent and fill_value is null")
    if code == "bfloat16":
        return torch.tensor(float(fill), dtype=torch.bfloat16).view(torch.int16).numpy().view(
            np.uint16)
    return np.asarray(fill).astype(dtype)


def _leaf_name(keys: List[Dict[str, Any]]) -> str:
    return ".".join(str(k["key"]) for k in keys)


def read_tree(tree_dir: str) -> Any:
    """The pytree of the orbax checkpoint in ``tree_dir`` (the directory
    holding ``_METADATA``), as nested dicts and lists of numpy arrays (see
    the module docstring)."""
    path = os.path.join(tree_dir, METADATA_FILE)
    if not os.path.exists(path):
        raise OrbaxTreeError(f"{tree_dir} holds no {METADATA_FILE}: not an orbax tree")
    with open(path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise OrbaxTreeError(f"{path}: use_zarr3 is true (only zarr v2 trees are read)")
    if not meta.get("use_ocdbt", True):
        raise OrbaxTreeError(f"{path}: use_ocdbt is false (only OCDBT trees are read)")
    store = ocdbt.open_store(tree_dir)
    root: Any = None
    entries = meta.get("tree_metadata", {})
    for entry in entries.values():
        keys, value = entry["key_metadata"], entry["value_metadata"]
        leaf = _leaf_name(keys)
        vtype = value.get("value_type")
        if vtype in _EMPTY:
            item = _EMPTY[vtype]()
        elif vtype in _ARRAY_TYPES or vtype == "scalar":
            item = _read_array(store, leaf)
            if vtype == "scalar":
                item = item.item()
        else:
            _fail(leaf, "value_type", f"{vtype!r} (read: {sorted(_ARRAY_TYPES)}, "
                  f"'scalar', {sorted(_EMPTY)})")
        root = _insert(root, keys, item, leaf)
    return {} if root is None else _finish(root)


class _Seq(dict):
    """A sequence under construction: index -> item."""


def _insert(node, keys, item, leaf):
    if not keys:
        return item
    kind, key = keys[0]["key_type"], keys[0]["key"]
    if kind == _DICT_KEY:
        node = {} if node is None else node
        if isinstance(node, _Seq) or not isinstance(node, dict):
            _fail(leaf, "key_metadata", f"key {key!r} is a dict key where a sequence is")
    elif kind == _SEQUENCE_KEY:
        node = _Seq() if node is None else node
        if not isinstance(node, _Seq):
            _fail(leaf, "key_metadata", f"key {key!r} is a sequence index where a dict is")
        key = int(key)
    else:
        _fail(leaf, "key_type", f"{kind!r} (2 a dict key, 1 a sequence index)")
    node[key] = _insert(node.get(key), keys[1:], item, leaf)
    return node


def _finish(node):
    if isinstance(node, _Seq):
        n = len(node)
        if sorted(node) != list(range(n)):
            raise OrbaxTreeError(f"orbax tree: sequence indices {sorted(node)} are not 0..{n - 1}")
        return [_finish(node[i]) for i in range(n)]
    if isinstance(node, dict):
        return {k: _finish(v) for k, v in node.items()}
    return node


# -- writing -------------------------------------------------------------------------


def _as_numpy(x) -> Tuple[np.ndarray, str]:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        x = x.numpy()
    x = np.asarray(x)
    if not x.flags.c_contiguous:  # (ascontiguousarray would make a 0-d array 1-d)
        x = x.copy()
    for code, dtype in _DTYPES.items():
        if code != "bfloat16" and x.dtype == dtype:
            return x, code
    raise OrbaxTreeError(f"write_tree: dtype {x.dtype} is not one of {sorted(_DTYPES)}")


def _flatten(node, path, out):
    if isinstance(node, dict) and node:
        for k, v in node.items():
            _flatten(v, path + [(str(k), _DICT_KEY)], out)
    elif isinstance(node, (list, tuple)) and node:
        for i, v in enumerate(node):
            _flatten(v, path + [(str(i), _SEQUENCE_KEY)], out)
    else:
        out.append((path, node))


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(values) -> bytes:
    return b"".join(_varint(v) for v in values)


def _record(magic: int, body: bytes) -> bytes:
    """A manifest or node record, uncompressed, with its length and CRC-32C."""
    head = struct.pack(">I", magic) + struct.pack("<Q", 12 + 2 + len(body) + 4) + b"\x00\x00"
    data = head + body
    return data + struct.pack("<I", zstd.crc32c(data))


def _table(paths: List[str]) -> bytes:
    """A data-file table of paths with empty base paths."""
    encoded = [p.encode() for p in paths]
    return (_varint(len(paths)) + _varints(0 for _ in paths[1:])
            + _varints(len(p) for p in encoded) + _varints(0 for _ in paths) + b"".join(encoded))


def write_tree(tree_dir: str, tree: Any) -> None:
    """Writes ``tree`` (nested dicts and lists of numpy arrays, torch tensors,
    Python numbers and ``None``) to ``tree_dir`` in orbax's layout: OCDBT,
    zarr v2, zstd. ``tree_dir`` is replaced."""
    leaves: List[Tuple[list, Any]] = []
    _flatten(tree, [], leaves)
    shutil.rmtree(tree_dir, ignore_errors=True)
    os.makedirs(os.path.join(tree_dir, "d"))
    os.makedirs(os.path.join(tree_dir, "array_metadatas"))
    data_name = "d/" + os.urandom(16).hex()
    tree_meta, sharding, array_meta = {}, {}, []
    values: Dict[bytes, Any] = {}  # key -> bytes (inline) or (offset, length)
    offset = 0
    with open(os.path.join(tree_dir, data_name), "wb") as data_file:
        for path, value in leaves:
            keys = [{"key": k, "key_type": t} for k, t in path]
            name = ".".join(k for k, _ in path)
            tuple_key = str(tuple(k for k, _ in path))
            if value is None or (isinstance(value, (dict, list, tuple)) and not value):
                vtype = ("None" if value is None
                         else "Dict" if isinstance(value, dict) else "List")
                tree_meta[tuple_key] = {"key_metadata": keys, "value_metadata": {
                    "value_type": vtype, "skip_deserialize": True}}
                continue
            scalar = isinstance(value, (int, float, bool)) and not isinstance(value, np.ndarray)
            array, code = _as_numpy(np.asarray(value) if scalar else value)
            shape = list(array.shape)
            if scalar:
                tree_meta[tuple_key] = {"key_metadata": keys, "value_metadata": {
                    "value_type": "scalar", "skip_deserialize": False}}
            else:
                tree_meta[tuple_key] = {"key_metadata": keys, "value_metadata": {
                    "value_type": "jax.Array", "skip_deserialize": False, "write_shape": shape}}
                sharding[base64.b64encode(name.encode()).decode()] = json.dumps(
                    {"sharding_type": "SingleDeviceSharding", "device_str": "TFRT_CPU_0"})
                array_meta.append({"array_metadata": {"param_name": name, "write_shape": shape,
                                                      "chunk_shape": shape, "ext_metadata": None}})
            zarray = {"chunks": shape, "compressor": {"id": "zstd", "level": 1},
                      "dimension_separator": ".", "dtype": code, "fill_value": None,
                      "filters": None, "order": "C", "shape": shape, "zarr_format": 2}
            values[f"{name}/{_ZARRAY}".encode()] = json.dumps(
                zarray, separators=(",", ":")).encode()
            chunk = zstd.frame_raw(array.reshape(-1).view(np.uint8))
            chunk_key = f"{name}/{'.'.join('0' for _ in shape) if shape else '0'}".encode()
            if len(chunk) <= _MAX_INLINE:
                values[chunk_key] = chunk
            else:
                data_file.write(chunk)
                values[chunk_key] = (offset, len(chunk))
                offset += len(chunk)
        keys_sorted = sorted(values)
        node = bytearray(b"\x00")  # height 0
        node += _table([data_name])
        node += _varint(len(keys_sorted))
        prev = b""
        shared = []
        for k in keys_sorted:
            n = 0
            while n < min(len(k), len(prev)) and k[n] == prev[n]:
                n += 1
            shared.append(n)
            prev = k
        node += _varints(shared[1:])
        node += _varints(len(k) - s for k, s in zip(keys_sorted, shared))
        node += b"".join(k[s:] for k, s in zip(keys_sorted, shared))
        refs = [values[k] for k in keys_sorted]
        node += _varints(r[1] if isinstance(r, tuple) else len(r) for r in refs)
        node += bytes(1 if isinstance(r, tuple) else 0 for r in refs)
        outside = [r for r in refs if isinstance(r, tuple)]
        node += _varints(0 for _ in outside)
        node += _varints(r[0] for r in outside)
        node += b"".join(r for r in refs if not isinstance(r, tuple))
        record = _record(ocdbt.BTREE_NODE_MAGIC, bytes(node))
        data_file.write(record)
    manifest = bytearray(os.urandom(16))  # uuid
    manifest += _varint(0) + _varint(_MAX_INLINE) + _varint(100_000_000) + b"\x04" + _varint(0)
    manifest += _table([data_name])
    manifest += _varint(1)  # one version
    manifest += _varint(1) + b"\x00" + _varint(0) + _varint(offset) + _varint(len(record))
    manifest += _varint(len(keys_sorted)) + _varint(len(record)) + _varint(offset)
    manifest += struct.pack("<Q", time.time_ns())
    manifest += _varint(0)  # no version-tree nodes
    with open(os.path.join(tree_dir, ocdbt.MANIFEST_FILE), "wb") as f:
        f.write(_record(ocdbt.MANIFEST_MAGIC, bytes(manifest)))
    meta = {"tree_metadata": tree_meta, "use_ocdbt": True, "use_zarr3": False,
            "store_array_data_equal_to_fill_value": True, "custom_metadata": None}
    with open(os.path.join(tree_dir, METADATA_FILE), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(tree_dir, "_sharding"), "w") as f:
        json.dump(sharding, f, separators=(",", ":"))
    with open(os.path.join(tree_dir, "array_metadatas", "process_0"), "w") as f:
        json.dump({"array_metadatas": array_meta}, f)
    now = time.time_ns()
    with open(os.path.join(tree_dir, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": "orbax.checkpoint._src.handlers.pytree_checkpoint_handler."
                   "PyTreeCheckpointHandler", "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": now, "commit_timestamp_nsecs": now,
                   "custom_metadata": {}}, f)
