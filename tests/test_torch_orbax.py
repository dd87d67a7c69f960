"""The port's orbax reader and writer (``utils/orbax_tree.py``, over
``utils/ocdbt.py`` and ``utils/zstd.py``) against orbax and tensorstore.

- ``read_tree`` equals ``PyTreeCheckpointer().restore`` bit for bit, leaf by
  leaf (dtype, shape, bytes; ``None``, empty containers and Python numbers
  as orbax gives them), on trees written here by the JAX package's
  ``save_checkpoint``: a 0-d int32, bfloat16, an array sharded over the
  8 CPU devices (orbax splits it into one chunk a shard), optax's empty
  states and ``multi_transform``'s MaskedNode, scalars, empty containers.
- The committed fixtures (``tests/torch_orbax_fixtures``, written by the JAX
  trainers) equal their ``digests.json`` and a fresh orbax restore.
- ``write_tree``'s output is restored by orbax bit for bit.
- The OCDBT reader lists and reads what tensorstore does, on stores that pin
  each part of the format: interior B-tree nodes, many versions, values out
  of line, no compression; zarr edge chunks and absent chunks.
- Refusals name what they refuse: a damaged CRC-32C, a numbered manifest, a
  zarr field or value type the reader does not take, a tree written with
  ``use_ocdbt`` false (the JAX package writes OCDBT trees only).
"""

import ast
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from vit_ssl_tpu.utils.checkpoint import save_checkpoint
from vit_ssl_tpu_torch.utils import ocdbt, orbax_tree

ocp = pytest.importorskip("orbax.checkpoint")
REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "torch_orbax_fixtures"
NAMES = ["dino_step0", "dino_step1", "finetune_frozen", "finetune_unfrozen", "simmim",
         "supervised_scan_sgd_preempt"]


def _fixture_module():
    spec = importlib.util.spec_from_file_location(
        "torch_orbax_fixture_spec", FIXTURES / "fixture_spec.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def assert_same_tree(got, want, where="tree"):
    """Bit-equal: the same structure, each array of the same dtype, shape and
    bytes (a bfloat16 leaf is a torch tensor on the port's side)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            assert_same_tree(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same_tree(a, b, f"{where}[{i}]")
    elif want is None or isinstance(want, (int, float)):
        assert type(got) is type(want) and got == want, where
    else:
        want = np.asarray(want)
        if isinstance(got, torch.Tensor):
            assert str(want.dtype) == "bfloat16" and got.dtype == torch.bfloat16, where
            got, want = got.view(torch.int16).numpy(), want.view(np.int16)
        assert got.dtype == want.dtype and got.shape == want.shape, (where, got.dtype,
                                                                     want.dtype)
        assert got.tobytes() == want.tobytes(), where


def _restore(tree_dir):
    return ocp.PyTreeCheckpointer().restore(os.path.abspath(tree_dir))


def _jax_tree():
    mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("a", "b"))
    sharded = jax.device_put(jnp.arange(36 * 10, dtype=jnp.float32).reshape(36, 10),
                             NamedSharding(mesh, PartitionSpec("a", "b")))
    params = {"dense": {"kernel": jnp.ones((3, 4)), "bias": jnp.zeros(4)},
              "frozen": {"kernel": jnp.full((2, 2), 0.5)}}
    mask = {"dense": {"kernel": "train", "bias": "train"}, "frozen": {"kernel": "freeze"}}
    schedule = optax.linear_schedule(0.0, 1e-3, 10)
    masked = optax.multi_transform({"train": optax.adamw(schedule),
                                    "freeze": optax.set_to_zero()}, mask)
    return {"step": jnp.asarray(7, jnp.int32),
            "params": params,
            "half": jnp.asarray(np.linspace(-3, 3, 11), jnp.bfloat16),
            "sharded": sharded,
            "flag": jnp.asarray(True),
            "bytes": np.arange(5, dtype=np.uint8),
            "adamw": optax.adamw(schedule).init(params),
            "masked": masked.init(params),
            "sgd": optax.sgd(schedule).init(params),
            "number": 3, "real": 2.5, "nothing": None, "empty": {}, "none": []}


def test_read_tree_matches_orbax_restore(tmp_path):
    save_checkpoint(str(tmp_path / "ckpt"), _jax_tree(), {"epoch": 1})
    tree_dir = tmp_path / "ckpt" / "tree"
    store = ocdbt.open_store(str(tree_dir))
    assert [k for k in store.list() if k.startswith("sharded/")] == [
        "sharded/.zarray"] + [f"sharded/{i}.{j}" for i in range(4) for j in range(2)]
    assert_same_tree(orbax_tree.read_tree(str(tree_dir)), _restore(tree_dir))


def test_tree_without_ocdbt_is_refused(tmp_path):
    """``use_ocdbt`` false (each array's keys files under the tree, a layout
    the JAX package's ``save_checkpoint`` never writes) is refused by name."""
    tree = {"a": jnp.arange(6.0).reshape(2, 3), "b": {"c": jnp.int32(3)}}
    handler = ocp.PyTreeCheckpointHandler(use_ocdbt=False)
    ocp.Checkpointer(handler).save(str(tmp_path / "tree"), tree)
    assert (tmp_path / "tree" / "a" / ".zarray").exists()
    with pytest.raises(orbax_tree.OrbaxTreeError, match="use_ocdbt is false"):
        orbax_tree.read_tree(str(tmp_path / "tree"))


@pytest.mark.parametrize("name", NAMES)
def test_fixtures_match_digests_and_orbax(name):
    """The JAX trainers' checkpoints: every leaf's dtype, shape and sha256
    as ``digests.json`` records them, and bit-equal to orbax's restore."""
    digests = json.loads((FIXTURES / "digests.json").read_text())[name]
    tree = orbax_tree.read_tree(str(FIXTURES / name / "tree"))
    leaves = _fixture_module().leaf_digests(tree)
    assert leaves == digests
    assert_same_tree(tree, _restore(FIXTURES / name / "tree"))
    entropy_coded = [k for k in ocdbt.open_store(str(FIXTURES / name / "tree")).list()
                     if not k.endswith(".zarray")]
    assert entropy_coded


def test_write_tree_is_restored_by_orbax(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"step": np.asarray(5, np.int32),
            "params": {"w": rng.standard_normal((300, 700)).astype(np.float32),  # out of line
                       "b": torch.randn(7, generator=torch.Generator().manual_seed(0)
                                        ).bfloat16(),
                       "h": np.float16([1.5, -2.0]), "flag": np.asarray([True, False])},
            "opt_state": [{"count": np.asarray(3, np.int32),
                           "mu": {"w": np.zeros((2, 2), np.float32), "frozen": None}},
                          None, {"count": np.asarray(3, np.int32)}],
            "bytes": np.arange(4, dtype=np.uint8), "number": 4, "real": 0.25, "empty": {}}
    orbax_tree.write_tree(str(tmp_path / "tree"), tree)
    restored = _restore(tmp_path / "tree")
    want = dict(tree, params=dict(tree["params"], b=np.asarray(
        tree["params"]["b"].float().numpy(), jnp.bfloat16)))
    assert_same_tree(orbax_tree.read_tree(str(tmp_path / "tree")), restored)
    arrays = jax.tree_util.tree_map(lambda x: np.asarray(x) if hasattr(x, "dtype") else x,
                                    restored)
    assert_same_tree(arrays, want)
    # the writer replaces what was there
    orbax_tree.write_tree(str(tmp_path / "tree"), {"only": np.ones(2, np.float32)})
    assert set(_restore(tmp_path / "tree")) == {"only"}


def _tensorstore():
    return pytest.importorskip("tensorstore")


def _ts_store(path, **config):
    ts = _tensorstore()
    spec = {"driver": "ocdbt", "base": f"file://{os.path.abspath(path)}/"}
    if config:
        spec["config"] = config
    return ts.KvStore.open(spec).result()


def _assert_store_matches(kv, path):
    keys = [k.decode() for k in kv.list().result()]
    store = ocdbt.open_store(str(path))
    assert store.list() == sorted(keys)
    for k in keys:
        assert store.read(k) == kv.read(k).result().value, k
    return store


@pytest.mark.parametrize("config", [
    {},
    {"max_decoded_node_bytes": 200, "max_inline_value_bytes": 16},  # interior nodes
    {"compression": None},
    {"compression": {"id": "zstd", "level": 7}, "version_tree_arity_log2": 3},
], ids=["default", "interior_nodes", "uncompressed", "zstd_level7"])
def test_ocdbt_reader_matches_tensorstore(tmp_path, config):
    ts = _tensorstore()
    kv = _ts_store(tmp_path, **config)
    with ts.Transaction() as txn:
        for i in range(60):
            kv.with_transaction(txn).write(f"key/{i:03d}/x", bytes([i]) * (i * 3)).result()
    for i in range(20):  # one version each
        kv.write(f"late/{i}", b"v" * (i * 70)).result()
    store = _assert_store_matches(kv, tmp_path)
    assert store.version.generation >= 21
    if "max_decoded_node_bytes" in config:
        assert store.version.root_height > 0
        assert store.ref("key/059/x") is not None  # out of line


def test_zarr_edge_and_absent_chunks(tmp_path):
    """Chunks that do not divide the shape (stored whole, cut on reading),
    chunks the store does not hold (``fill_value``)."""
    ts = _tensorstore()
    spec = {"driver": "zarr", "path": "x",
            "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}/"},
            "metadata": {"shape": [7, 5], "chunks": [3, 2], "dtype": "<f4",
                         "fill_value": 1.5, "compressor": {"id": "zstd", "level": 3}}}
    array = ts.open(spec, create=True).result()
    array[0:3, 0:2] = np.arange(6, dtype=np.float32).reshape(3, 2)
    array[6:7, 4:5] = np.float32([[9]])
    store = ocdbt.open_store(str(tmp_path))
    assert store.list() == ["x/.zarray", "x/0.0", "x/2.2"]
    got = orbax_tree._read_array(store, "x")
    np.testing.assert_array_equal(got, array.read().result())


def test_damaged_and_unknown_stores_are_refused(tmp_path):
    save_checkpoint(str(tmp_path / "ckpt"), {"a": jnp.ones(3)}, {})
    tree_dir = tmp_path / "ckpt" / "tree"
    node = next((tree_dir / "d").iterdir())
    data = bytearray(node.read_bytes())
    data[20] ^= 1
    node.write_bytes(bytes(data))
    with pytest.raises(ocdbt.OcdbtError, match="CRC-32C mismatch"):
        orbax_tree.read_tree(str(tree_dir))
    manifest = tree_dir / "manifest.ocdbt"
    manifest.write_bytes(b"\x0c\xdb\x20\xde" + manifest.read_bytes()[4:])
    with pytest.raises(ocdbt.OcdbtError, match="magic 0x0cdb20de, expected 0x0cdb3a2a"):
        ocdbt.open_store(str(tree_dir))
    kv = _ts_store(tmp_path / "numbered", manifest_kind="numbered")
    kv.write("a", b"x").result()
    with pytest.raises(ocdbt.OcdbtError, match="manifest kind 1"):
        ocdbt.open_store(str(tmp_path / "numbered"))
    with pytest.raises(ocdbt.OcdbtError, match="holds no manifest.ocdbt"):
        ocdbt.open_store(str(tmp_path))


class _Store(dict):
    def read(self, key):
        return self[key]


@pytest.mark.parametrize("field,value,match", [
    ("compressor", {"id": "blosc"}, "compressor: 'blosc'"),
    ("order", "F", "order: 'F'"),
    ("dtype", "<c8", "dtype: '<c8'"),
    ("zarr_format", 3, "zarr_format: 3"),
    ("filters", [{"id": "delta"}], "filters"),
    ("dimension_separator", "/", "dimension_separator: '/'"),
])
def test_zarr_fields_are_refused_by_name(field, value, match):
    zarray = {"chunks": [2], "compressor": None, "dimension_separator": ".",
              "dtype": "<f4", "fill_value": None, "filters": None, "order": "C",
              "shape": [2], "zarr_format": 2, field: value}
    store = _Store({"p.w/.zarray": json.dumps(zarray).encode(), "p.w/0": bytes(8)})
    with pytest.raises(orbax_tree.OrbaxTreeError, match=f"leaf 'p.w', {match}"):
        orbax_tree._read_array(store, "p.w")


def test_absent_chunk_without_fill_value_and_unknown_types_are_refused(tmp_path):
    zarray = {"chunks": [2], "compressor": None, "dtype": "<f4", "fill_value": None,
              "filters": None, "order": "C", "shape": [4], "zarr_format": 2}
    store = _Store({"w/.zarray": json.dumps(zarray).encode(), "w/0": bytes(8)})
    with pytest.raises(orbax_tree.OrbaxTreeError, match="leaf 'w', fill_value: chunk 'w/1'"):
        orbax_tree._read_array(store, "w")
    orbax_tree.write_tree(str(tmp_path / "tree"), {"w": np.ones(2, np.float32)})
    meta_file = tmp_path / "tree" / "_METADATA"
    meta = json.loads(meta_file.read_text())
    meta["tree_metadata"]["('w',)"]["value_metadata"]["value_type"] = "PyTreeNode"
    meta_file.write_text(json.dumps(meta))
    with pytest.raises(orbax_tree.OrbaxTreeError, match="leaf 'w', value_type: 'PyTreeNode'"):
        orbax_tree.read_tree(str(tmp_path / "tree"))
    meta["use_zarr3"] = True
    meta_file.write_text(json.dumps(meta))
    with pytest.raises(orbax_tree.OrbaxTreeError, match="use_zarr3"):
        orbax_tree.read_tree(str(tmp_path / "tree"))


def test_fixtures_are_small_and_hashes_are_of_the_bytes():
    total = sum(f.stat().st_size for f in FIXTURES.rglob("*")
                if f.is_file() and "__pycache__" not in f.parts)
    assert total < 2_000_000, total
    digests = json.loads((FIXTURES / "digests.json").read_text())
    assert sorted(digests) == NAMES
    step = digests["dino_step1"]["step"]
    assert step["shape"] == [] and step["dtype"] == "int32"
    assert step["sha256"] == hashlib.sha256(np.int32(1).tobytes()).hexdigest()


BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore", "zstandard",
           "ml_dtypes", "vit_ssl_tpu")


def test_reader_runs_without_orbax_tensorstore_zstandard_or_jax(tmp_path):
    """In a fresh interpreter where those packages cannot be imported (the
    card's machine has none of them), every fixture is read, its digests
    hold, and ``load_checkpoint`` maps a JAX DINO checkpoint into the port's
    layout."""
    code = (
        "import importlib.abc, json, sys\n"
        f"BLOCKED = {BLOCKED!r}\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import importlib.util\n"
        "from vit_ssl_tpu_torch.utils import orbax_tree\n"
        "from vit_ssl_tpu_torch.utils.checkpoint import load_checkpoint\n"
        "spec = importlib.util.spec_from_file_location(\n"
        f"    'mf', {str(FIXTURES / 'fixture_spec.py')!r})\n"
        "mf = importlib.util.module_from_spec(spec); spec.loader.exec_module(mf)\n"
        f"digests = json.load(open({str(FIXTURES / 'digests.json')!r}))\n"
        "for name, want in digests.items():\n"
        f"    tree = orbax_tree.read_tree({str(FIXTURES)!r} + '/' + name + '/tree')\n"
        "    assert mf.leaf_digests(tree) == want, name\n"
        f"state, meta = load_checkpoint({str(FIXTURES / 'dino_step1')!r})\n"
        "assert state['step'] == 1 and meta['epoch'] == 1\n"
        "assert sorted(state) == ['center', 'opt_state', 'step', 'student', 'teacher']\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"


def test_reader_modules_import_no_reference_packages():
    for module in ("zstd", "ocdbt", "orbax_tree", "checkpoint"):
        source = (REPO / "vit_ssl_tpu_torch" / "utils" / f"{module}.py").read_text()
        roots = set()
        for node in ast.walk(ast.parse(source)):
            if isinstance(node, ast.Import):
                roots |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                roots.add(node.module.split(".")[0])
        assert not roots & set(BLOCKED), (module, roots & set(BLOCKED))


_TWO_PROCESS_WRITER = """
import os, sys
pid, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(f"localhost:{port}", num_processes=2, process_id=pid)
import numpy as np
import orbax.checkpoint as ocp
from jax.sharding import Mesh, NamedSharding, PartitionSpec
mesh = Mesh(np.array(jax.devices()), ("d",))
whole = np.arange(64 * 600, dtype=np.float32).reshape(64, 600)
x = jax.make_array_from_callback(whole.shape, NamedSharding(mesh, PartitionSpec("d")),
                                 lambda index: whole[index])
ocp.PyTreeCheckpointer().save(out, {"x": x, "step": 3})
"""


def test_two_process_checkpoint(tmp_path):
    """A tree two JAX processes wrote (each its own shards, under
    ``ocdbt.process_0`` and ``ocdbt.process_1``, joined by the root
    manifest): the chunks out of line in both processes' data files, the
    array whole."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    out = str(tmp_path / "tree")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-c", _TWO_PROCESS_WRITER, str(pid), port, out],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for pid in (0, 1)]
    logs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)[-3000:]
    store = ocdbt.open_store(out)
    places = {store.ref(f"x/{i}.0").path.split("/")[0] for i in range(8)}
    assert places == {"ocdbt.process_0", "ocdbt.process_1"}
    tree = orbax_tree.read_tree(out)
    whole = np.arange(64 * 600, dtype=np.float32).reshape(64, 600)
    np.testing.assert_array_equal(tree["x"], whole)
    assert tree["step"] == 3
