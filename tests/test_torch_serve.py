"""The port's serving CLI (``vit_ssl_tpu_torch.serve``) end to end on the CPU.

A DINO checkpoint is made by the JAX package: ``build_model`` on the
composed ``configs/dino.yaml`` (narrowed), its own ``dino_params_to_torch``
and ``save_torch_checkpoint`` writing the ``.pth`` that
``scripts/export_torch.py`` writes. The port serves it; its embeddings must
equal JAX ``make_feature_fn`` on the same decoded images.
"""

import io
import json
import os
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from make_synthetic_data import make
from vit_ssl_tpu.config import compose, to_container
from vit_ssl_tpu.data.transforms import Compose, Resize, ToTensor
from vit_ssl_tpu.evaluators.evaluator_utils import make_feature_fn
from vit_ssl_tpu.models.builder import build_model
from vit_ssl_tpu.utils.checkpoint import dino_params_to_torch, save_torch_checkpoint
from vit_ssl_tpu_torch import serve

REPO = Path(__file__).resolve().parent.parent
BATCH = 4
OVERRIDES = [
    "data.img_size=32", "model.embed_dim=64", "model.num_heads=2",
    "model.num_blocks=2", "model.mlp_dim=128", "model.output_dim=16",
    "model.compute_dtype=float32",
]


def _jiggle(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + 0.05 * rng.standard_normal(np.shape(p)).astype(np.float32),
        params,
    )


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_serve")
    data = make(str(root / "data"), n=6, size=40, num_classes=3)
    images = sorted(str(p) for p in Path(f"{data}/train_images").glob("*.png"))
    config = compose(REPO / "configs", "dino", overrides=OVERRIDES)
    bundle = build_model(config)
    init = bundle.init_fn(jax.random.PRNGKey(0))
    student = _jiggle(init["params"], 1)
    teacher = _jiggle(init["teacher_params"], 2)  # differs from the student
    sd = dino_params_to_torch(student, teacher, np.asarray(init["center"]))
    pth = str(root / "dino.pth")
    save_torch_checkpoint(pth, sd, {"epoch": 0, "config": to_container(config)})

    fn, params = make_feature_fn(
        bundle, SimpleNamespace(params=student, teacher_params=teacher))
    pipeline = Compose([Resize([32, 32]), ToTensor()])
    x = np.zeros((BATCH, 32, 32, 3), np.float32)
    want = {}
    for i in range(0, len(images), BATCH):
        chunk = images[i:i + BATCH]
        for j, p in enumerate(chunk):
            with Image.open(p) as img:
                x[j] = pipeline(img.convert("RGB"))
        out = np.asarray(fn(params, x), np.float32)
        want.update({p: out[j] for j, p in enumerate(chunk)})
    return SimpleNamespace(pth=pth, images=images, want=want, sd=sd,
                           config=to_container(config), root=root,
                           student=student, teacher=teacher)


@pytest.fixture(scope="module")
def server(exported):
    return serve.Server(exported.pth, batch_size=BATCH, device="cpu")


def _embeddings(records):
    return np.asarray([r["embedding"] for r in records], np.float32)


def test_infer_matches_jax_feature_fn(exported, server):
    assert server.mode == "dino" and server.model.dtype == torch.float32
    paths = exported.images[:BATCH]
    records = server.infer(paths)
    assert [r["path"] for r in records] == paths
    want = np.stack([exported.want[p] for p in paths])
    assert _embeddings(records).shape == (BATCH, 64)
    np.testing.assert_allclose(_embeddings(records), want, atol=5e-4, rtol=0)


def test_short_batch_matches_full_batch(exported, server):
    full = _embeddings(server.infer(exported.images[:BATCH]))
    short = _embeddings(server.infer(exported.images[:2]))
    np.testing.assert_allclose(short, full[:2], atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        short, np.stack([exported.want[p] for p in exported.images[:2]]),
        atol=5e-4, rtol=0)


def test_forward_batch_refuses_oversize(server):
    with pytest.raises(ValueError, match="exceed the batch size"):
        server.forward_batch(np.zeros((BATCH + 1, 32, 32, 3), np.float32))


def test_bad_path_yields_error_record(exported, server):
    good = exported.images[:2]
    records = server.infer([good[0], "/no/such/image.png", good[1]])
    assert "error" in records[1] and records[1]["path"] == "/no/such/image.png"
    np.testing.assert_allclose(_embeddings([records[0], records[2]]),
                               _embeddings(server.infer(good)), atol=1e-6, rtol=0)


def test_stdin_microbatching(exported, server):
    r, w = os.pipe()
    os.write(w, ("\n".join(exported.images[:6]) + "\n").encode())
    os.close(w)
    sink = io.StringIO()
    with os.fdopen(r) as stdin:
        serve.run_stdin_server(server, sink, max_wait_ms=50.0, stdin=stdin)
    recs = [json.loads(line) for line in sink.getvalue().splitlines()]
    # one full batch of 4, then the remaining 2 at EOF, in order
    assert [rec["path"] for rec in recs] == exported.images[:6]
    np.testing.assert_allclose(
        _embeddings(recs), np.stack([exported.want[p] for p in exported.images]),
        atol=5e-4, rtol=0)


def test_stdin_flushes_on_max_wait_with_open_writer(exported, server):
    r, w = os.pipe()
    sink = io.StringIO()
    stdin = os.fdopen(r)
    t = threading.Thread(target=serve.run_stdin_server,
                         args=(server, sink, 50.0), kwargs={"stdin": stdin},
                         daemon=True)
    t.start()
    os.write(w, ("\n".join(exported.images[:2]) + "\n").encode())
    deadline = time.time() + 20
    while time.time() < deadline and len(sink.getvalue().splitlines()) < 2:
        time.sleep(0.05)
    recs = [json.loads(line) for line in sink.getvalue().splitlines()]
    assert [rec["path"] for rec in recs] == exported.images[:2]
    os.close(w)
    t.join(timeout=20)
    assert not t.is_alive()
    stdin.close()


def test_cli_writes_json_lines(exported, tmp_path):
    out = tmp_path / "emb.jsonl"
    serve.main(["--checkpoint", exported.pth, "--device", "cpu",
                "--batch-size", str(BATCH), "--no-embedding-values",
                "--output", str(out), *exported.images[:5]])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [rec["path"] for rec in recs] == exported.images[:5]
    norms = [np.linalg.norm(exported.want[p]) for p in exported.images[:5]]
    np.testing.assert_allclose([rec["embedding_norm"] for rec in recs], norms,
                               rtol=1e-4)


def test_student_backbone_when_no_teacher(exported, tmp_path):
    student_only = {k: v for k, v in exported.sd.items()
                    if not k.startswith("teacher_")}
    pth = str(tmp_path / "student.pth")
    save_torch_checkpoint(pth, student_only, {"config": exported.config})
    s = serve.Server(pth, batch_size=2, device="cpu")
    ref = serve.Server(exported.pth, batch_size=2, device="cpu")
    w = s.model.state_dict()["encoder_blocks.0.self_attention.w_query.weight"]
    np.testing.assert_array_equal(
        w.numpy(), exported.sd["student_backbone.encoder_blocks.0.self_attention.w_query.weight"])
    x = np.random.default_rng(0).random((2, 32, 32, 3), np.float32)
    assert not np.allclose(s.forward_batch(x), ref.forward_batch(x))


def test_missing_backbone_key_raises(exported, tmp_path):
    sd = dict(exported.sd)
    del sd["teacher_backbone.encoder_blocks.1.layer_norm2.bias"]
    pth = str(tmp_path / "broken.pth")
    save_torch_checkpoint(pth, sd, {"config": exported.config})
    with pytest.raises(RuntimeError, match="layer_norm2.bias"):
        serve.Server(pth, batch_size=2, device="cpu")


def test_checkpoint_without_backbone_or_config_raises(exported, tmp_path):
    heads_only = {k: v for k, v in exported.sd.items() if "backbone" not in k}
    pth = str(tmp_path / "heads.pth")
    save_torch_checkpoint(pth, heads_only, {"config": exported.config})
    with pytest.raises(KeyError, match="teacher_backbone"):
        serve.Server(pth, batch_size=2, device="cpu")
    bare = str(tmp_path / "bare.pth")
    save_torch_checkpoint(bare, exported.sd, {})
    with pytest.raises(ValueError, match="embeds no config"):
        serve.Server(bare, batch_size=2, device="cpu")
    state_only = str(tmp_path / "state_only.pth")
    torch.save({k: torch.from_numpy(v) for k, v in exported.sd.items()}, state_only)
    with pytest.raises(ValueError, match="no model_state_dict"):
        serve.Server(state_only, batch_size=2, device="cpu")


def test_server_defaults_to_the_card(exported, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.Server(exported.pth, batch_size=2)


def test_fused_mlp_checkpoint_serves_like_jax(exported, tmp_path):
    """A ``.pth`` whose embedded config sets ``model.use_fused_mlp`` serves
    through the fused FFN (its plain versions on the CPU); the embeddings
    equal JAX's feature function built from that config, whose FFNs run the
    B4 Pallas kernel in interpret mode."""
    config = compose(REPO / "configs", "dino",
                     overrides=OVERRIDES + ["model.use_fused_mlp=true"])
    pth = str(tmp_path / "fused.pth")
    save_torch_checkpoint(pth, exported.sd, {"config": to_container(config)})
    server = serve.Server(pth, batch_size=BATCH, device="cpu")
    assert all(block.feed_forward.use_fused for block in server.model.encoder_blocks)
    paths = exported.images[:BATCH]
    got = _embeddings(server.infer(paths))

    fn, params = make_feature_fn(
        build_model(config),
        SimpleNamespace(params=exported.student, teacher_params=exported.teacher))
    pipeline = Compose([Resize([32, 32]), ToTensor()])
    x = np.zeros((BATCH, 32, 32, 3), np.float32)
    for j, p in enumerate(paths):
        with Image.open(p) as img:
            x[j] = pipeline(img.convert("RGB"))
    want = np.asarray(fn(params, x), np.float32)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)
    np.testing.assert_allclose(got, np.stack([exported.want[p] for p in paths]),
                               atol=5e-4, rtol=0)  # and the unfused JAX path


# ---------------------------------------------------------------------------
# supervised checkpoints: class predictions

SUPERVISED_OVERRIDES = [
    "data.img_size=32", "model.embed_dim=64", "model.num_heads=2",
    "model.num_blocks=2", "model.mlp_dim=128", "model.num_classes=5",
    "model.patch_size=8", "model.compute_dtype=float32",
]


@pytest.fixture(scope="module")
def supervised_exported(tmp_path_factory, exported):
    """A JAX supervised checkpoint (``build_model`` on the composed
    ``configs/supervised.yaml``, narrowed; jiggled weights) and the ``.pth``
    that ``scripts/export_torch.py`` makes of it."""
    import importlib.util

    from vit_ssl_tpu.utils.checkpoint import save_checkpoint

    root = tmp_path_factory.mktemp("torch_serve_supervised")
    config = compose(REPO / "configs", "supervised", overrides=SUPERVISED_OVERRIDES)
    bundle = build_model(config)
    params = _jiggle(bundle.init_fn(jax.random.PRNGKey(3))["params"], 4)
    ckpt = str(root / "best_model")
    save_checkpoint(ckpt, {"params": params},
                    {"mode": "supervised", "epoch": 0, "config": to_container(config)})
    spec = importlib.util.spec_from_file_location(
        "export_torch", REPO / "scripts" / "export_torch.py")
    export = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export)
    pth = str(root / "vit.pth")
    export.main([ckpt, pth])
    spec = importlib.util.spec_from_file_location("jax_serve", REPO / "scripts" / "serve.py")
    jax_serve = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_serve)
    jax_server = jax_serve.Server(ckpt, batch_size=BATCH)
    want = [rec for i in range(0, 6, BATCH)
            for rec in jax_server.infer(exported.images[i:i + BATCH])]
    return SimpleNamespace(pth=pth, want=want, images=exported.images[:6])


def test_supervised_checkpoint_serves_like_jax(supervised_exported):
    """The port's server on the exported ``.pth`` answers what
    ``scripts/serve.py`` answers on the JAX checkpoint: the same pred for
    every image and the prob within 1e-5 (both round to 6 digits), over a
    full batch and a zero-padded short one."""
    server = serve.Server(supervised_exported.pth, batch_size=BATCH, device="cpu")
    assert server.classifier and server.mode == "supervised"
    got = server.infer(supervised_exported.images[:BATCH])
    got += server.infer(supervised_exported.images[BATCH:])
    assert [r["path"] for r in got] == [r["path"] for r in supervised_exported.want]
    assert [r["pred"] for r in got] == [r["pred"] for r in supervised_exported.want]
    np.testing.assert_allclose([r["prob"] for r in got],
                               [r["prob"] for r in supervised_exported.want],
                               atol=1e-5, rtol=0)
    assert all(set(r) == {"path", "pred", "prob"} for r in got)


def test_supervised_cli_and_stdin_share_the_pipeline(supervised_exported, tmp_path):
    """The CLI writes {path, pred, prob} lines; the stdin server answers
    the same records."""
    out = tmp_path / "preds.jsonl"
    serve.main(["--checkpoint", supervised_exported.pth, "--device", "cpu",
                "--batch-size", str(BATCH), "--output", str(out),
                *supervised_exported.images])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    server = serve.Server(supervised_exported.pth, batch_size=BATCH, device="cpu")
    r, w = os.pipe()
    os.write(w, ("\n".join(supervised_exported.images) + "\n").encode())
    os.close(w)
    sink = io.StringIO()
    with os.fdopen(r) as stdin:
        serve.run_stdin_server(server, sink, max_wait_ms=50.0, stdin=stdin)
    assert [json.loads(line) for line in sink.getvalue().splitlines()] == recs
    assert [rec["pred"] for rec in recs] == [r["pred"] for r in supervised_exported.want]


def test_supervised_checkpoint_missing_key_raises(supervised_exported, tmp_path):
    state = torch.load(supervised_exported.pth, weights_only=True)
    del state["model_state_dict"]["classification_head.linear.bias"]
    pth = str(tmp_path / "broken.pth")
    torch.save(state, pth)
    with pytest.raises(RuntimeError, match="classification_head.linear.bias"):
        serve.Server(pth, batch_size=2, device="cpu")
