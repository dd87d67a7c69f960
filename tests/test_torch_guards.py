"""Guards on the PyTorch port as a whole.

- the port (``vit_ssl_tpu_torch``) and ``chip_smoke.py`` import neither JAX
  nor the JAX package, checked in a fresh interpreter and by an AST scan;
- the evaluators import sklearn, pandas, matplotlib, seaborn and PIL at no
  module level: with all five blocked they import and run KNN, the linear
  probe and UMAP, write every CSV and TXT and name each skipped figure;
- the port's image decoders (``data/png.py``, ``data/jpeg.py``,
  ``data/bmp.py``) import neither cv2 nor PIL anywhere;
- its entry points take the card unless the caller asks for the CPU;
- ``chip_smoke.py``'s DINO ViT-S/8 config is the composed ``configs/dino.yaml``,
  its supervised ViT-B/16 the composed ``configs/vit_b_imagenet.yaml`` at
  384 px (with and without ``model.use_fused_mlp=true``) and at 512 px, its
  ViT-B/16 trainer's config the port's composition of
  ``configs/vit_b_imagenet.yaml`` as written and its finetune config the
  port's composition of ``configs/finetune.yaml`` with the script's
  overrides, its SimMIM config the port's composition of
  ``configs/simmim.yaml`` as written, its preempt phase's fault lands
  mid-epoch 2, its V-MoE phase is V-MoE-B/16 "every-2" and its
  patch-dropout phase's B1 case is (1024, 99), its data-parallel phase's
  config the port's composition of ``configs/dino.yaml`` with
  ``parallel.fsdp=true``, its ring phase's shape ViT-B/16's 512-px one,
  divisible by its sp, its JPEG-folder phase's config the port's
  composition of ``configs/vit_b_imagenet.yaml`` with the folder and its
  overrides (2 train and 1 val steps over its files), its orbax phase's
  B1 shapes are the fixture's and cases the kernels phase checks, what it
  loads of the orbax fixtures imports no JAX, its bounds are the stated
  arithmetic, and the script refuses to run without a card;
- a self-attention longer than kernel B3 takes (N > 1024) runs kernel B2.
"""

import ast
import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vit_ssl_tpu.config import compose, to_container
from vit_ssl_tpu_torch import resolve_device

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "vit_ssl_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "vit_ssl_tpu")
# packages the card machine lacks: never imported by the port at module level
HOST_ONLY = ("yaml", "orbax", "rich", "pandas", "cv2", "PIL", "matplotlib", "sklearn",
             "seaborn")
# never imported by the port at all
NOWHERE = ("yaml", "orbax", "pandas", "sklearn")


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


EVALUATOR_MODULES = tuple(
    f"vit_ssl_tpu_torch.evaluators.{name}" for name in (
        "evaluator_utils", "knn", "linear_probe", "umap_native", "embedding_analysis",
        "unsupervised_evaluator", "supervised_evaluator")) + (
    "vit_ssl_tpu_torch.evaluators", "vit_ssl_tpu_torch.evaluate",
    "vit_ssl_tpu_torch.scripts.knn_classification",
    "vit_ssl_tpu_torch.scripts.linear_probing")


def test_port_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import vit_ssl_tpu_torch, vit_ssl_tpu_torch.serve, vit_ssl_tpu_torch.kernels\n"
        "import vit_ssl_tpu_torch.models, vit_ssl_tpu_torch.ops\n"
        "import vit_ssl_tpu_torch.utils.checkpoint, vit_ssl_tpu_torch.data.transforms\n"
        "import vit_ssl_tpu_torch.train, vit_ssl_tpu_torch.utils.metrics\n"
        "import vit_ssl_tpu_torch.data.device_augment, vit_ssl_tpu_torch.models.vit\n"
        "import vit_ssl_tpu_torch.ops.masked_matmul, vit_ssl_tpu_torch.ops.precision\n"
        "import vit_ssl_tpu_torch.scripts.dropout_epilogue_probe\n"
        "import vit_ssl_tpu_torch.config, vit_ssl_tpu_torch.config.yaml_io\n"
        "import vit_ssl_tpu_torch.data.datasets, vit_ssl_tpu_torch.data.loader\n"
        "import vit_ssl_tpu_torch.data.builder, vit_ssl_tpu_torch.utils.logger\n"
        "import vit_ssl_tpu_torch.utils.history, vit_ssl_tpu_torch.train.trainers\n"
        "import vit_ssl_tpu_torch.train.__main__, vit_ssl_tpu_torch.train.trainers.supervised\n"
        "import vit_ssl_tpu_torch.models.builder, vit_ssl_tpu_torch.ops.encoder_block\n"
        "import vit_ssl_tpu_torch.models.simmim, vit_ssl_tpu_torch.train.trainers.simmim\n"
        "import vit_ssl_tpu_torch.ops.patch_embedding, vit_ssl_tpu_torch.ops.dropout\n"
        "import vit_ssl_tpu_torch.data.jpeg, vit_ssl_tpu_torch.data.bmp\n"
        f"import {', '.join(EVALUATOR_MODULES)}\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r} + {HOST_ONLY!r} + ('triton',))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]"


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_jax_import_anywhere_in_the_port():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    offenders = {str(f.relative_to(REPO)): root for f in files
                 for root in _imported_roots(f) if root in FORBIDDEN}
    assert offenders == {}


def test_host_packages_only_inside_functions():
    """yaml, orbax, pandas and sklearn appear nowhere in the port; cv2,
    PIL, matplotlib, seaborn and rich only inside the functions that decode,
    resize, plot or start the live training view."""
    offenders = {}
    for f in sorted(PORT.rglob("*.py")):
        tree = ast.parse(f.read_text(), filename=str(f))
        inside = {id(n) for fn in ast.walk(tree)
                  if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                  for n in ast.walk(fn)}
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module.split(".")[0]]
            for name in names:
                if name in NOWHERE or (
                        name in HOST_ONLY and id(node) not in inside):
                    offenders[f"{f.relative_to(REPO)}:{node.lineno}"] = name
    assert offenders == {}


def test_image_decoders_import_no_cv2_or_pil():
    """The decoders take their place where OpenCV and PIL are missing: they
    import neither, at module level or inside a function."""
    for name in ("png", "jpeg", "bmp"):
        roots = set(_imported_roots(PORT / "data" / f"{name}.py"))
        assert not roots & {"cv2", "PIL"}, name
    code = ("import sys\nsys.modules['cv2'] = sys.modules['PIL'] = None\n"
            "from vit_ssl_tpu_torch.data import bmp, jpeg, png\nprint('OK')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "OK"


EVAL_BLOCKED_RUN = """
import logging, sys
for name in ("sklearn", "pandas", "matplotlib", "seaborn", "PIL"):
    sys.modules[name] = None
import numpy as np
for module in MODULES:
    __import__(module)
from vit_ssl_tpu_torch.evaluators import supervised_evaluator as sup
from vit_ssl_tpu_torch.evaluators import unsupervised_evaluator as unsup
logging.basicConfig(level=logging.WARNING, format="%(levelname)s %(message)s")
out = sys.argv[1]
rng = np.random.default_rng(0)
labels = np.arange(60) % 3
feats = (rng.normal(size=(60, 8)) + 4 * labels[:, None]).astype(np.float32)
bank = unsup.FeatureBank(feats[:45], labels[:45], feats[45:], labels[45:])
config = {"eval": {"mode": ["eval_knn", "eval_linear", "eval_umap"], "num_classes": 3}}
outcomes = unsup.run_modes(config, bank, out, "cpu")
unsup.render_summary(outcomes, out)
sup.save_results(True, 1.0, labels[45:], labels[45:], out)
print(sorted(o.mode for o in outcomes))
"""


def test_evaluators_run_without_host_plotting_and_sklearn(tmp_path):
    """With sklearn, pandas, matplotlib, seaborn and PIL blocked: every
    evaluator module and the entry points import, a tiny ``run_modes``
    runs all three modes, every CSV and TXT is written, and the log names
    each skipped figure."""
    code = f"MODULES = {EVALUATOR_MODULES!r}\n" + EVAL_BLOCKED_RUN
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "['eval_knn', 'eval_linear', 'eval_umap']"
    assert {p.name for p in tmp_path.iterdir()} == {
        "evaluation_summary.csv", "evaluation_summary.txt", "predictions.csv",
        "umap_feature_quality_results.csv", "umap_feature_quality_report.txt"}
    for figure in ("umap_visualization.png", "comprehensive_umap_analysis.png",
                   "confusion_matrix.png"):
        assert figure in out.stderr, figure


def test_resolve_device(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")
    assert resolve_device("cuda:1") == torch.device("cuda:1")


def _assert_within(smoke, composed, path):
    """Every value in ``smoke`` equals the composed config's at its path."""
    if isinstance(smoke, dict):
        for key, value in smoke.items():
            assert key in composed, f"{path}.{key}"
            _assert_within(value, composed[key], f"{path}.{key}")
    elif isinstance(smoke, list):
        assert len(smoke) == len(composed), path
        for i, (a, b) in enumerate(zip(smoke, composed)):
            _assert_within(a, b, f"{path}[{i}]")
    else:
        assert smoke == composed, (path, smoke, composed)


def test_chip_smoke_config_is_composed_dino_yaml():
    """Model, data, the training step's values (views, temperatures and
    their schedule, center momentum, dropout, teacher dropout, packing, the
    optimizer and lr) and both crop pipelines."""
    composed = to_container(compose(REPO / "configs", "dino"))
    smoke = _load_chip_smoke().DINO_VIT_S8
    assert smoke["training"]["type"] == "dino"
    assert smoke["data"]["img_size"] == 96 and smoke["data"]["local_img_size"] == 48
    assert smoke["model"]["dino_pack_locals"] and smoke["training"]["teacher_dropout"]
    assert set(smoke) == {"training", "model", "data", "transforms"}
    _assert_within(smoke, composed, "config")


def test_chip_smoke_supervised_config_is_composed_vit_b_yaml():
    """configs/vit_b_imagenet.yaml with data.img_size=384
    parallel.remat=false training.batch_size=64: model, data, the
    optimizer and its schedule, and the train transforms."""
    composed = to_container(compose(REPO / "configs", "vit_b_imagenet", overrides=[
        "data.img_size=384", "parallel.remat=false", "training.batch_size=64"]))
    smoke = _load_chip_smoke().VIT_B16_384
    assert smoke["training"]["type"] == "supervised"
    assert set(smoke) == {"training", "model", "data", "parallel", "transforms"}
    assert smoke["transforms"]["train"][0]["params"]["size"] == 384
    _assert_within(smoke, composed, "config")


def test_chip_smoke_vit_b_224_config_is_the_ports_composition():
    """The ViT-B/16 trainer phase's config: the port's composition of
    configs/vit_b_imagenet.yaml as written (remat on, batch 1024, 224 px,
    its supervised evaluation every epoch): the script overrides nothing."""
    from vit_ssl_tpu_torch.config import compose as port_compose
    from vit_ssl_tpu_torch.config import to_container as port_to_container

    smoke = _load_chip_smoke()
    composed = port_to_container(port_compose(REPO / "configs", "vit_b_imagenet"))
    cfg = smoke.VIT_B16_224
    assert cfg["parallel"]["remat"] is True and cfg["training"]["batch_size"] == 1024
    assert cfg["data"]["img_size"] == 224 and cfg["model"]["num_classes"] == 1000
    assert cfg["transforms"]["train"][0]["params"]["size"] == 224
    _assert_within(cfg, composed, "config")
    assert smoke.VIT_B16_384["parallel"]["remat"] is False  # the copy left it alone
    overridden = port_to_container(port_compose(REPO / "configs", "vit_b_imagenet",
                                                smoke.VIT_B16_224_OVERRIDES))
    assert overridden == composed and composed["eval"]["interval"] == 1
    # 2600 images at val_split 0.04: 3 train steps and 1 val step of 1024
    val = int(smoke.VIT_B16_224_IMAGES * cfg["data"]["val_split"])
    assert -(-(smoke.VIT_B16_224_IMAGES - val) // 1024) == 3 and 0 < val <= 1024


def test_chip_smoke_finetune_config_is_the_ports_composition():
    smoke = _load_chip_smoke()
    from vit_ssl_tpu_torch.config import compose as port_compose
    from vit_ssl_tpu_torch.config import to_container as port_to_container

    composed = port_to_container(port_compose(REPO / "configs", "finetune",
                                              smoke.FINETUNE_OVERRIDES))
    cfg = smoke.FINETUNE_S8
    assert cfg["training"]["type"] == "finetune" and cfg["freeze_backbone_epochs"] == 2
    assert cfg["training"]["extended_transfer"] and cfg["training"]["freeze_backbone"]
    _assert_within(cfg, composed, "config")
    # the DINO checkpoint's backbone is the finetune ViT's
    for key in ("embed_dim", "num_blocks", "num_heads", "mlp_dim", "patch_size"):
        assert cfg["model"][key] == smoke.DINO_VIT_S8["model"][key], key
    assert cfg["data"]["img_size"] == smoke.DINO_VIT_S8["data"]["img_size"]


def test_chip_smoke_simmim_config_is_the_ports_composition():
    """The SimMIM trainer phase's config: the port's composition of
    configs/simmim.yaml as written (ViT-S/16 at 192 px, N = 144, mask ratio
    0.5, L1, PSNR and SSIM, its evaluation every epoch in the three modes):
    the script overrides nothing; its images make 3 train steps and 1 val
    step an epoch."""
    from vit_ssl_tpu_torch.config import compose as port_compose
    from vit_ssl_tpu_torch.config import to_container as port_to_container

    smoke = _load_chip_smoke()
    composed = port_to_container(port_compose(REPO / "configs", "simmim"))
    cfg = smoke.SIMMIM_VIT_S16
    assert cfg["training"]["type"] == "simmim" and cfg["model"]["mask_ratio"] == 0.5
    assert (cfg["data"]["img_size"] // cfg["model"]["patch_size"]) ** 2 == 144
    assert smoke.SIMMIM_B1_CASE[:4] == (cfg["training"]["batch_size"], 144,
                                        cfg["model"]["num_heads"],
                                        cfg["model"]["embed_dim"] // cfg["model"]["num_heads"])
    _assert_within(cfg, composed, "config")
    overridden = port_to_container(port_compose(REPO / "configs", "simmim",
                                                smoke.SIMMIM_OVERRIDES))
    assert overridden == composed and composed["eval"]["interval"] == 1
    assert composed["eval"]["mode"] == ["eval_knn", "eval_linear", "eval_umap"]
    val = int(smoke.SIMMIM_IMAGES * cfg["data"]["val_split"])
    assert -(-(smoke.SIMMIM_IMAGES - val) // 128) == 3 and 0 < val <= 128


def test_chip_smoke_supervised_fused_config_is_composed_vit_b_yaml():
    """The fused ViT-B/16 legs' config: the 384-px composition with
    model.use_fused_mlp=true (kernel B4 at d_model 768, d_ff 3072)."""
    composed = to_container(compose(REPO / "configs", "vit_b_imagenet", overrides=[
        "data.img_size=384", "parallel.remat=false", "training.batch_size=64",
        "model.use_fused_mlp=true"]))
    smoke = _load_chip_smoke()
    fused = smoke.VIT_B16_384_FUSED
    assert fused["model"]["use_fused_mlp"] is True
    assert smoke.VIT_B16_384["model"]["use_fused_mlp"] is False
    assert (fused["model"]["embed_dim"], fused["model"]["mlp_dim"]) == smoke.VIT_B_MLP
    _assert_within(fused, composed, "config")


def test_chip_smoke_supervised_512_config_is_composed_vit_b_yaml():
    """configs/vit_b_imagenet.yaml with data.img_size=512
    parallel.remat=false training.batch_size=64 (N = 1025, kernel B2's
    route): model, data, the optimizer and its schedule, and the train
    transforms, whose crop is 512 px."""
    composed = to_container(compose(REPO / "configs", "vit_b_imagenet", overrides=[
        "data.img_size=512", "parallel.remat=false", "training.batch_size=64"]))
    smoke = _load_chip_smoke().VIT_B16_512
    assert smoke["data"]["img_size"] == 512
    assert smoke["transforms"]["train"][0]["params"]["size"] == 512
    assert set(smoke) == {"training", "model", "data", "parallel", "transforms"}
    assert (smoke["data"]["img_size"] // smoke["model"]["patch_size"]) ** 2 + 1 == 1025
    _assert_within(smoke, composed, "config")
    assert _load_chip_smoke().VIT_B16_384["data"]["img_size"] == 384


def test_chip_smoke_preempt_phase_lands_mid_epoch_2():
    """The preempt phase's overrides on configs/dino.yaml: 1040 train images
    of the DINO trainer's 1300 make 9 steps of 128, so the fault after
    PREEMPT_STEP lands at epoch 2, batch 4, and the rerun trains 5."""
    from vit_ssl_tpu_torch.config import compose as port_compose
    from vit_ssl_tpu_torch.config import to_container as port_to_container

    smoke = _load_chip_smoke()
    cfg = port_to_container(port_compose(REPO / "configs", "dino", smoke.PREEMPT_OVERRIDES))
    training = cfg["training"]
    assert training["auto_resume"] is True and training["num_epochs"] == 2
    train_images = smoke.TRAINER_IMAGES - int(smoke.TRAINER_IMAGES * cfg["data"]["val_split"])
    steps = -(-train_images // training["batch_size"])
    assert steps == 9 and divmod(smoke.PREEMPT_STEP, steps) == (1, 4)
    plain = port_to_container(port_compose(REPO / "configs", "dino"))
    assert cfg["model"] == plain["model"] and cfg["data"] == plain["data"]


def test_chip_smoke_moe_phase_is_v_moe_b16():
    """V-MoE-B/16 "every-2": configs/vit_b_imagenet.yaml with MOE_OVERRIDES
    validates, builds 6 MoE blocks of 8 experts among 12 (the rest as
    written: top-2, capacity factor 1.25, remat, batch 1024) with 64 slots
    an expert an image, and MOE_IMAGES makes 2 train steps and 1 val step."""
    from vit_ssl_tpu_torch.config import compose as port_compose
    from vit_ssl_tpu_torch.config import to_container as port_to_container
    from vit_ssl_tpu_torch.config import validate_train_config
    from vit_ssl_tpu_torch.ops.moe import expert_capacity

    smoke = _load_chip_smoke()
    config = port_compose(REPO / "configs", "vit_b_imagenet", smoke.MOE_OVERRIDES)
    validate_train_config(config)
    cfg = port_to_container(config)
    model = cfg["model"]
    assert (model["moe_experts"], model["moe_every"], model["moe_top_k"]) == (8, 2, 2)
    assert model["moe_capacity_factor"] == 1.25 and cfg["parallel"]["remat"] is True
    assert [(i + 1) % model["moe_every"] == 0 for i in range(12)].count(True) == 6
    assert expert_capacity(model["moe_group_size"], 8, 2, 1.25) == 64
    val = int(smoke.MOE_IMAGES * cfg["data"]["val_split"])
    assert -(-(smoke.MOE_IMAGES - val) // 1024) == 2 and 0 < val <= 1024


def test_chip_smoke_patch_dropout_b1_case():
    """Patch dropout 0.5 at 224 px keeps the CLS token and 98 of 196
    patches: B1's training case (1024, 99, 12x64) is checked and timed."""
    from vit_ssl_tpu_torch.models.vit import patch_keep_count

    smoke = _load_chip_smoke()
    assert smoke.PATCH_B1_CASE == (1024, 1 + patch_keep_count(196, 0.5), 12, 64,
                                   "bfloat16", 0)
    assert smoke.PATCH_B1_CASE in smoke.TRAIN_CASES


def test_chip_smoke_b2_bounds():
    """ViT-B/16 at 512 px, (64, 12, 1025, 64) bf16: 100.8 MB a tensor, 3.1 MB
    of lse and 103.3 GFLOP a product. Forward 406 MB (0.121 ms) against two
    products (0.209 ms); dq 611 MB (0.182 ms) against three (0.313 ms);
    dk/dv the same bytes against four (0.418 ms): operations bound all
    three."""
    smoke = _load_chip_smoke()
    act = 64 * 12 * 1025 * 64 * 2
    row = 64 * 12 * 1025 * 4
    product = 2 * 64 * 12 * 1025 * 1025 * 64
    bounds = smoke.blockwise_bounds(64, 12, 1025, 64, "bfloat16")
    for part, products in (("fwd", 2), ("dq", 3), ("dkv", 4)):
        assert bounds[part] == pytest.approx((products * product / 989e9, "operations"))
    assert 0.2088 < bounds["fwd"][0] < 0.2090 and 0.3132 < bounds["dq"][0] < 0.3134
    assert 0.4177 < bounds["dkv"][0] < 0.4179
    assert (4 * act + row) / 3.35e9 == pytest.approx(0.1212, abs=1e-4)
    f32 = smoke.blockwise_bounds(64, 12, 1025, 64, "float32")
    assert f32["fwd"] == pytest.approx((2 * product / 67e9, "operations"))


def test_chip_smoke_b3_bounds():
    """ViT-B/16 at 384 px, (64, 12, 577, 64) bf16: 56.7 MB a tensor and
    32.7 GFLOP a product. Inference forward 227 MB (0.068 ms) against two
    products (0.066 ms): bytes. Training forward + 3.5 MB of statistics
    (0.069 ms): bytes. Backward 401 MB (0.120 ms) against five products
    (0.165 ms): operations."""
    smoke = _load_chip_smoke()
    act = 64 * 12 * 577 * 64 * 2
    product = 2 * 64 * 12 * 577 * 577 * 64
    inference = smoke.attention_bound(64, 577, 12, 64, "bfloat16", 0)
    train = smoke.attention_train_bounds(64, 577, 12, 64, "bfloat16", 0)
    assert inference == pytest.approx((4 * act / 3.35e9, "bytes"))
    assert train["fwd"][1] == "bytes" and train["bwd"] == pytest.approx(
        (5 * product / 989e9, "operations"))
    assert 0.0677 < inference[0] < 0.0678 and 0.0687 < train["fwd"][0] < 0.0689
    assert 0.165 < train["bwd"][0] < 0.166


def test_long_self_attention_names_b2(monkeypatch):
    """N > 1024 without a mask is kernel B2's: on the CPU MultiHeadAttention
    reaches ``blockwise_attention`` (its plain versions) once, on contiguous
    (B, H, N, D) heads, and gives the attention visualizer's plain path's
    output; that path still returns the probabilities."""
    from vit_ssl_tpu_torch.ops import MultiHeadAttention
    from vit_ssl_tpu_torch.ops import attention as attention_mod

    calls = []
    real = attention_mod.blockwise_attention
    monkeypatch.setattr(attention_mod, "blockwise_attention",
                        lambda *a: calls.append((a[0].shape, a[0].is_contiguous()))
                        or real(*a))
    mha = MultiHeadAttention(64, 2).requires_grad_(False)
    x = torch.randn(1, 1025, 64, generator=torch.Generator().manual_seed(0))
    out = mha(x)
    assert calls == [((1, 2, 1025, 32), True)]
    plain, probs = mha(x, return_attn=True)
    assert probs.shape == (1, 2, 1025, 1025)
    torch.testing.assert_close(out, plain, atol=1e-5, rtol=1e-5)


def test_chip_smoke_training_bounds():
    """Training shape (256, 145, 6x64) bf16: the forward moves 114 MB of
    q/k/v/o and 1.8 MB of statistics (about 35 us at 3.35 TB/s); the
    backward about 200 MB (60 us) against 21 GFLOP (21 us): bytes bound
    both."""
    bounds = _load_chip_smoke().attention_train_bounds(256, 145, 6, 64, "bfloat16", 0)
    act = 256 * 145 * 384 * 2
    stats = 256 * 6 * 145 * 8
    assert bounds["fwd"] == pytest.approx(((4 * act + stats) / 3.35e9, "bytes"))
    assert bounds["bwd"] == pytest.approx(((7 * act + stats) / 3.35e9, "bytes"))
    assert 0.034 < bounds["fwd"][0] < 0.036 and 0.059 < bounds["bwd"][0] < 0.061


def test_chip_smoke_attention_bound():
    """Serving shape (128, 145, 6x64) bf16: 57 MB of q/k/v/o at 3.35 TB/s
    (17 us) against 4.1 GFLOP at 989 TFLOP/s (4.2 us): bytes bound it."""
    bound_ms, bound_by = _load_chip_smoke().attention_bound(128, 145, 6, 64,
                                                            "bfloat16", 0)
    assert bound_by == "bytes"
    assert bound_ms == pytest.approx(4 * 128 * 145 * 384 * 2 / 3.35e12 * 1e3)


def test_chip_smoke_mlp_bounds():
    """Kernel B4 at the student's globals (T = 37120, 384 -> 1536, bf16):
    the forward's two products are 87.6 GFLOP (0.089 ms at 989 TFLOP/s)
    against about 230 MB with the keep-mask and the saved pre (0.069 ms at
    3.35 TB/s); the backward's four are 175 GFLOP (0.177 ms) against about
    260 MB (0.078 ms): operations bound both."""
    bounds = _load_chip_smoke().mlp_bounds(37120, 384, 1536, "bfloat16")
    flops = 2 * 2 * 37120 * 384 * 1536
    assert bounds["fwd"] == pytest.approx((flops / 989e9, "operations"))
    assert bounds["bwd"] == pytest.approx((2 * flops / 989e9, "operations"))
    assert 0.088 < bounds["fwd"][0] < 0.089 and 0.177 < bounds["bwd"][0] < 0.178
    served = _load_chip_smoke().mlp_bounds(18560, 384, 1536, "bfloat16",
                                           mask=False, pre=False)
    assert served["fwd"] == pytest.approx((flops / 2 / 989e9, "operations"))


def test_chip_smoke_masked_matmul_bounds():
    """Kernel P2 at the probe's shape (T = 37120, 1536 -> 384, bf16): the
    forward moves h (114.0 MB), the int8 mask (57.0 MB), o (28.5 MB) and w2,
    200.7 MB (0.0599 ms at 3.35 TB/s), against 43.8 GFLOP (0.0443 ms at 989
    TFLOP/s); the backward h, the mask, do, dh and w2 and dw2, 316.4 MB
    (0.0944 ms) against two products (0.0886 ms): bytes bound both."""
    bounds = _load_chip_smoke().masked_bounds(37120, 1536, 384, "bfloat16")
    h, mask, o, w = 37120 * 1536 * 2, 37120 * 1536, 37120 * 384 * 2, (384 * 1536 + 384) * 2
    assert bounds["fwd"] == pytest.approx(((h + mask + o + w) / 3.35e9, "bytes"))
    assert bounds["bwd"] == pytest.approx(((2 * h + mask + o + 2 * w) / 3.35e9, "bytes"))
    assert 0.0598 < bounds["fwd"][0] < 0.0600 and 0.0943 < bounds["bwd"][0] < 0.0946
    assert 2 * 37120 * 1536 * 384 / 989e9 == pytest.approx(0.0443, abs=1e-4)


def test_chip_smoke_wide_mlp_bounds():
    """Kernel B4 at ViT-B/16's FFN (T = 36928, 768 -> 3072, bf16): 348
    GFLOP a forward (0.352 ms) and twice that a backward (0.705 ms), far
    above their bytes: operations bound both."""
    bounds = _load_chip_smoke().mlp_bounds(36928, 768, 3072, "bfloat16")
    flops = 4 * 36928 * 768 * 3072
    assert bounds["fwd"] == pytest.approx((flops / 989e9, "operations"))
    assert bounds["bwd"] == pytest.approx((2 * flops / 989e9, "operations"))
    assert 0.352 < bounds["fwd"][0] < 0.353


@pytest.mark.parametrize("alone", [False, True], ids=["in-repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """No card here: exit non-zero and print no result, both from the
    checkout and from a directory holding chip_smoke.py and nothing else."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the card-less path")
    cwd = REPO
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_data_parallel_config_is_dino_yaml_with_fsdp():
    """The data-parallel phase's config: the port's composition of
    configs/dino.yaml with its overrides, which change only num_epochs (2,
    as the trainer phase it is held to), eval.interval (0: the evaluations
    leave the trained state as it is) and parallel.fsdp (true); its model,
    data and transforms are DINO_VIT_S8's."""
    from vit_ssl_tpu_torch.config import compose as port_compose
    from vit_ssl_tpu_torch.config import to_container as port_to_container

    smoke = _load_chip_smoke()
    plain = port_to_container(port_compose(REPO / "configs", "dino"))
    cfg = port_to_container(port_compose(REPO / "configs", "dino", smoke.DP_OVERRIDES))
    assert cfg["parallel"] == dict(plain["parallel"], fsdp=True)
    assert cfg["training"] == dict(plain["training"], num_epochs=2)
    assert cfg["eval"] == dict(plain["eval"], interval=0)
    for key in ("model", "data", "transforms"):
        assert cfg[key] == plain[key], key
    assert smoke.config_differences({k: smoke.DINO_VIT_S8[k] for k in
                                     ("model", "data", "transforms")}, cfg) == []
    assert set(smoke.TRAINER_OVERRIDES) - {"eval.interval=1"} <= set(smoke.DP_OVERRIDES)


def test_chip_smoke_ring_shape_divides_by_its_sp():
    """The ring phase runs ViT-B/16's 512-px attention (B2's first case,
    N = (512 / 16)^2 + 1 = 1025) as sp virtual ranks: sp divides N."""
    smoke = _load_chip_smoke()
    b, h, n, d, dtype = smoke.RING_CASE
    assert smoke.RING_CASE == smoke.BLOCKWISE_CASES[0]
    img, patch = smoke.VIT_B16_512["data"]["img_size"], smoke.VIT_B16_512["model"]["patch_size"]
    assert n == (img // patch) ** 2 + 1 and h == smoke.VIT_B16_512["model"]["num_heads"]
    assert smoke.RING_SP > 1 and n % smoke.RING_SP == 0



def test_chip_smoke_jpeg_folder_makes_two_train_and_one_val_step(tmp_path):
    """The JPEG-folder phase's folder (JPEG_FILES names in JPEG_CLASSES
    class folders) under configs/vit_b_imagenet.yaml with JPEG_OVERRIDES:
    the model as written, 8 loader workers, 512 train images in 2 steps of
    256 and 21 val images in 1 step."""
    from vit_ssl_tpu_torch.config import compose as port_compose
    from vit_ssl_tpu_torch.config import to_container as port_to_container
    from vit_ssl_tpu_torch.data.builder import prepare_dataloaders

    smoke = _load_chip_smoke()
    source = tmp_path / "one.jpg"
    source.write_bytes(smoke.encode_jpeg(np.zeros((8, 8, 3), np.uint8)))
    folder = tmp_path / "train"
    for j in range(smoke.JPEG_FILES):
        cls = folder / f"n{j % smoke.JPEG_CLASSES:08d}"
        cls.mkdir(parents=True, exist_ok=True)
        os.link(source, cls / f"{j}.JPEG")
    config = port_compose(REPO / "configs", "vit_b_imagenet",
                          [f"data.data_dir={folder}", *smoke.JPEG_OVERRIDES])
    composed = port_to_container(config)
    _assert_within({k: smoke.VIT_B16_224[k] for k in ("model", "parallel")}, composed,
                   "config")
    assert composed["data"]["num_workers"] == 8
    train, val = prepare_dataloaders(config, "supervised")
    assert (len(train.dataset), len(val.dataset)) == (512, 21)
    assert (len(train), len(val), train.batch_size) == (2, 1, 256)


def test_chip_smoke_orbax_fixture_b1_cases():
    """The orbax phase's step from the JAX DINO fixture runs B1 at the
    fixture's shapes, fp32: the globals (2·B, (IMG/patch)² + 1) and the
    packed locals (B, 4·((LOCAL_IMG/patch)² + 1), block (LOCAL_IMG/patch)²
    + 1), one head of 32. Both are cases that the kernels phase holds
    against plain attention, in the inference and the training lists."""
    from vit_ssl_tpu_torch.config import compose as port_compose

    smoke = _load_chip_smoke()
    spec = smoke.fixture_spec()
    config = port_compose(str(REPO / "configs"), "dino", spec.DINO)
    patch, heads = int(config.model.patch_size), int(config.model.num_heads)
    head_dim = int(config.model.embed_dim) // heads
    n_global = (spec.IMG // patch) ** 2 + 1
    n_local = (spec.LOCAL_IMG // patch) ** 2 + 1
    dtype = str(config.model.compute_dtype)
    assert smoke.ORBAX_FIXTURE_B1_CASES == [
        (2 * spec.B, n_global, heads, head_dim, dtype, 0),
        (spec.B, 4 * n_local, heads, head_dim, dtype, n_local)]
    for case in smoke.ORBAX_FIXTURE_B1_CASES:
        assert case in smoke.ATTENTION_CASES and case in smoke.TRAIN_CASES


def test_chip_smoke_orbax_fixture_spec_imports_no_jax():
    """What ``chip_smoke.py`` loads of the orbax fixtures is
    ``fixture_spec.py``, which imports numpy and the standard library only
    (AST scan); in a fresh interpreter, loading the script and the spec and
    using its loaders and ``leaf_digests`` leaves JAX, the JAX package,
    orbax, tensorstore and zstandard out of ``sys.modules``."""
    spec_file = REPO / "tests" / "torch_orbax_fixtures" / "fixture_spec.py"
    roots = set(_imported_roots(spec_file))
    assert roots <= {"__future__", "hashlib", "pathlib", "numpy"}, roots
    assert "make_fixtures" not in (REPO / "chip_smoke.py").read_text()
    blocked = FORBIDDEN + ("orbax", "tensorstore", "zstandard")
    code = (
        "import importlib.util, sys\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "smoke = importlib.util.module_from_spec(spec); spec.loader.exec_module(smoke)\n"
        "fs = smoke.fixture_spec()\n"
        "train, val = fs.loaders('dino')\n"
        "batch = next(iter(train))\n"
        "assert len(fs.leaf_digests(batch)) == 7\n"
        f"print(sorted(m for m in sys.modules if m.split('.')[0] in {blocked!r}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]"
