"""Typed config schemas with validation (a copy of
``vit_ssl_tpu/config/schemas.py``).

Instead of registering Hydra ConfigStore nodes, ``validate_train_config`` /
``validate_eval_config`` check a composed :class:`~.compose.Config` after the
fact: presence and types of required fields, enum membership for metric
names, and mode strings.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

from .compose import Config

# the metric names the configs' ``metrics`` lists may hold
METRIC_NAMES = frozenset(
    {
        "CenterNorm",
        "TeacherMean",
        "TeacherSTD",
        "TeacherVar",
        "StudentMean",
        "StudentSTD",
        "StudentVar",
        "CosineSim",
        "PSNR",
        "SSIM",
        "Accuracy",
        "F1Score",
        "Recall",
        "Precision",
    }
)

TRAIN_MODES = frozenset({"supervised", "finetune", "simmim", "dino"})
EVAL_MODES = frozenset({"eval_knn", "eval_linear", "eval_umap", "eval_dino"})


@dataclass
class ModelSchema:
    patch_size: int = 16
    in_channels: int = 3
    embed_dim: int = 384
    num_blocks: int = 6
    num_heads: int = 6
    mlp_dim: int = 1536
    dropout: float = 0.1
    num_classes: Optional[int] = None
    output_dim: Optional[int] = None
    center_momentum: Optional[float] = None
    mask_ratio: Optional[float] = None
    # TPU-native additions
    matmul_precision: str = "default"  # default | high | highest (parity)
    compute_dtype: str = "bfloat16"
    use_flash_attention: bool = True
    use_fused_mlp: bool = False
    fast_dropout: bool = True  # uint16-threshold dropout (ops/dropout.py)
    patch_dropout: float = 0.0  # supervised/finetune: PatchDropout keep-subset
    dino_pack_locals: bool = False  # pack local crops block-diagonally
    scan_layers: bool = False  # nn.scan encoder stack (ops/encoder_stack.py)
    # Mixture-of-Experts FFN (ops/moe.py; supervised/finetune only).
    # 0 = the reference's dense ViT; >0 = V-MoE-style routed experts in
    # every moe_every-th block, shardable over parallel.ep
    moe_experts: int = 0
    moe_every: int = 2
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 0  # routing-group tokens (0 = one global group)
    moe_aux_weight: float = 0.01
    moe_zloss_weight: float = 1.0e-3
    moe_router_noise: float = 0.0


@dataclass
class DataSchema:
    dataset_name: str = ""
    data_csv: str = ""
    data_dir: str = ""
    val_split: float = 0.2
    num_workers: int = 4
    img_size: int = 192
    local_img_size: Optional[int] = None


@dataclass
class TrainingSchema:
    type: str = ""
    random_seed: int = 42
    batch_size: int = 128
    num_epochs: int = 130
    warmup_epochs: int = 10
    warmup_initial_learning_rate: float = 1e-6
    warmup_final_learning_rate: float = 1e-4
    lr_final: float = 1e-6
    weight_decay: float = 0.001
    resume_from_checkpoint: Optional[str] = None
    grad_accum_steps: int = 1  # supervised/simmim: microbatched grad accumulation
    pretrained_path: Optional[str] = None
    freeze_backbone: bool = False
    # DINO fields
    student_temp: Optional[float] = None
    teacher_temp: Optional[float] = None
    teacher_temp_final: Optional[float] = None
    teacher_temp_scheduler: str = "cosine"
    # TPU-native addition: advance temp/momentum schedules per optimizer
    # step (the paper's granularity) instead of per epoch (the reference's)
    step_granular_schedules: bool = False
    teacher_momentum_start: Optional[float] = None
    teacher_momentum_final: Optional[float] = None
    num_all_views: Optional[int] = None
    num_global_views: Optional[int] = None
    teacher_dropout: bool = True  # reference quirk: teacher dropout active
    # TPU-native addition: preemption-safe training (utils/preempt.py)
    preempt_checkpointing: bool = True
    fault_inject_preempt_step: int = 0  # 0 = off; N = simulate preemption
    # rerun-same-command elastic restart: pick up <run>/preempt_model and
    # train up to the original num_epochs total (needs pinned hydra.run.dir)
    auto_resume: bool = False


@dataclass
class ParallelSchema:
    # TPU-native addition: the device mesh factors as dp × tp × pp × sp
    # × ep (dp implicit). All five axes are training-CLI product features.
    data_axis: str = "data"
    num_devices: int = -1
    tp: int = 1  # tensor parallelism (parallel/sharding_rules.py)
    pp: int = 1  # pipeline parallelism (parallel/pipeline.py + integrate.py)
    pp_microbatches: int = 0  # GPipe M (0 = pipe-axis size)
    pp_interleave: int = 1  # virtual stages per device (Megatron-style)
    sp: int = 1  # sequence parallelism / ring attention
    ep: int = 1  # expert parallelism for MoE FFN (model.moe_experts > 0)
    remat: bool = False
    fsdp: bool = False


@dataclass
class EvalSchema:
    interval: int = 0
    mode: Any = None
    dataset_name: str = ""
    data_csv: str = ""
    data_dir: str = ""
    num_classes: int = 10
    save_confusion_matrix: bool = False
    experiment_path: Optional[str] = None
    batch_size: Optional[int] = None


class ConfigValidationError(ValueError):
    pass


def _require(cfg: Config, section: str, keys: List[str]) -> None:
    node = cfg.get(section)
    if node is None:
        raise ConfigValidationError(f"Missing config section '{section}'")
    for key in keys:
        if node.get(key) is None:
            raise ConfigValidationError(f"Missing '{section}.{key}' in config")


def validate_train_config(cfg: Config) -> Config:
    """Validate a composed training config (TrainConfig equivalent)."""
    _require(cfg, "training", ["type", "batch_size", "num_epochs", "warmup_epochs"])
    _require(cfg, "model", ["patch_size", "in_channels", "embed_dim", "num_blocks", "num_heads", "mlp_dim"])
    _require(cfg, "data", ["img_size"])

    mode = str(cfg.training.type).lower()
    if mode not in TRAIN_MODES:
        raise ConfigValidationError(
            f"training.type={mode!r} is not one of {sorted(TRAIN_MODES)}"
        )

    for name in cfg.get("metrics", []) or []:
        if name not in METRIC_NAMES:
            raise ConfigValidationError(f"Unknown metric '{name}'")

    parallel = cfg.get("parallel", {}) or {}
    for key in ("tp", "pp", "sp", "ep", "pp_interleave"):
        if int(parallel.get(key, 1) or 1) < 1:
            raise ConfigValidationError(f"parallel.{key} must be >= 1")
    if bool(parallel.get("fsdp", False)) and int(parallel.get("tp", 1) or 1) > 1:
        raise ConfigValidationError(
            "parallel.fsdp and parallel.tp>1 cannot be combined — the "
            "parameter shardings conflict; pick one memory-sharding "
            "strategy"
        )

    # Scanned encoder stack (model.scan_layers, ops/encoder_stack.py)
    model = cfg.get("model", {}) or {}
    if bool(model.get("scan_layers", False)):
        if int(model.get("moe_experts", 0) or 0) > 0:
            raise ConfigValidationError(
                "model.scan_layers cannot be combined with "
                "model.moe_experts > 0 — the scanned stack is homogeneous; "
                "MoE blocks alternate with dense ones"
            )
        if int(parallel.get("pp", 1) or 1) > 1:
            raise ConfigValidationError(
                "model.scan_layers cannot be combined with parallel.pp — "
                "the pipeline already stacks+scans its own per-stage "
                "params; pp gives the same compile-time benefit"
            )
        if int(parallel.get("tp", 1) or 1) > 1:
            raise ConfigValidationError(
                "model.scan_layers cannot be combined with parallel.tp — "
                "the tensor-parallel sharding rules are written for the "
                "unrolled parameter tree; set model.scan_layers=false"
            )

    # Mixture-of-Experts (model.moe_experts, ops/moe.py)
    moe_experts = int(model.get("moe_experts", 0) or 0)
    ep = int(parallel.get("ep", 1) or 1)
    if moe_experts > 0:
        if mode not in ("supervised", "finetune"):
            raise ConfigValidationError(
                "model.moe_experts > 0 is only supported for "
                "supervised/finetune training (the SSL modes' parity "
                f"contract is the reference's dense ViT); got mode={mode!r}"
            )
        top_k = int(model.get("moe_top_k", 2) or 2)
        if not 1 <= top_k <= moe_experts:
            raise ConfigValidationError(
                f"model.moe_top_k={top_k} must be in [1, model.moe_experts="
                f"{moe_experts}]"
            )
        if float(model.get("moe_capacity_factor", 1.25)) <= 0:
            raise ConfigValidationError("model.moe_capacity_factor must be > 0")
        if int(model.get("moe_every", 2) or 2) < 1:
            raise ConfigValidationError("model.moe_every must be >= 1")
        if int(model.get("moe_group_size", 0) or 0) < 0:
            raise ConfigValidationError("model.moe_group_size must be >= 0")
        if int(model.get("moe_group_size", 0) or 0) == 0:
            # the GShard dense dispatch is O(group²) in memory/FLOPs; one
            # global group over B·N tokens is fine at test scale but costs
            # gigabytes at production batch sizes (ops/moe.py docstring)
            import logging

            img = int(cfg.get("data", {}).get("img_size", 0) or 0)
            patch = int(model.get("patch_size", 16) or 16)
            batch = int(cfg.get("training", {}).get("batch_size", 0) or 0)
            if img and batch:
                seq = (img // patch) ** 2 + 1
                tokens = batch * seq
                if tokens > 8192:
                    logging.getLogger(__name__).warning(
                        "model.moe_group_size=0 routes all %d tokens "
                        "(batch %d x seq %d) as ONE group — the dense "
                        "dispatch tensor scales O(tokens^2); set "
                        "model.moe_group_size=%d (per image) at this scale",
                        tokens, batch, seq, seq,
                    )
        if int(parallel.get("pp", 1) or 1) > 1:
            raise ConfigValidationError(
                "model.moe_experts > 0 cannot be combined with parallel.pp "
                "(the pipeline stacks homogeneous encoder blocks; MoE "
                "blocks alternate with dense ones)"
            )
        if ep > 1 and moe_experts % ep != 0:
            raise ConfigValidationError(
                f"parallel.ep={ep} must divide model.moe_experts="
                f"{moe_experts}"
            )
    if ep > 1 and moe_experts <= 0:
        raise ConfigValidationError(
            "parallel.ep > 1 requires model.moe_experts > 0 — there are "
            "no expert weights to shard in a dense model"
        )
    if ep > 1 and bool(parallel.get("fsdp", False)):
        raise ConfigValidationError(
            "parallel.fsdp and parallel.ep>1 cannot be combined — the "
            "parameter shardings conflict; pick one memory-sharding "
            "strategy"
        )

    if mode == "dino":
        _require(
            cfg,
            "training",
            [
                "student_temp",
                "teacher_temp",
                "teacher_momentum_start",
                "teacher_momentum_final",
                "num_all_views",
                "num_global_views",
            ],
        )
        _require(cfg, "model", ["output_dim", "center_momentum"])
    if mode == "simmim":
        _require(cfg, "model", ["mask_ratio"])
    if mode == "finetune":
        _require(cfg, "training", ["pretrained_path"])
    if mode in ("supervised", "finetune"):
        _require(cfg, "model", ["num_classes"])
    return cfg


def preflight_eval_data(cfg: Config) -> Config:
    """Fail fast when in-training evaluation is configured but its data
    paths don't exist.

    The SimMIM/DINO trainers run the unsupervised evaluator every
    ``eval.interval`` epochs, which loads a *labeled* dataset resolved from
    ``eval.data_dir``/``eval.data_csv`` (falling back to ``data.*`` —
    the JAX package's convention).
    Because mode presets ship an explicit ``eval.data_dir``, overriding only
    ``data.data_dir`` on the CLI leaves eval pointed at the preset path; the
    reference surfaces that only at the first eval epoch, killing an
    hours-long pretraining run. Checking at startup costs nothing and turns
    an epoch-``interval`` crash into a second-zero error.
    """
    training = cfg.get("training", {}) or {}
    mode = str(training.get("type", "")).lower()
    eval_cfg = cfg.get("eval", {}) or {}
    if mode not in ("simmim", "dino"):
        return cfg  # supervised in-fit eval reuses precomputed val preds
    interval = int(eval_cfg.get("interval", 0) or 0)
    if not interval or not eval_cfg.get("mode"):
        return cfg
    # In-fit eval fires on epoch % interval == 0; a fresh run of fewer
    # epochs than the interval never reaches one. (A resumed run continues
    # the epoch numbering, so with resume_from_checkpoint the check stays.)
    num_epochs = int(training.get("num_epochs", 0) or 0)
    if num_epochs < interval and not training.get("resume_from_checkpoint"):
        return cfg

    import os

    data_cfg = cfg.get("data", {}) or {}
    dataset = str(
        eval_cfg.get("dataset_name") or data_cfg.get("dataset_name") or ""
    ).lower()
    # key-absent fallback mirrors data/builder.py::_get_dataset exactly: a
    # PRESENT-but-empty eval.data_dir reaches the dataset constructor as
    # the empty value (and must fail here), it does not fall back to data.*
    resolved = {}
    if dataset in ("stl10", "cifar10"):
        resolved["data_csv"] = eval_cfg.get("data_csv", data_cfg.get("data_csv"))
        resolved["data_dir"] = eval_cfg.get("data_dir", data_cfg.get("data_dir"))
    elif dataset in ("imagefolder", "imagenet"):
        resolved["data_dir"] = eval_cfg.get("data_dir", data_cfg.get("data_dir"))
    missing = {k: v for k, v in resolved.items() if not v or not os.path.exists(v)}
    if missing:
        detail = ", ".join(f"eval.{k} -> {v!r}" for k, v in missing.items())
        raise ConfigValidationError(
            f"In-training evaluation is enabled (eval.interval="
            f"{eval_cfg.get('interval')}, eval.mode={eval_cfg.get('mode')}) "
            f"but its data paths do not exist: {detail}. Note that eval.* "
            "shadows data.* for evaluation loads — if you overrode "
            "data.data_dir/data.data_csv, override the eval.* keys too, or "
            "set eval.interval=0 to disable in-training evaluation."
        )
    return cfg


def validate_eval_config(cfg: Config) -> Config:
    """Validate a composed evaluation config (EvaluationConfig equivalent)."""
    _require(cfg, "eval", ["mode"])
    modes = cfg.eval.mode
    if not isinstance(modes, (list, tuple)):
        modes = [modes]
    for m in modes:
        if m not in EVAL_MODES:
            raise ConfigValidationError(f"eval.mode contains unknown mode {m!r}")
    return cfg
