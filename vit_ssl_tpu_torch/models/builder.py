"""Model factory (port of ``vit_ssl_tpu/models/builder.py::build_model``):
the supervised/finetune :class:`~.vit.ViT`, the DINO backbone that serving
loads, and the full ``DINONetwork`` that training runs.

The config is the plain dict a checkpoint embeds (``.pth`` written by
``scripts/export_torch.py``): ``model.*``, ``data.img_size``,
``parallel.remat`` and the mode under ``training.type`` or ``eval.mode``.
Finetune's weight surgery (``load_weights``, the freeze mask) is not
ported yet (``ROADMAP.md`` queue A item 4): ``build_vit`` builds the
model only.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.precision import resolve_precision
from .dino import DINONetwork, ViTBackbone
from .vit import ViT

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def config_mode(config: dict) -> str:
    mode = (config.get("training") or {}).get("type") or (
        config.get("eval") or {}
    ).get("mode")
    if mode is None:
        raise ValueError(
            "Could not determine mode. Set either 'training.type' or 'eval.mode'."
        )
    if isinstance(mode, (list, tuple)):
        mode = mode[0]
    return str(mode).lower()


def compute_dtype(config: dict) -> torch.dtype:
    name = str(config.get("model", {}).get("compute_dtype", "float32")).lower()
    return _DTYPES[name]


def _common_kwargs(config: dict, device) -> dict:
    """Constructor arguments shared by every model (JAX ``_common_kwargs``),
    with JAX's defaults. ``model.matmul_precision`` is checked here and
    passed to no module: each name the port takes means what it already
    does (:mod:`..ops.precision`)."""
    model = config["model"]
    img = int(config["data"]["img_size"])
    resolve_precision(model.get("matmul_precision", "default"))
    return dict(
        num_blocks=int(model["num_blocks"]),
        input_shape=(int(model["in_channels"]), img, img),
        embed_dim=int(model["embed_dim"]),
        patch_size=int(model["patch_size"]),
        num_heads=int(model["num_heads"]),
        mlp_dim=int(model["mlp_dim"]),
        dtype=compute_dtype(config),
        dropout=float(model.get("dropout", 0.1)),
        fast_dropout=bool(model.get("fast_dropout", True)),
        use_fused_mlp=bool(model.get("use_fused_mlp", False)),
        use_flash=bool(model.get("use_flash_attention", True)),
        init_scheme=str(model.get("init_scheme", "reference")),
        remat=bool((config.get("parallel") or {}).get("remat", False)),
        scan_layers=bool(model.get("scan_layers", False)),
        device=device,
    )


def _dino_kwargs(config: dict, device) -> dict:
    """Constructor arguments shared by the backbone and the network."""
    mode = config_mode(config)
    if mode not in ("dino", "eval_dino"):
        raise NotImplementedError(
            f"mode '{mode}' is not a DINO mode: build_model builds the "
            "supervised/finetune ViT; SimMIM is ROADMAP.md queue A item 6"
        )
    return _common_kwargs(config, device)


def build_vit(config: dict, device) -> ViT:
    """The supervised/finetune ViT the config describes, on ``device``
    (JAX ``build_model``'s ``supervised``/``finetune`` branch)."""
    mode = config_mode(config)
    if mode not in ("supervised", "finetune"):
        raise ValueError(f"mode '{mode}' does not build a ViT classifier")
    model = config["model"]
    return ViT(
        num_classes=int(model["num_classes"]),
        patch_dropout=float(model.get("patch_dropout", 0.0)),
        moe_experts=int(model.get("moe_experts", 0) or 0),
        **_common_kwargs(config, device),
    )


def build_model(config: dict, device) -> nn.Module:
    """The model of the config's mode, on ``device``: the ViT for
    supervised and finetune, the ``DINONetwork`` for dino and eval_dino."""
    mode = config_mode(config)
    if mode in ("supervised", "finetune"):
        return build_vit(config, device)
    if mode in ("dino", "eval_dino"):
        return build_dino_network(config, device)
    if mode == "simmim":
        raise NotImplementedError(
            "mode 'simmim' is not ported yet; see ROADMAP.md queue A item 6")
    raise ValueError(f"Unknown model-building mode: {mode}")


def build_backbone(config: dict, device) -> ViTBackbone:
    """The DINO ViT backbone the config describes, on ``device``."""
    return ViTBackbone(**_dino_kwargs(config, device))


def build_dino_network(config: dict, device) -> DINONetwork:
    """The DINO student/teacher network (backbone + head, ``output_dim``
    from ``model.output_dim``) the config describes, on ``device``."""
    return DINONetwork(output_dim=int(config["model"]["output_dim"]),
                       **_dino_kwargs(config, device))
