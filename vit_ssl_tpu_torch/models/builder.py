"""Model factory (port of the ``dino``/``eval_dino`` branch of
``vit_ssl_tpu/models/builder.py::build_model``): the DINO backbone that
serving loads, and the full ``DINONetwork`` that training runs.

The config is the plain dict a checkpoint embeds (``.pth`` written by
``scripts/export_torch.py``): ``model.*``, ``data.img_size`` and the mode
under ``training.type`` or ``eval.mode``.
"""

from __future__ import annotations

import torch

from .dino import DINONetwork, ViTBackbone

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


def _dino_kwargs(config: dict, device) -> dict:
    """Constructor arguments shared by the backbone and the network."""
    mode = config_mode(config)
    if mode not in ("dino", "eval_dino"):
        raise NotImplementedError(
            f"mode '{mode}' is not ported yet: the port serves DINO "
            "checkpoints only (supervised/finetune models are ROADMAP.md "
            "queue A item 7, SimMIM item 8)"
        )
    model = config["model"]
    img = int(config["data"]["img_size"])
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
        device=device,
    )


def build_backbone(config: dict, device) -> ViTBackbone:
    """The DINO ViT backbone the config describes, on ``device``."""
    return ViTBackbone(**_dino_kwargs(config, device))


def build_dino_network(config: dict, device) -> DINONetwork:
    """The DINO student/teacher network (backbone + head, ``output_dim``
    from ``model.output_dim``) the config describes, on ``device``."""
    return DINONetwork(output_dim=int(config["model"]["output_dim"]),
                       **_dino_kwargs(config, device))
