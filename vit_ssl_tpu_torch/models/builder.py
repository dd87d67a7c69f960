"""Model factory (port of ``vit_ssl_tpu/models/builder.py::build_model``):
the supervised/finetune :class:`~.vit.ViT`, the :class:`~.simmim.SimMIMViT`
(``model.mask_ratio``), the DINO backbone that serving loads, and the full
``DINONetwork`` that training runs.

The config is the plain dict a checkpoint embeds (``.pth`` written by
``scripts/export_torch.py``): ``model.*``, ``data.img_size``,
``parallel.remat`` and the mode under ``training.type`` or ``eval.mode``.

Finetune's weight surgery (after ``vit_ssl_tpu/models/builder.py:156-428``),
in the port's own key space, the reference ``.pth`` layout of its state
dicts (``encoder_blocks.0.self_attention.w_query.weight``, …):

- :func:`load_pretrained` reads a checkpoint into one flat state dict, as
  the JAX package's ``_load_pretrained_tree`` and the trainer's
  ``_merged_pre`` do: a DINO checkpoint's student under ``backbone.`` and
  ``head.``, its teacher under ``teacher.backbone.`` and ``teacher.head.``,
  and ``center``; a ViT's or a SimMIM's under their own keys.
- :func:`load_weights` transfers it into a ViT's state dict by the
  reference's rules: exact matches, ``projection.* → patch_embedding.
  projection.*``, a positional embedding one token short padded with a
  zero CLS slot, SSL-only keys (``simmim_head``, ``mask_token``,
  ``teacher.*``, ``center``) skipped. As in the reference nothing reaches a
  ViT from a DINO checkpoint (the prefixes never match) unless
  ``extended``: then the teacher backbone's blocks, CLS token and patch
  projection (``proj`` → ``conv``, the same layout) transfer, its
  positional embedding resized with the Keys cubic of ``jax.image.resize``
  (:mod:`..ops.resample`) when the grids differ, and a SimMIM projection
  (D, C·p²) becomes the conv kernel (D, C, p, p).
- :func:`freeze_backbone_mask` and :func:`all_trainable_mask` give the
  trainable mask by parameter name; :func:`check_loaded_model` counts the
  tensors that equal their checkpoint's.

As in JAX, :func:`load_weights` first converts the checkpoint's encoder
stack to the target's layout (unrolled ``encoder_blocks.{i}.*`` ↔ stacked
``encoder_scan.block.*``, :mod:`..ops.encoder_stack`), under any prefix,
and last upcycles a dense checkpoint into an MoE target (sparse upcycling,
Komatsuzaki et al., arXiv:2212.05055): every expert of
``encoder_blocks.{i}.moe`` starts as a copy of the dense FFN of block i
(``linear_in.weight`` (f, d) transposed into each ``w1`` slice (d, f),
``linear_out.weight`` into ``w2``, the biases into ``b1``, ``b2``), under
the DINO backbone prefixes too with ``extended``; the router keeps its
fresh draw. Orbax checkpoints of the JAX package are not read (item 11);
their ``.pth`` exports are.
"""

from __future__ import annotations

import logging
from typing import Dict, Mapping

import torch
from torch import nn

from ..ops import encoder_stack as es
from ..ops.precision import resolve_precision
from ..ops.resample import resize_hw
from .dino import DINONetwork, ViTBackbone
from .simmim import SimMIMViT
from .vit import ViT

logger = logging.getLogger(__name__)

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
            "supervised/finetune ViT and the SimMIM ViT"
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
        moe_every=int(model.get("moe_every", 2)),
        moe_top_k=int(model.get("moe_top_k", 2)),
        moe_capacity_factor=float(model.get("moe_capacity_factor", 1.25)),
        moe_group_size=int(model.get("moe_group_size", 0) or 0),
        moe_aux_weight=float(model.get("moe_aux_weight", 0.01)),
        moe_zloss_weight=float(model.get("moe_zloss_weight", 1e-3)),
        moe_router_noise=float(model.get("moe_router_noise", 0.0)),
        **_common_kwargs(config, device),
    )


def build_simmim(config: dict, device) -> SimMIMViT:
    """The SimMIM ViT the config describes, on ``device`` (JAX
    ``build_model``'s ``simmim`` branch), masking ``model.mask_ratio`` of
    the patches."""
    mode = config_mode(config)
    if mode != "simmim":
        raise ValueError(f"mode '{mode}' does not build a SimMIM ViT")
    return SimMIMViT(mask_ratio=float(config["model"]["mask_ratio"]),
                     **_common_kwargs(config, device))


def build_model(config: dict, device) -> nn.Module:
    """The model of the config's mode, on ``device``: the ViT for
    supervised and finetune, the ``SimMIMViT`` for simmim, the
    ``DINONetwork`` for dino and eval_dino."""
    mode = config_mode(config)
    if mode in ("supervised", "finetune"):
        return build_vit(config, device)
    if mode in ("dino", "eval_dino"):
        return build_dino_network(config, device)
    if mode == "simmim":
        return build_simmim(config, device)
    raise ValueError(f"Unknown model-building mode: {mode}")


def build_backbone(config: dict, device) -> ViTBackbone:
    """The DINO ViT backbone the config describes, on ``device``."""
    return ViTBackbone(**_dino_kwargs(config, device))


def build_dino_network(config: dict, device) -> DINONetwork:
    """The DINO student/teacher network (backbone + head, ``output_dim``
    from ``model.output_dim``) the config describes, on ``device``."""
    return DINONetwork(output_dim=int(config["model"]["output_dim"]),
                       **_dino_kwargs(config, device))


# ---------------------------------------------------------------------------
# Finetune's weight surgery, in the reference state-dict key space

# where a DINO checkpoint's backbone sits in load_pretrained's flat dict, the
# teacher's first (JAX _extended_transfer's order)
_BACKBONE_PREFIXES = ("teacher.backbone.", "backbone.")


def load_pretrained(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint as one flat state dict on the CPU: a ``.pth``/``.pt``
    (a reference-layout export) or a train-state directory of the port."""
    from ..utils.checkpoint import checkpoint_exists, load_checkpoint, load_pth

    if path.endswith((".pth", ".pt")):
        sd, _ = load_pth(path)
        if not any(k.startswith("teacher_backbone.") for k in sd):
            return dict(sd)  # a ViT's or a SimMIM's own keys
        out = {}
        for key, value in sd.items():
            if key.startswith("student_"):
                out[key[len("student_"):]] = value
            elif key.startswith("teacher_"):
                out["teacher." + key[len("teacher_"):]] = value
            else:
                out[key] = value
        return out
    if not checkpoint_exists(path):
        raise FileNotFoundError(f"Checkpoint file not found: {path}")
    tree, _ = load_checkpoint(path)
    if "student" in tree:  # a DINO train state
        out = dict(tree["student"])
        out.update({f"teacher.{k}": v for k, v in tree["teacher"].items()})
        out["center"] = tree["center"]
        return out
    return dict(tree["model"])


def _interp_pos_embed(src_pe: torch.Tensor, tgt_shape) -> torch.Tensor:
    """(1, 1 + g², D) → ``tgt_shape`` (1, 1 + G², D): the patch grid resized
    with the Keys cubic (antialiased, as ``jax.image.resize``'s bicubic),
    the CLS entry carried over."""
    d = src_pe.shape[-1]
    src_g = int(round((src_pe.shape[1] - 1) ** 0.5))
    tgt_n = tgt_shape[1] - 1
    tgt_g = int(round(tgt_n ** 0.5))
    grid = src_pe[:, 1:].float().reshape(1, src_g, src_g, d)
    resized = resize_hw(grid, tgt_g, tgt_g, "cubic").reshape(1, tgt_n, d)
    return torch.cat([src_pe[:, :1].float(), resized], dim=1)


def _extended_transfer(out, src, tgt):
    """The transfers the reference cannot make: a DINO backbone (the
    teacher's when the checkpoint has one) and a SimMIM projection."""
    prefix, candidates = "", {}
    for prefix in _BACKBONE_PREFIXES:
        candidates = {k: v for k, v in src.items() if k.startswith(prefix)}
        if candidates:
            break
    for key, value in candidates.items():
        mapped = key[len(prefix):].replace("patch_embedding.proj.",
                                           "patch_embedding.conv.")
        if mapped in tgt and value.shape == tgt[mapped].shape:
            out[mapped] = value
        elif mapped.endswith("positional_embedding") and mapped in tgt:
            if value.shape[1] != tgt[mapped].shape[1]:
                out[mapped] = _interp_pos_embed(value, tgt[mapped].shape)

    conv = "patch_embedding.conv.weight"
    if "projection.weight" in src and conv in tgt:
        d, c, p, _ = tgt[conv].shape
        weight = src["projection.weight"]
        if tuple(weight.shape) == (d, c * p * p):
            out[conv] = weight.reshape(d, c, p, p)
            if "projection.bias" in src:
                out["patch_embedding.conv.bias"] = src["projection.bias"]
    return out


def load_weights(target: Mapping[str, torch.Tensor],
                 pretrained: Mapping[str, torch.Tensor],
                 extended: bool = False) -> Dict[str, torch.Tensor]:
    """``target`` (a ViT's state dict) with what ``pretrained`` (from
    :func:`load_pretrained`) transfers into it; the other entries are
    ``target``'s own tensors."""
    tgt = dict(target)
    out = dict(tgt)
    pretrained = _align_stack_convention(dict(pretrained), tgt)
    upcycle_keys = _moe_upcycle_sources(tgt)
    for key, value in pretrained.items():
        if key in tgt:
            if value.shape == tgt[key].shape:
                out[key] = value
            else:
                logger.warning("Shape mismatch for '%s': pretrained %s vs model %s",
                               key, tuple(value.shape), tuple(tgt[key].shape))
        elif key.startswith("projection.") and f"patch_embedding.{key}" in tgt:
            new_key = f"patch_embedding.{key}"
            if value.shape == tgt[new_key].shape:
                out[new_key] = value
                logger.info("Remapped key '%s' to '%s'", key, new_key)
        elif key == "positional_embedding" and "patch_embedding.positional_embedding" in tgt:
            ft_pe = tgt["patch_embedding.positional_embedding"]
            if value.shape[1] == ft_pe.shape[1] - 1 and value.shape[2] == ft_pe.shape[2]:
                logger.info("Padding positional embedding (CLS slot zeroed)")
                new_pe = torch.zeros_like(ft_pe)
                new_pe[:, 1:, :] = value
                out["patch_embedding.positional_embedding"] = new_pe
            else:
                logger.warning("Cannot pad positional_embedding: %s vs %s",
                               tuple(value.shape), tuple(ft_pe.shape))
        elif ("simmim_head" in key or "mask_token" in key
              or key.startswith("teacher.") or key.startswith("center")):
            logger.info("Skipping SSL-specific key: %s", key)
        elif key in upcycle_keys:
            pass  # consumed by _upcycle_moe below
        else:
            logger.warning("Key '%s' from checkpoint not found in the model.", key)
    if extended:
        out = _extended_transfer(out, pretrained, tgt)
    out = _upcycle_moe(out, pretrained, tgt, extended)
    updated = sum(1 for k in tgt if out[k] is not tgt[k])
    logger.info("load_weights: %d/%d target tensors updated", updated, len(tgt))
    return out


def _align_stack_convention(src, tgt):
    """``src`` in ``tgt``'s encoder-stack layout (unrolled ↔ stacked), so
    that checkpoints of either layout load into models of either."""
    if es.flat_has_scanned(tgt) and es.flat_has_unrolled(src):
        logger.info("load_weights: stacking unrolled encoder blocks (checkpoint) "
                    "into the scanned layout (model)")
        return es.flat_to_scanned(src)
    if es.flat_has_unrolled(tgt) and es.flat_has_scanned(src):
        logger.info("load_weights: unstacking scanned encoder blocks (checkpoint) "
                    "into the unrolled layout (model)")
        return es.flat_to_unrolled(src)
    return src


# an MoE expert tensor -> (the dense FFN tensor it copies, transposed?)
_UPCYCLE = {"w1": ("linear_in.weight", True), "b1": ("linear_in.bias", False),
            "w2": ("linear_out.weight", True), "b2": ("linear_out.bias", False)}


def _moe_upcycle_sources(tgt):
    """The dense-FFN checkpoint keys that :func:`_upcycle_moe` consumes."""
    keys = set()
    for k in tgt:
        parts = k.split(".")
        if len(parts) >= 3 and parts[-2] == "moe" and parts[-1] in _UPCYCLE:
            keys.add(".".join(parts[:-2]) + ".feed_forward." + _UPCYCLE[parts[-1]][0])
    return keys


def _upcycle_moe(out, src, tgt, extended: bool = False):
    """Each MoE expert tensor of ``tgt`` whose block has a dense FFN in
    ``src`` (under the backbone prefixes too with ``extended``): that
    tensor, in the expert layout, copied to every expert."""
    prefixes = ("",) + (_BACKBONE_PREFIXES if extended else ())
    for key, value in tgt.items():
        parts = key.split(".")
        if len(parts) < 3 or parts[-2] != "moe" or parts[-1] not in _UPCYCLE:
            continue  # the router keeps its fresh draw
        dense_name, transposed = _UPCYCLE[parts[-1]]
        dense_key = ".".join(parts[:-2]) + ".feed_forward." + dense_name
        dense = next((src[p + dense_key] for p in prefixes if p + dense_key in src), None)
        if dense is None:
            if parts[-1] == "w1":
                logger.warning("MoE upcycle: no dense FFN found for '%s'; experts keep "
                               "their fresh init", ".".join(parts[:-1]))
            continue
        dense = dense.t() if transposed else dense
        if tuple(dense.shape) != tuple(value.shape[1:]):
            logger.warning("MoE upcycle: dense '%s' %s does not match the expert slice "
                           "of '%s' %s", dense_key, tuple(dense.shape), key,
                           tuple(value.shape))
            continue
        out[key] = dense.to(value.dtype).expand_as(value).clone()
        if parts[-1] == "w1":
            logger.info("Upcycled dense FFN '%s' into %d experts of '%s'",
                        dense_key.rsplit(".", 2)[0], value.shape[0],
                        ".".join(parts[:-1]))
    return out


def load_state_any_layout(model: nn.Module, state: Mapping[str, torch.Tensor]) -> None:
    """``model.load_state_dict(state, strict=True)`` after converting
    ``state``'s encoder stack to the model's layout: a ``.pth`` exported
    from a scanned run holds unrolled blocks, and a config that asks for
    ``scan_layers`` builds a stacked model."""
    model.load_state_dict(_align_stack_convention(dict(state), model.state_dict()),
                          strict=True)


def _frozen(name: str) -> bool:
    return name.startswith(("encoder_blocks.", "encoder_scan.")) or (
        name.startswith("patch_embedding.") and "cls_token" not in name)


def freeze_backbone_mask(model: nn.Module) -> Dict[str, bool]:
    """Trainable by parameter name: False for the encoder blocks and the
    patch embedding (its CLS token excepted), True elsewhere."""
    return {name: not _frozen(name) for name, _ in model.named_parameters()}


def all_trainable_mask(model: nn.Module) -> Dict[str, bool]:
    return {name: True for name, _ in model.named_parameters()}


def check_loaded_model(state: Mapping[str, torch.Tensor],
                       pretrained: Mapping[str, torch.Tensor],
                       extended: bool = False) -> Dict[str, int]:
    """Count the live tensors equal (within 1e-5) to the checkpoint's
    tensor of the same name and shape, and those that differ. With
    ``extended`` a live tensor is also looked up where
    :func:`load_weights` took it from: the DINO backbone's (``proj`` for
    ``conv``). The JAX package looks up the same name only, so after an
    extended transfer from DINO it counts nothing."""
    matched = mismatched = 0
    pretrained = _align_stack_convention(dict(pretrained), dict(state))
    for key, value in state.items():
        sources = [key]
        if extended:
            sources += [p + key.replace("patch_embedding.conv.", "patch_embedding.proj.")
                        for p in _BACKBONE_PREFIXES]
        for source in sources:
            theirs = pretrained.get(source)
            if theirs is not None and theirs.shape == value.shape:
                if torch.allclose(value.detach().float().cpu(), theirs.float().cpu(),
                                  atol=1e-5):
                    matched += 1
                else:
                    mismatched += 1
                break
    logger.info("Matched parameters from checkpoint: %d", matched)
    if mismatched:
        logger.warning("Mismatched parameters: %d", mismatched)
    return {"matched": matched, "mismatched": mismatched}
