"""Checkpoints of the port: train-state directories and reference-layout
``.pth`` files.

:func:`save_checkpoint` writes what the trainer saves each epoch
(``best_model``, ``last_model``), after ``vit_ssl_tpu/utils/checkpoint.py``:
a directory written as ``<path>.tmp`` and swapped in with ``os.replace``,
holding ``metadata.json`` (epoch, the embedded config, the mode, ``best_*``)
and the state's tensors in one ``torch.save`` file (``state.pt``) where the
JAX package has an orbax tree. The port cannot read orbax directories.

:func:`load_pth` reads what ``scripts/export_torch.py`` writes from a JAX
run — ``{"model_state_dict": ..., "config": ..., "epoch": ...}`` — with
``torch.load(weights_only=True)``.

The weight bridge turns the JAX package's parameter trees (nested dicts of
numpy arrays, e.g. ``DINONetwork`` params) into reference-layout state
dicts that the port's modules load with ``strict=True``. It is a jax-free
copy of ``vit_ssl_tpu/utils/checkpoint.py::{_encoder_block_to_torch,
_dino_backbone_to_torch, _dino_head_to_torch, dino_params_to_torch,
vit_params_to_torch, simmim_params_to_torch}``, extended to the layouts
the reference has not: a tree with a scanned ``encoder_scan`` subtree
gives the port's stacked ``encoder_scan.block.*`` keys (each kernel
transposed on its last two dimensions), and an MoE block's
``moe.{router,w1,b1,w2,b2}`` pass as they are (the port keeps the JAX
layout for them). A ``.pth`` that the JAX exporter wrote from a scanned run
holds unrolled blocks; ``models.builder.load_weights`` loads either layout
into either.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

_META_FILE = "metadata.json"
_STATE_FILE = "state.pt"


def save_checkpoint(path: str, tree: Any, metadata: Dict[str, Any]) -> None:
    """Write ``tree`` (nested dicts and lists of tensors and numbers, on the
    CPU) and ``metadata`` to the directory ``path``: into ``<path>.tmp``,
    then swapped in."""
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp, exist_ok=True)
    torch.save(tree, os.path.join(tmp, _STATE_FILE))
    with open(os.path.join(tmp, _META_FILE), "w") as f:
        json.dump(metadata, f, indent=1, default=str)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Tuple[Any, Dict[str, Any]]:
    """(tree, metadata) of a directory :func:`save_checkpoint` wrote; the
    tensors on the CPU."""
    state_file = os.path.join(path, _STATE_FILE)
    if not os.path.exists(state_file):
        raise FileNotFoundError(
            f"{path} holds no {_STATE_FILE}: not a checkpoint of the port "
            "(orbax checkpoints of the JAX package cannot be read)")
    tree = torch.load(state_file, map_location="cpu", weights_only=True)
    with open(os.path.join(path, _META_FILE)) as f:
        metadata = json.load(f)
    return tree, metadata


def checkpoint_exists(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(os.path.join(path, _META_FILE))


def load_pth(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """(state_dict, metadata) of a ``.pth`` checkpoint, on the CPU: the
    state dict is ``model_state_dict``, the metadata every other top-level
    entry (``config``, ``epoch``)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if "model_state_dict" not in ckpt:
        raise ValueError(f"{path} has no model_state_dict")
    state = ckpt.pop("model_state_dict")
    return state, ckpt


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def _kernel_t(x) -> torch.Tensor:
    """A flax Dense kernel (..., in, out) → torch's (..., out, in)."""
    return _t(x).transpose(-1, -2).contiguous()


def attention_state_dict_from_flax(att: Mapping,
                                   prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX ``MultiHeadAttention`` params → ``MultiHeadAttention`` state dict."""
    return {f"{prefix}{name}.weight": _kernel_t(att[name]["kernel"])
            for name in ("w_query", "w_key", "w_value", "final_linear")}


def feed_forward_state_dict_from_flax(ff: Mapping,
                                      prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX ``FeedForwardBlock`` params → ``FeedForwardBlock`` state dict."""
    return {
        f"{prefix}linear_in.weight": _kernel_t(ff["w1"]),
        f"{prefix}linear_in.bias": _t(ff["b1"]),
        f"{prefix}linear_out.weight": _kernel_t(ff["w2"]),
        f"{prefix}linear_out.bias": _t(ff["b2"]),
    }


def encoder_block_state_dict_from_flax(block: Mapping,
                                      prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX ``EncoderBlock`` params → ``EncoderBlock`` state dict under
    ``prefix``; a scanned block's stacked leaves give stacked tensors."""
    sd = attention_state_dict_from_flax(block["self_attention"],
                                        f"{prefix}self_attention.")
    if "moe" in block:
        sd.update({f"{prefix}moe.{name}": _t(block["moe"][name])
                   for name in ("router", "w1", "b1", "w2", "b2")})
    else:
        sd.update(feed_forward_state_dict_from_flax(block["feed_forward"],
                                                    f"{prefix}feed_forward."))
    for ln in ("layer_norm1", "layer_norm2"):
        sd[f"{prefix}{ln}.weight"] = _t(block[ln]["scale"])
        sd[f"{prefix}{ln}.bias"] = _t(block[ln]["bias"])
    return sd


def patch_embedding_state_dict_from_flax(
    pe: Mapping, prefix: str = ""
) -> Dict[str, torch.Tensor]:
    """JAX ``DynamicPatchEmbed`` params → ``DynamicPatchEmbed`` state dict;
    the conv kernel goes from HWIO to OIHW."""
    return {
        f"{prefix}proj.weight":
            _t(pe["proj"]["kernel"]).permute(3, 2, 0, 1).contiguous(),
        f"{prefix}proj.bias": _t(pe["proj"]["bias"]),
        f"{prefix}cls_token": _t(pe["cls_token"]),
        f"{prefix}positional_embedding": _t(pe["positional_embedding"]),
    }


def _encoder_blocks(tree: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """``encoder_blocks_<i>`` subtrees → ``{prefix}encoder_blocks.<i>.*``;
    a scanned ``encoder_scan`` subtree → ``{prefix}encoder_scan.block.*``."""
    if "encoder_scan" in tree:
        return encoder_block_state_dict_from_flax(tree["encoder_scan"]["block"],
                                                  f"{prefix}encoder_scan.block.")
    blocks = sorted(
        (k for k in tree if str(k).startswith("encoder_blocks_")),
        key=lambda k: int(str(k).rsplit("_", 1)[1]),
    )
    sd = {}
    for i, key in enumerate(blocks):
        sd.update(encoder_block_state_dict_from_flax(
            tree[key], f"{prefix}encoder_blocks.{i}."))
    return sd


def vit_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX supervised ``ViT`` params → the port's ``ViT`` state dict (the
    reference layout of ``vit_params_to_torch``): the conv kernel from HWIO
    to OIHW, the head's kernel transposed, the blocks as
    :func:`encoder_block_state_dict_from_flax` gives them."""
    pe, head = params["patch_embedding"], params["classification_head"]
    sd = {
        "patch_embedding.conv.weight":
            _t(pe["conv"]["kernel"]).permute(3, 2, 0, 1).contiguous(),
        "patch_embedding.conv.bias": _t(pe["conv"]["bias"]),
        "patch_embedding.cls_token": _t(pe["cls_token"]),
        "patch_embedding.positional_embedding": _t(pe["positional_embedding"]),
        "classification_head.norm.weight": _t(head["norm"]["scale"]),
        "classification_head.norm.bias": _t(head["norm"]["bias"]),
        "classification_head.linear.weight": _t(head["linear"]["kernel"]).T.contiguous(),
        "classification_head.linear.bias": _t(head["linear"]["bias"]),
    }
    sd.update(_encoder_blocks(params, ""))
    return sd


def simmim_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``SimMIMViT`` params → the port's ``SimMIMViT`` state dict (the
    reference layout of ``simmim_params_to_torch``): the Dense kernels of
    ``projection`` and ``simmim_head`` transposed, the blocks as
    :func:`encoder_block_state_dict_from_flax` gives them."""
    sd = {
        "projection.weight": _t(params["projection"]["kernel"]).T.contiguous(),
        "projection.bias": _t(params["projection"]["bias"]),
        "mask_token": _t(params["mask_token"]),
        "positional_embedding": _t(params["positional_embedding"]),
        "simmim_head.weight": _t(params["simmim_head"]["kernel"]).T.contiguous(),
        "simmim_head.bias": _t(params["simmim_head"]["bias"]),
    }
    sd.update(_encoder_blocks(params, ""))
    return sd


def dino_backbone_state_dict_from_flax(
    backbone: Mapping, prefix: str = ""
) -> Dict[str, torch.Tensor]:
    """JAX ``ViTBackbone`` params → ``ViTBackbone`` state dict (keys under
    ``prefix``, e.g. ``"teacher_backbone."``)."""
    blocks = _encoder_blocks(backbone, prefix)
    sd = patch_embedding_state_dict_from_flax(backbone["patch_embedding"],
                                              f"{prefix}patch_embedding.")
    sd.update(blocks)
    return sd


def _dino_head(head: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    sd = {}
    for ours, theirs in (("mlp_0", "0"), ("mlp_2", "2"), ("mlp_4", "4")):
        sd[f"{prefix}mlp.{theirs}.weight"] = _t(head[ours]["kernel"]).T.contiguous()
        sd[f"{prefix}mlp.{theirs}.bias"] = _t(head[ours]["bias"])
    fc = head["fully_connected"]
    sd[f"{prefix}fully_connected.parametrizations.weight.original0"] = (
        _t(fc["g"]).reshape(-1, 1)
    )
    sd[f"{prefix}fully_connected.parametrizations.weight.original1"] = (
        _t(fc["v"]).T.contiguous()
    )
    sd[f"{prefix}fully_connected.bias"] = _t(fc["bias"])
    return sd


def dino_state_dict_from_flax(student: Mapping, teacher: Mapping,
                              center) -> Dict[str, torch.Tensor]:
    """JAX DINO state trees (``{"backbone", "head"}`` each, plus the center)
    → a reference ``DINOViT``-layout state dict."""
    sd = {}
    sd.update(dino_backbone_state_dict_from_flax(student["backbone"],
                                                 "student_backbone."))
    sd.update(_dino_head(student["head"], "student_head."))
    sd.update(dino_backbone_state_dict_from_flax(teacher["backbone"],
                                                 "teacher_backbone."))
    sd.update(_dino_head(teacher["head"], "teacher_head."))
    sd["center"] = _t(center)
    return sd


def backbone_state_dict(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The serving backbone out of a DINO state dict: ``teacher_backbone.*``,
    or ``student_backbone.*`` when there is no teacher, prefix stripped.
    Head and center keys are dropped."""
    for prefix in ("teacher_backbone.", "student_backbone."):
        sub = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
        if sub:
            return sub
    raise KeyError(
        "checkpoint has neither teacher_backbone.* nor student_backbone.* keys"
    )
