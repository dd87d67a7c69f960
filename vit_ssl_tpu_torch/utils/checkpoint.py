"""Checkpoints of the port: train-state directories and reference-layout
``.pth`` files.

:func:`save_checkpoint` writes what the trainer saves each epoch
(``best_model``, ``last_model``), after ``vit_ssl_tpu/utils/checkpoint.py``:
a directory written as ``<path>.tmp`` and swapped in with ``os.replace``,
holding ``metadata.json`` (epoch, the embedded config, the mode, ``best_*``)
and the state's tensors in one ``torch.save`` file (``state.pt``) where the
JAX package has an orbax tree (``tree/``). :func:`load_checkpoint` reads
either: a JAX directory's tree through the port's own orbax reader
(:mod:`.orbax_tree`: OCDBT, zarr, zstd) and :func:`train_state_from_flax`,
which maps the JAX trainer's state (step, params, optax's state, teacher,
center) to the port's, so a JAX run's ``last_model`` resumes in the port.

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
_TREE_DIR = "tree"


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
    """(tree, metadata) of a checkpoint directory, the tensors on the CPU:
    the port's (``state.pt``) as :func:`save_checkpoint` wrote it, or the
    JAX package's (an orbax ``tree/``) in the port's layout
    (:func:`train_state_from_flax`; the optimizer's buffers by parameter
    name, which the trainer puts in its own order)."""
    state_file = os.path.join(path, _STATE_FILE)
    tree_dir = os.path.join(path, _TREE_DIR)
    meta_file = os.path.join(path, _META_FILE)
    if not os.path.exists(meta_file):
        raise FileNotFoundError(f"{path} holds no {_META_FILE}: not a checkpoint directory")
    with open(meta_file) as f:
        metadata = json.load(f)
    if os.path.exists(state_file):
        tree = torch.load(state_file, map_location="cpu", weights_only=True)
    elif os.path.isdir(tree_dir):
        from .orbax_tree import read_tree

        tree = train_state_from_flax(read_tree(tree_dir), metadata)
    else:
        raise FileNotFoundError(
            f"{path} holds neither {_STATE_FILE} (a checkpoint of the port) nor "
            f"{_TREE_DIR}/ (an orbax tree of the JAX package)")
    return tree, metadata


def checkpoint_exists(path: str) -> bool:
    """Whether ``path`` is a checkpoint directory (of either package): it
    holds ``metadata.json``; :func:`load_checkpoint` names what else is
    missing."""
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
    if isinstance(x, torch.Tensor):  # a bfloat16 leaf of the orbax reader
        return x.float().contiguous()
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


# ---------------------------------------------------------------------------
# DINO's parameter layout back to the JAX package's tree (the inverse of
# the bridge above, for :func:`train_state_to_flax`): Dense kernels
# transposed back, the conv kernel OIHW to HWIO, the weight norm's g
# flattened.


def _n(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _kernel_n(x) -> np.ndarray:
    """torch's (..., out, in) → a flax Dense kernel (..., in, out)."""
    return np.swapaxes(_n(x), -1, -2)


def _encoder_block_to_flax(sd: Mapping, prefix: str) -> Dict[str, Any]:
    ff = f"{prefix}feed_forward."
    block: Dict[str, Any] = {
        "self_attention": {
            name: {"kernel": _kernel_n(sd[f"{prefix}self_attention.{name}.weight"])}
            for name in ("w_query", "w_key", "w_value", "final_linear")},
        "feed_forward": {"w1": _kernel_n(sd[ff + "linear_in.weight"]),
                         "b1": _n(sd[ff + "linear_in.bias"]),
                         "w2": _kernel_n(sd[ff + "linear_out.weight"]),
                         "b2": _n(sd[ff + "linear_out.bias"])}}
    for ln in ("layer_norm1", "layer_norm2"):
        block[ln] = {"scale": _n(sd[f"{prefix}{ln}.weight"]),
                     "bias": _n(sd[f"{prefix}{ln}.bias"])}
    return block


def dino_network_state_dict_to_flax(sd: Mapping) -> Dict[str, Any]:
    """A ``DINONetwork`` state dict (``backbone.*``, ``head.*``; unrolled
    blocks with a dense feed-forward) → the JAX ``{"backbone", "head"}``
    tree."""
    pe = "backbone.patch_embedding."
    backbone: Dict[str, Any] = {"patch_embedding": {
        "proj": {"kernel": _n(sd[pe + "proj.weight"]).transpose(2, 3, 1, 0),
                 "bias": _n(sd[pe + "proj.bias"])},
        "cls_token": _n(sd[pe + "cls_token"]),
        "positional_embedding": _n(sd[pe + "positional_embedding"])}}
    blocks = "backbone.encoder_blocks."
    count = 1 + max((int(k[len(blocks):].split(".", 1)[0]) for k in sd
                     if k.startswith(blocks)), default=-1)
    backbone.update({f"encoder_blocks_{i}": _encoder_block_to_flax(sd, f"{blocks}{i}.")
                     for i in range(count)})
    head: Dict[str, Any] = {
        ours: {"kernel": _kernel_n(sd[f"head.mlp.{theirs}.weight"]),
               "bias": _n(sd[f"head.mlp.{theirs}.bias"])}
        for ours, theirs in (("mlp_0", "0"), ("mlp_2", "2"), ("mlp_4", "4"))}
    fc = "head.fully_connected."
    head["fully_connected"] = {
        "g": _n(sd[fc + "parametrizations.weight.original0"]).reshape(-1),
        "v": _kernel_n(sd[fc + "parametrizations.weight.original1"]),
        "bias": _n(sd[fc + "bias"])}
    return {"backbone": backbone, "head": head}


def _dino_network_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    sd = dino_backbone_state_dict_from_flax(params["backbone"], "backbone.")
    sd.update(_dino_head(params["head"], "head."))
    return sd


# ---------------------------------------------------------------------------
# The JAX trainers' train state (``vit_ssl_tpu/train/trainers/base.py::
# _state_tree``: step, params, opt_state, teacher_params, center) ↔ the
# port's (``train/state.py``: ``TrainState.state_dict`` for DINO,
# ``SupervisedTrainState.state_dict`` for supervised, finetune and SimMIM).

# each optimizer's optax chain, one entry a transformation: the fields of its
# state, or None for an empty state (``vit_ssl_tpu/train/state.py``: AdamW is
# scale_by_adam, add_decayed_weights, the schedule; Adam has no decay; SGD is
# trace, the schedule; RMSprop is scale_by_rms, the schedule, trace). JAX
# passes momentum 0.0, not None, so SGD and RMSprop keep a trace even then
# (unused at momentum 0: the port keeps none).
_CHAINS = {"AdamW": (("count", "mu", "nu"), None, ("count",)),
           "Adam": (("count", "mu", "nu"), ("count",)),
           "SGD": (("trace",), ("count",)),
           "RMSprop": (("nu",), ("count",), ("trace",))}


def _optimizer(metadata: Mapping) -> Tuple[str, bool]:
    """(the optimizer's name, whether it keeps a momentum trace) of a
    checkpoint's embedded config."""
    opt = metadata["config"]["training"]["optimizer"]
    params = opt.get("params", {}) or {}
    return opt["name"], bool(float(params.get("momentum", 0.0) or 0.0))


def _signature(chain) -> tuple:
    return tuple(None if s is None else tuple(sorted(s)) for s in chain)


def _fill(params, moments):
    """(moments with each absent leaf, optax's MaskedNode, as zeros; ones
    where a moment is, zeros where it is not), both shaped as ``params``."""
    if isinstance(params, Mapping):
        pairs = {k: _fill(params[k], None if moments is None else moments.get(k))
                 for k in params}
        return ({k: a for k, (a, _) in pairs.items()}, {k: b for k, (_, b) in pairs.items()})
    p = np.asarray(params, np.float32)
    if moments is None:
        return np.zeros_like(p), np.zeros_like(p)
    return moments, np.ones_like(p)


def _moments_from_flax(moments, params, bridge) -> Dict[str, torch.Tensor]:
    """One moment tree (optax's, shaped as ``params``) → the port's tensors by
    parameter name; a frozen leaf's MaskedNode has none."""
    filled, present = _fill(params, moments)
    values, mask = bridge(filled), bridge(present)
    return {name: v for name, v in values.items() if bool(mask[name].all())}


def _chain_of(opt_state, leaf: str) -> list:
    """The optax chain's states: under ``multi_transform`` (finetune's
    ``freeze_backbone``) the "train" partition's, the "freeze" one empty."""
    if isinstance(opt_state, Mapping) and "inner_states" in opt_state:
        inner = opt_state["inner_states"]
        if set(inner) != {"train", "freeze"} or inner["freeze"].get("inner_state") is not None:
            raise ValueError(f"{leaf}: a multi_transform state with partitions "
                             f"{sorted(inner)}, expected an empty 'freeze' and 'train'")
        return list(inner["train"]["inner_state"])
    if not isinstance(opt_state, (list, tuple)):
        raise ValueError(f"{leaf}: an optax chain's states expected, got {type(opt_state)}")
    return list(opt_state)


def _model_bridge(tree: Mapping):
    """The bridge of the tree's model, and the port's state key for it."""
    if "teacher_params" in tree:
        return _dino_network_from_flax, "student"
    params = tree["params"]
    if "classification_head" in params:
        return vit_state_dict_from_flax, "model"
    if "simmim_head" in params:
        return simmim_state_dict_from_flax, "model"
    raise ValueError("JAX train state of no known model: params hold "
                     f"{sorted(params)} and there are no teacher_params")


def train_state_from_flax(tree: Mapping, metadata: Mapping) -> Dict[str, Any]:
    """A JAX trainer's restored orbax tree (:func:`..orbax_tree.read_tree`)
    and its ``metadata.json`` → the port's train state: ``step``;
    ``student``, ``teacher`` and ``center`` (DINO) or ``model`` (supervised,
    finetune, SimMIM), in the reference layouts the bridge gives; and
    ``opt_state``: ``count`` and the optimizer's buffers (``mu``/``nu``,
    ``trace``, ``nu``/``trace``), each moment transformed as its parameter
    is. The buffers are dicts by parameter name (a frozen parameter has
    none); the trainer puts them in its optimizer's order
    (``train/state.py::buffers_in_order``).

    Raises when optax's counts disagree or the state's optimizer is not
    the one ``metadata["config"]`` names."""
    bridge, key = _model_bridge(tree)
    state: Dict[str, Any] = {"step": int(np.asarray(tree["step"]))}
    params = tree["params"]
    if key == "student":
        state["student"] = bridge(params)
        state["teacher"] = bridge(tree["teacher_params"])
        state["center"] = _t(tree["center"]).reshape(1, -1)
    else:
        state["model"] = bridge(params)

    name, momentum = _optimizer(metadata)
    if name not in _CHAINS:
        raise ValueError(f"config names optimizer {name!r}; the JAX states read are "
                         f"{sorted(_CHAINS)}")
    chain = _chain_of(tree["opt_state"], "opt_state")
    got, want = _signature(chain), _CHAINS[name]
    if name == "SGD" and not momentum and got == (None, ("count",)):
        want = got  # optax.sgd(momentum=None): no trace
    if got != want:
        raise ValueError(f"the checkpoint's optimizer state is the optax chain {got}, "
                         f"but its config names {name} (chain {want})")
    counts = {f"opt_state[{i}].count": int(np.asarray(s["count"]))
              for i, s in enumerate(chain) if s is not None and "count" in s}
    if len(set(counts.values())) > 1:
        raise ValueError(f"optax's counts disagree: {counts}")
    buffers = {}
    for s in chain:
        for field in ("mu", "nu", "trace"):
            if s is not None and field in s and (field != "trace" or momentum):
                buffers[field] = _moments_from_flax(s[field], params, bridge)
    state["opt_state"] = {"count": next(iter(counts.values()), state["step"]), **buffers}
    return state


def train_state_to_flax(state: Mapping, metadata: Mapping) -> Dict[str, Any]:
    """The inverse of :func:`train_state_from_flax` for DINO under AdamW
    (``configs/dino.yaml``): the port's train state (its ``state_dict()``,
    every student parameter trained, the buffers lists in the student's
    order) → the tree the JAX DINO trainer saves (``step``, ``params``,
    ``opt_state``, ``teacher_params``, ``center``), in numpy, for
    :func:`..orbax_tree.write_tree`. Other models and optimizers are
    refused by name."""
    if "student" not in state:
        raise ValueError("train_state_to_flax writes DINO train states only; this one "
                         f"holds {sorted(state)}")
    name, _ = _optimizer(metadata)
    if name != "AdamW":
        raise ValueError(f"train_state_to_flax writes AdamW's optax state only; the "
                         f"config names {name!r}")
    student = state["student"]
    opt = state["opt_state"]
    count = np.asarray(int(opt["count"]), np.int32)

    def moments(field):
        if len(opt[field]) != len(student):
            raise ValueError(f"{field}: {len(opt[field])} buffers for {len(student)} "
                             "student parameters (every one is trained under DINO)")
        return dino_network_state_dict_to_flax(dict(zip(student, opt[field])))

    return {"step": np.asarray(int(state["step"]), np.int32),
            "params": dino_network_state_dict_to_flax(student),
            "opt_state": [{"count": count, "mu": moments("mu"), "nu": moments("nu")},
                          None, {"count": count}],
            "teacher_params": dino_network_state_dict_to_flax(state["teacher"]),
            "center": _n(state["center"]).reshape(1, -1)}
