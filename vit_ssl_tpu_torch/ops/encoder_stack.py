"""Scanned (layer-stacked) encoder (port of ``vit_ssl_tpu/ops/encoder_stack.py``).

With ``model.scan_layers=true`` the N encoder blocks become one
:class:`~.encoder_block.EncoderBlock` body whose parameters are stacked on
a leading layer dimension: ``encoder_scan.block.<block's name>``, e.g.
``encoder_scan.block.self_attention.w_query.weight`` of shape (N, D, D).
:class:`ScannedEncoder` runs the body over them layer by layer
(``torch.func.functional_call`` on each layer's slice), under
:func:`~.encoder_block.remat_block` per layer with ``remat``.

Unlike the JAX module, whose ``nn.scan`` folds the dropout key per layer,
the port's layers draw their masks from the caller's generator in the
unrolled stack's order, and :func:`~.initializers.init_` draws the layers
in the unrolled order too: from the same weights (or the same init
generator) a scanned and an unrolled model train bit-equal. Per-layer
attention maps (``return_attn``) need the unrolled stack, as in JAX.

The converters work on flat state dicts in the port's key space (numpy
arrays or tensors), under any prefix (DINO's ``teacher.`` and
``backbone.``): ``{pre}encoder_blocks.{i}.{rest}`` ↔
``{pre}encoder_scan.block.{rest}``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from .encoder_block import EncoderBlock, remat_block
from .initializers import init_

SCAN_MODULE = "encoder_scan"
_SCANNED_MARK = f"{SCAN_MODULE}.block."
# anchored to a key-component boundary: the prefix is empty or ends in '.',
# so "my_encoder_blocks.0.x" is not a block
_UNROLLED_RE = re.compile(r"^((?:[^.]+\.)*)encoder_blocks\.(\d+)\.(.+)$")


class ScannedEncoder(nn.Module):
    """``num_blocks`` identical encoder blocks, their parameters stacked:
    ``block`` is one :class:`EncoderBlock` whose every parameter has a
    leading layer dimension. ``stacked_layers`` tells
    :func:`~.initializers.init_` to draw it layer by layer."""

    def __init__(self, num_blocks: int, block_kwargs: Dict[str, Any], device=None):
        super().__init__()
        self.stacked_layers = int(num_blocks)
        self.block = EncoderBlock(**block_kwargs, device=device)
        for module in self.block.modules():
            for name, p in list(module._parameters.items()):
                if p is not None:
                    module._parameters[name] = nn.Parameter(
                        p.new_empty((self.stacked_layers, *p.shape)))
        init_(self, "reference")

    def forward(self, x, block_size: int = 0, deterministic: bool = True,
                generator: Optional[torch.Generator] = None, remat: bool = False):
        """The layers in order over (B, N, D) tokens; with ``remat`` each
        layer that a backward runs through is checkpointed."""
        named = list(self.block.named_parameters())
        slices = [p.unbind(0) for _, p in named]
        wants = remat and torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for _, p in named))
        for i in range(self.stacked_layers):
            params = {name: s[i] for (name, _), s in zip(named, slices)}

            def layer(inp, bs, det, gen, params=params):
                return functional_call(self.block, params, (inp, bs, det, gen))

            if wants:
                x = remat_block(layer, x, block_size, deterministic, generator)
            else:
                x = layer(x, block_size, deterministic, generator)
        return x


def refuse_return_attn() -> None:
    raise ValueError("return_attn requires the unrolled encoder stack: set "
                     "model.scan_layers=false (checkpoints convert between the "
                     "layouts through models.builder.load_weights)")


# ---------------------------------------------------------------------------
# Layout converters (flat state dicts, prefix-aware)


def _stack(values):
    if isinstance(values[0], torch.Tensor):
        return torch.stack(list(values))
    return np.stack([np.asarray(v) for v in values])


def flat_has_scanned(flat: Dict[str, Any]) -> bool:
    return any(_SCANNED_MARK in k for k in flat)


def flat_has_unrolled(flat: Dict[str, Any]) -> bool:
    return any(_UNROLLED_RE.match(k) for k in flat)


def flat_to_scanned(flat: Dict[str, Any]) -> Dict[str, Any]:
    """``{pre}encoder_blocks.{i}.{rest}`` → ``{pre}encoder_scan.block.{rest}``,
    the blocks' entries stacked on a new leading layer dimension; indices
    must run 0, 1, … under each prefix."""
    groups: Dict[tuple, Dict[int, Any]] = {}
    out: Dict[str, Any] = {}
    for k, v in flat.items():
        m = _UNROLLED_RE.match(k)
        if m:
            groups.setdefault((m.group(1), m.group(3)), {})[int(m.group(2))] = v
        else:
            out[k] = v
    for (pre, rest), by_i in groups.items():
        idxs = sorted(by_i)
        if idxs != list(range(len(idxs))):
            raise ValueError(f"non-contiguous encoder block indices under '{pre}': {idxs}")
        out[f"{pre}{_SCANNED_MARK}{rest}"] = _stack([by_i[i] for i in idxs])
    return out


def flat_to_unrolled(flat: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`flat_to_scanned`; the layer count is each
    stacked entry's leading dimension. Tensors come out as copies, not
    views of the stack."""
    out: Dict[str, Any] = {}
    for k, v in flat.items():
        if _SCANNED_MARK in k:
            pre, rest = k.split(_SCANNED_MARK, 1)
            for i in range(v.shape[0]):
                layer = v[i]
                out[f"{pre}encoder_blocks.{i}.{rest}"] = (
                    layer.clone() if isinstance(layer, torch.Tensor) else np.asarray(layer))
        else:
            out[k] = v
    return out


def _tree_map(fn, tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _first_leaf(tree):
    while isinstance(tree, dict) or hasattr(tree, "items"):
        tree = next(iter(tree.values()))
    return tree


def unroll_scanned_tree(params: Dict[str, Any]) -> Dict[str, Any]:
    """A JAX-layout parameter tree (nested dicts) with an ``encoder_scan``
    subtree → the same tree with ``encoder_blocks_{i}`` subtrees (numpy
    leaves) in its place; other keys pass through."""
    if SCAN_MODULE not in params:
        return params
    out = {k: v for k, v in dict(params).items() if k != SCAN_MODULE}
    stacked = params[SCAN_MODULE]["block"]
    num_blocks = int(np.asarray(_first_leaf(stacked)).shape[0])
    for i in range(num_blocks):
        out[f"encoder_blocks_{i}"] = _tree_map(lambda x, i=i: np.asarray(x)[i], stacked)
    return out
