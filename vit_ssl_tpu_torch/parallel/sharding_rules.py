"""Tensor- and expert-parallel sharding rules (port of
``vit_ssl_tpu/parallel/sharding_rules.py``): ``tp_spec_for`` and
``_fitted_spec`` written over the port's state-dict names.

A spec is a tuple of mesh axis names (or None), one per dimension of the
port's tensor. JAX's Dense kernels are ``(in, out)`` and the port's
``nn.Linear`` weights ``(out, in)``, so JAX's column-parallel
``P(None, 'model')`` shards the port's dim 0 and its row-parallel
``P('model', None)`` dim 1; the MoE tensors keep JAX's layout and its
specs. Layout per module (port name → spec):

- FFN: ``linear_in.{weight,bias}`` → ('model', …); ``linear_out.weight``
  → (None, 'model'); ``linear_out.bias`` replicated.
- Attention: ``w_query``, ``w_key``, ``w_value`` → ('model', None),
  ``final_linear`` → (None, 'model'), only where the axis divides the head
  count (JAX's condition at ``vit_ssl_tpu/ops/attention.py:252-254``):
  otherwise the block's attention stays replicated, with one warning.
- MoE: ``w1`` (E, d, f) → ('expert', None, 'model'), ``b1`` → ('expert',
  'model'), ``w2`` (E, f, d) → ('expert', 'model', None), ``b2`` →
  ('expert', None); the router replicated.
- DINO head: ``mlp.0`` and ``mlp.4`` column-parallel (weight and bias),
  ``mlp.2.weight`` row-parallel; ``fully_connected`` (weight norm) over its
  output dim K: ``original0``, ``original1`` and ``bias``.
- Classification head: ``linear`` column-parallel; JAX's rule names every
  ``bias`` under ``classification_head``, so the LayerNorm's bias
  (``classification_head.norm.bias``) is sharded too.
- SimMIM's ``simmim_head``: column-parallel.
- Everything else (patch embedding, LayerNorms, tokens, positional
  embeddings, the router): replicated.

:func:`fitted_spec` keeps JAX's two loud fallbacks: a dimension that the
axis does not divide stays replicated, with a warning, and a matmul weight
that no rule matches logs a warning. An axis that the mesh does not have
(size 1) leaves its dimensions whole, so one table serves tp, ep and both.
"""

from __future__ import annotations

import logging
from typing import Dict, Mapping, Optional, Sequence, Tuple

from .mesh import EXPERT_AXIS, MODEL_AXIS

logger = logging.getLogger(__name__)

Spec = Tuple[Optional[str], ...]

# parameter names that are replicated by design: no warning when one of
# their matmul weights falls through to replicated
KNOWN_REPLICATED = ("patch_embedding", "projection", "layer_norm", "norm",
                    "cls_token", "positional_embedding", "mask_token")
# the leaf names of the port's matmul weights (JAX: kernel, v, w1, w2)
_MATMUL_LEAVES = ("weight", "original1", "w1", "w2")
_COLUMN = (MODEL_AXIS, None)
_ROW = (None, MODEL_AXIS)

# (attention heads, axis size) pairs already warned about
_HEADS_WARNED = set()


def tp_spec_for(name: str) -> Spec:
    """The spec of the port's parameter ``name`` (a ``state_dict`` key, any
    prefix), before it is fitted to a mesh."""
    parts = name.split(".")
    leaf = parts[-1]
    if "moe" in parts:
        return {"w1": (EXPERT_AXIS, None, MODEL_AXIS), "b1": (EXPERT_AXIS, MODEL_AXIS),
                "w2": (EXPERT_AXIS, MODEL_AXIS, None), "b2": (EXPERT_AXIS, None)
                }.get(leaf, ())
    if "self_attention" in parts and leaf == "weight":
        return _ROW if "final_linear" in parts else _COLUMN
    if "linear_in" in parts:
        return _COLUMN if leaf == "weight" else (MODEL_AXIS,)
    if "linear_out" in parts:
        return _ROW if leaf == "weight" else ()
    if "mlp" in parts:
        layer = parts[parts.index("mlp") + 1]
        if layer in ("0", "4"):
            return _COLUMN if leaf == "weight" else (MODEL_AXIS,)
        if layer == "2" and leaf == "weight":
            return _ROW
        return ()
    if "fully_connected" in parts:
        return {"original0": _COLUMN, "original1": _COLUMN,
                "bias": (MODEL_AXIS,)}.get(leaf, ())
    if "classification_head" in parts:
        if leaf == "weight" and "linear" in parts:
            return _COLUMN
        return (MODEL_AXIS,) if leaf == "bias" else ()
    if "simmim_head" in parts:
        return _COLUMN if leaf == "weight" else (MODEL_AXIS,)
    return ()


def fitted_spec(name: str, shape: Sequence[int], sizes: Mapping[str, int],
                num_heads: Optional[int] = None) -> Spec:
    """:func:`tp_spec_for` fitted to a mesh of axis ``sizes``: one entry per
    dimension of ``shape``, an axis the mesh lacks (or of size 1) or does
    not divide dropped (the latter with a warning). ``num_heads``: the head
    count of the attention module that owns an attention weight; an axis
    that does not divide it leaves that weight replicated."""
    spec = tp_spec_for(name)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    fixed = []
    for dim, axis in zip(shape, spec):
        if axis is not None and int(sizes.get(axis, 1)) <= 1:
            axis = None
        if axis is not None and int(dim) % int(sizes[axis]) != 0:
            logger.warning(
                "TP rule for '%s' wants axis %r on a dim of %d, which does not "
                "divide mesh axis size %d: falling back to replicated for that "
                "dim", name, axis, dim, sizes[axis])
            axis = None
        fixed.append(axis)
    parts = name.split(".")
    if num_heads is not None and "self_attention" in parts and any(fixed):
        tp = int(sizes[MODEL_AXIS])
        if num_heads % tp:
            if (num_heads, tp) not in _HEADS_WARNED:
                _HEADS_WARNED.add((num_heads, tp))
                logger.warning(
                    "parallel.tp=%d does not divide the %d attention heads: the "
                    "attention projections stay replicated over the model axis",
                    tp, num_heads)
            return (None,) * len(shape)
    if (int(sizes.get(MODEL_AXIS, 1)) > 1 and not any(fixed)
            and len(shape) >= 2 and parts[-1] in _MATMUL_LEAVES
            and not any(marker in name for marker in KNOWN_REPLICATED)):
        logger.warning(
            "No TP rule matched matmul parameter '%s' %s: it will be fully "
            "replicated. If this module was renamed, update "
            "parallel/sharding_rules.py::tp_spec_for.", name, tuple(shape))
    return tuple(fixed)


def sharded_dims(spec: Spec) -> Tuple[Tuple[int, str], ...]:
    """The (dimension, axis) pairs of ``spec`` that shard."""
    return tuple((d, axis) for d, axis in enumerate(spec) if axis is not None)


def spec_table(named_shapes: Mapping[str, Sequence[int]], sizes: Mapping[str, int],
               heads: Mapping[str, int] = ()) -> Dict[str, Spec]:
    """:func:`fitted_spec` of every (name, shape); ``heads`` maps an
    attention module's prefix (``...self_attention``) to its head count."""
    heads = dict(heads)
    out = {}
    for name, shape in named_shapes.items():
        prefix = name.rsplit(".", 2)[0] if "self_attention" in name.split(".") else None
        out[name] = fitted_spec(name, shape, sizes, heads.get(prefix))
    return out
