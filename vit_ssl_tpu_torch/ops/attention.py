"""Multi-head self-attention (port of ``vit_ssl_tpu/ops/attention.py``).

Bias-free Q/K/V and output projections, scale 1/√d. Self-attention without
``return_attn`` runs through a hand-written kernel on the card, picked as
the JAX package picks it (``MultiHeadAttention.__call__``,
``vit_ssl_tpu/ops/attention.py:140-197``):

- a packed sequence (``block_size`` > 0), or any shape that B1 fits
  (:func:`.flash_attention.attention_nhd_feasible`):
  :func:`.flash_attention.attention_nhd` (kernel B1) on the projections'
  (B, N, H·D) layout;
- otherwise, up to N = 1024: :func:`.flash_attention.fused_attention`
  (kernel B3) on contiguous (B, H, N, D) heads;
- longer sequences: :func:`.flash_blockwise.blockwise_attention` (kernel
  B2) on contiguous (B, H, N, D) heads

(:func:`.flash_attention.attention_route`).

With ``parallel.sp`` > 1 in the published mesh, self-attention without a
block mask or ``return_attn`` runs as ring attention over the seq axis
(:mod:`..parallel.ring_attention`) when sp divides N, before any of the
above; DINO's packed locals never ring.

Under tensor parallelism (``parallel.tp``, :mod:`..parallel.tensor_parallel`)
``w_query``, ``w_key`` and ``w_value`` hold this rank's rows (its heads)
and ``final_linear`` its columns: the block runs on its local heads, the
route, the kernels and the ring take the local head count and width, and
the partial outputs are summed over the model axis. Where tp does not
divide the heads, the attention stays whole on every rank.

``return_attn`` (the attention visualizer), cross-attention and
``use_flash=False`` (the config's ``model.use_flash_attention=false``) take
the plain math of :func:`scaled_dot_product_attention` and launch no
kernel, as the JAX package sends them to XLA.
"""

from __future__ import annotations

import logging
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.tensor_parallel import axis_of, run
from .flash_attention import attention_nhd, attention_route, fused_attention
from .flash_blockwise import blockwise_attention

logger = logging.getLogger(__name__)

# (N, sp) shapes whose fallback from the ring was logged
_SP_FALLBACK_WARNED = set()


def scaled_dot_product_attention(query, key, value, return_attn: bool = False,
                                 block_size: int = 0):
    """Reference-math attention: softmax(QKᵀ/√d_k)V over (..., N, d).

    fp32 scores and softmax whatever the input dtype; the probabilities are
    cast to the value dtype before the context product, which accumulates
    in fp32. ``block_size`` > 0 applies the block-diagonal mask. Returns
    ``(context, probs)``, ``probs`` being ``None`` unless ``return_attn``."""
    d_k = query.shape[-1]
    scores = torch.matmul(query.float(), key.float().transpose(-1, -2))
    scores = scores / math.sqrt(d_k)
    if block_size:
        n_q, n_k = scores.shape[-2], scores.shape[-1]
        row = torch.arange(n_q, device=scores.device)[:, None] // block_size
        col = torch.arange(n_k, device=scores.device)[None, :] // block_size
        scores = scores.masked_fill(row != col, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    context = torch.matmul(probs.to(value.dtype).float(), value.float())
    context = context.to(value.dtype)
    return context, (probs if return_attn else None)


class MultiHeadAttention(nn.Module):
    """Multi-head self/cross attention with bias-free projections.

    Parameters are fp32 (``w_query``, ``w_key``, ``w_value``,
    ``final_linear``: the reference state-dict names); the projections run
    in ``dtype``. ``use_flash=False``: the plain attention, no kernel."""

    def __init__(self, d_model: int, num_heads: int,
                 dtype: torch.dtype = torch.float32, use_flash: bool = True,
                 device=None):
        super().__init__()
        if d_model % num_heads != 0:
            raise ValueError(
                f"d_model({d_model}) must be cleanly divisible by "
                f"num_heads({num_heads})!"
            )
        self.d_model = d_model
        self.num_heads = num_heads
        self.dtype = dtype
        self.use_flash = use_flash
        linear = lambda: nn.Linear(d_model, d_model, bias=False, device=device)  # noqa: E731
        self.w_query = linear()
        self.w_key = linear()
        self.w_value = linear()
        self.final_linear = linear()

    def forward(self, query, key: Optional[torch.Tensor] = None,
                value: Optional[torch.Tensor] = None,
                return_attn: bool = False, block_size: int = 0):
        key = query if key is None else key
        value = key if value is None else value
        weights = [layer.weight for layer in
                   (self.w_query, self.w_key, self.w_value, self.final_linear)]
        axis = axis_of(self.w_query)
        if axis is None:
            return self._heads(query, key, value, *weights, return_attn, block_size)
        if return_attn:
            raise ValueError("return_attn needs the whole attention: a tensor-parallel "
                             "block holds only its local heads")
        self_attn = key is query and value is query

        def body(*args):
            *xs, wq, wk, wv, wo, _rank, _size = args
            q, k, v = xs * 3 if self_attn else xs
            return self._heads(q, k, v, wq, wk, wv, wo, False, block_size)

        return run(axis, body, (query,) if self_attn else (query, key, value),
                   weights, (0, 0, 0, 1))

    def _heads(self, query, key, value, wq, wk, wv, wo, return_attn: bool,
               block_size: int):
        """The attention of the heads that the projections ``wq``, ``wk``,
        ``wv`` (rows) and ``wo`` (columns) hold: all of them, or under
        tensor parallelism this rank's (its output then a partial sum)."""
        b, n_q, _ = query.shape
        n_k = key.shape[1]
        d_head = self.d_model // self.num_heads
        num_heads = wq.shape[0] // d_head
        width = num_heads * d_head
        scale = 1.0 / float(d_head) ** 0.5

        def proj(x, w):
            return F.linear(x.to(self.dtype), w.to(self.dtype))

        def heads(x, n):  # (B, N, H·D) -> (B, H, N, D)
            return x.reshape(b, n, num_heads, d_head).transpose(1, 2)

        ring = None
        if not return_attn and not block_size and n_q == n_k:
            ring = self._ring_group(n_q)

        if ring is None and self.use_flash and not return_attn and n_q == n_k:
            xq, xk, xv = proj(query, wq), proj(key, wk), proj(value, wv)
            route = attention_route(b, n_q, num_heads, width, self.dtype.itemsize,
                                    block_size)
            if route == "B1":
                context = attention_nhd(xq, xk, xv, num_heads, scale, block_size)
            else:
                kernel = fused_attention if route == "B3" else blockwise_attention
                context = kernel(
                    *(heads(x, n_q).contiguous() for x in (xq, xk, xv)), scale)
                context = context.transpose(1, 2).reshape(b, n_q, width)
            return proj(context, wo)

        q = heads(proj(query, wq), n_q)
        k = heads(proj(key, wk), n_k)
        v = heads(proj(value, wv), n_k)
        if ring is not None:
            from ..parallel.ring_attention import ring_attention

            context, probs = ring_attention(
                q.contiguous(), k.contiguous(), v.contiguous(), scale, ring,
                plain=not self.use_flash), None
        else:
            context, probs = scaled_dot_product_attention(
                q, k, v, return_attn, block_size=block_size
            )
        context = context.transpose(1, 2).reshape(b, n_q, width)
        out = proj(context, wo)
        if return_attn:
            return out, probs
        return out

    @staticmethod
    def _ring_group(n: int):
        """Sequence parallelism (``parallel.sp``, JAX
        ``MultiHeadAttention._maybe_ring_attention``): the seq axis's group
        when the published mesh has one whose size divides N, for the ring
        (:func:`..parallel.ring_attention.ring_attention`: B2 at every hop
        on the card, its plain versions with ``use_flash=False`` or on the
        CPU), whose output is all-gathered along the sequence. None (the
        single-device paths) when sp is off or inside a pipeline stage
        (:func:`..parallel.context.pipeline_stage`; the trainer warns once);
        an sp that does not divide N falls back with one logged warning per
        shape."""
        from ..parallel import context
        from ..parallel.mesh import SEQ_AXIS

        sp = context.sp_size()
        if sp <= 1 or context.in_pipeline_stage():
            return None
        if n % sp:
            if (n, sp) not in _SP_FALLBACK_WARNED:
                _SP_FALLBACK_WARNED.add((n, sp))
                logger.warning(
                    "parallel.sp=%d does not divide sequence length %d: this "
                    "attention call falls back to the single-device path "
                    "(replicated over the seq axis)", sp, n)
            return None
        group = context.axis_group(SEQ_AXIS)
        if group is None:
            raise RuntimeError(f"parallel.sp={sp} in the published mesh, but no process "
                               "group: start the ranks with torch.distributed.run")
        return group
