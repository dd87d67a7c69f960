"""Pre-LN transformer encoder block (port of ``vit_ssl_tpu/ops/encoder_block.py``).

LN → MHA → dropout → residual, LN → FFN → dropout → residual. The
LayerNorms (eps 1e-5) run in fp32 whatever the compute dtype and their
result is cast back to ``dtype`` before attention or the FFN; residual adds
stay in ``dtype``.

:func:`remat_block` runs a block under activation checkpointing
(``parallel.remat``, JAX's ``nn.remat`` around each ``EncoderBlock``):
its activations are dropped after the forward and recomputed in the
backward, with the same three dropout masks.

``num_experts`` > 0 puts a Mixture-of-Experts FFN (:class:`.moe.MoEFeedForward`,
named ``moe`` as in the JAX block) in the dense FFN's place. Where the JAX
block sows the router's loss and its dropped share into collections, this
block returns them: ``forward(..., return_aux=True)`` gives ``(x,
aux_loss, dropped_frac)``, outputs that survive :func:`remat_block` (the
recompute returns nothing to the caller, so nothing is counted twice).

Under tensor or expert parallelism (:mod:`..parallel.tensor_parallel`) the
attention and the FFN run their per-rank bodies between collectives; the
LayerNorms, the residual adds and the block's own dropout run whole and
alike on every rank of one data index. Under :func:`remat_block` the
recompute issues the forward's collectives again in the backward; every
rank recomputes the same blocks in the same order, so they meet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .attention import MultiHeadAttention
from .dropout import Dropout
from .feed_forward import FeedForwardBlock
from .moe import MoEFeedForward


class EncoderBlock(nn.Module):
    def __init__(self, d_model: int = 512, num_heads: int = 8,
                 mlp_dim: int = 3072, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.1, fast_dropout: bool = True,
                 use_fused_mlp: bool = False, use_flash: bool = True,
                 num_experts: int = 0, moe_top_k: int = 2,
                 moe_capacity_factor: float = 1.25, moe_group_size: int = 0,
                 moe_aux_weight: float = 0.01, moe_zloss_weight: float = 1e-3,
                 moe_router_noise: float = 0.0, device=None):
        super().__init__()
        self.dtype = dtype
        self.layer_norm1 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.layer_norm2 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.self_attention = MultiHeadAttention(
            d_model, num_heads, dtype=dtype, use_flash=use_flash, device=device
        )
        self.is_moe = num_experts > 0
        if self.is_moe:
            self.moe = MoEFeedForward(
                d_model, mlp_dim, num_experts, top_k=moe_top_k,
                capacity_factor=moe_capacity_factor, group_size=moe_group_size,
                aux_weight=moe_aux_weight, zloss_weight=moe_zloss_weight,
                router_noise=moe_router_noise, dropout=dropout, dtype=dtype,
                fast_dropout=fast_dropout, device=device)
        else:
            self.feed_forward = FeedForwardBlock(
                d_model, mlp_dim, dropout=dropout, dtype=dtype,
                use_fused=use_fused_mlp, fast_dropout=fast_dropout, device=device
            )
        self.drop1 = Dropout(dropout, fast_dropout)
        self.drop2 = Dropout(dropout, fast_dropout)

    def forward(self, x, block_size: int = 0, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                return_attn: bool = False, return_aux: bool = False):
        """``block_size`` > 0: block-diagonal attention over a packed
        sequence (LN, FFN and dropout are per token, so only attention
        needs it). Unless ``deterministic``, ``generator`` draws the three
        dropout masks in a fixed order: after attention, inside the FFN
        (an MoE FFN's router noise before it), after the FFN.
        ``return_attn`` also returns the attention probabilities (B, H, N,
        N), fp32; ``return_aux`` (an MoE block) the router's loss and its
        dropped share, fp32 scalars."""
        x = x.to(self.dtype)
        residual = x
        h = self.layer_norm1(x.float()).to(self.dtype)
        probs = None
        if return_attn:
            h, probs = self.self_attention(h, return_attn=True,
                                           block_size=block_size)
        else:
            h = self.self_attention(h, block_size=block_size)
        x = self.drop1(h, deterministic, generator) + residual

        residual = x
        h = self.layer_norm2(x.float()).to(self.dtype)
        aux = None
        if self.is_moe:
            h, *aux = self.moe(h, deterministic, generator)
        else:
            h = self.feed_forward(h, deterministic, generator)
        x = self.drop2(h, deterministic, generator) + residual
        if return_aux:
            if aux is None:
                raise ValueError("return_aux needs a Mixture-of-Experts block")
            return (x, *aux)
        return (x, probs) if return_attn else x


def wants_remat(block: nn.Module, x: torch.Tensor) -> bool:
    """Checkpointing pays only where a backward will run through the block:
    grad mode on, and x or one of the block's parameters needing a gradient
    (not the teacher, an eval step or serving)."""
    return torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in block.parameters()))


def remat_block(block, x, block_size: int = 0, deterministic: bool = True,
                generator: Optional[torch.Generator] = None, **kwargs):
    """``block(x, block_size, deterministic, generator, **kwargs)`` (an
    :class:`EncoderBlock`, or a callable with its signature: one layer of
    a scanned stack) under
    ``torch.utils.checkpoint`` (non-reentrant, so ``torch.autograd.grad``
    works through it), with the same output, gradients and generator stream
    as the plain call.

    The masks come from the caller's explicit generator, which
    ``preserve_rng_state`` does not replay. So the block draws from a
    generator of its own set to the caller's state before each run, the
    first forward and the recompute alike, and the caller's generator then
    takes the state the block left it in, as if the block had drawn from it.
    Generator states live on the host: nothing here waits on the card."""
    if deterministic or generator is None:
        return checkpoint(lambda inp: block(inp, block_size, True, None, **kwargs), x,
                          use_reentrant=False, preserve_rng_state=False)
    start = generator.get_state()
    own = torch.Generator(device=generator.device)

    def run(inp):
        own.set_state(start)
        return block(inp, block_size, False, own, **kwargs)

    out = checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)
    generator.set_state(own.get_state())
    return out
