"""Pre-LN transformer encoder block (port of ``vit_ssl_tpu/ops/encoder_block.py``).

LN → MHA → dropout → residual, LN → FFN → dropout → residual. The
LayerNorms (eps 1e-5) run in fp32 whatever the compute dtype and their
result is cast back to ``dtype`` before attention or the FFN; residual adds
stay in ``dtype``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .attention import MultiHeadAttention
from .dropout import Dropout
from .feed_forward import FeedForwardBlock


class EncoderBlock(nn.Module):
    def __init__(self, d_model: int = 512, num_heads: int = 8,
                 mlp_dim: int = 3072, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.1, fast_dropout: bool = True,
                 use_fused_mlp: bool = False, use_flash: bool = True, device=None):
        super().__init__()
        self.dtype = dtype
        self.layer_norm1 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.layer_norm2 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.self_attention = MultiHeadAttention(
            d_model, num_heads, dtype=dtype, use_flash=use_flash, device=device
        )
        self.feed_forward = FeedForwardBlock(
            d_model, mlp_dim, dropout=dropout, dtype=dtype,
            use_fused=use_fused_mlp, fast_dropout=fast_dropout, device=device
        )
        self.drop1 = Dropout(dropout, fast_dropout)
        self.drop2 = Dropout(dropout, fast_dropout)

    def forward(self, x, block_size: int = 0, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                return_attn: bool = False):
        """``block_size`` > 0: block-diagonal attention over a packed
        sequence (LN, FFN and dropout are per token, so only attention
        needs it). Unless ``deterministic``, ``generator`` draws the three
        dropout masks in a fixed order: after attention, inside the FFN,
        after the FFN. ``return_attn`` also returns the attention
        probabilities (B, H, N, N), fp32."""
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
        h = self.feed_forward(h, deterministic, generator)
        x = self.drop2(h, deterministic, generator) + residual
        return (x, probs) if return_attn else x
