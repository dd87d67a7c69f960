"""Pre-LN transformer encoder block (port of ``vit_ssl_tpu/ops/encoder_block.py``).

LN → MHA → residual, LN → FFN → residual. The LayerNorms (eps 1e-5) run in
fp32 whatever the compute dtype and their result is cast back to ``dtype``
before attention or the FFN; residual adds stay in ``dtype``. Inference
only: the reference's dropouts come with the training slice.
"""

from __future__ import annotations

import torch
from torch import nn

from .attention import MultiHeadAttention
from .feed_forward import FeedForwardBlock


class EncoderBlock(nn.Module):
    def __init__(self, d_model: int = 512, num_heads: int = 8,
                 mlp_dim: int = 3072, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.layer_norm1 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.layer_norm2 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.self_attention = MultiHeadAttention(
            d_model, num_heads, dtype=dtype, device=device
        )
        self.feed_forward = FeedForwardBlock(
            d_model, mlp_dim, dtype=dtype, device=device
        )

    def forward(self, x, block_size: int = 0):
        """``block_size`` > 0: block-diagonal attention over a packed
        sequence (LN and FFN are per token, so only attention needs it)."""
        x = x.to(self.dtype)
        residual = x
        h = self.layer_norm1(x.float()).to(self.dtype)
        x = self.self_attention(h, block_size=block_size) + residual

        residual = x
        h = self.layer_norm2(x.float()).to(self.dtype)
        return self.feed_forward(h) + residual
