"""Transformer feed-forward block (port of ``vit_ssl_tpu/ops/feed_forward.py``).

Linear(d_model→d_ff) → exact (erf) GELU → Linear(d_ff→d_model), computed in
``dtype`` with fp32 parameters named as in the reference state dict
(``linear_in``, ``linear_out``). The JAX package evaluates erf with the
Abramowitz–Stegun polynomial (|error| ≤ 1.5e-7, ``ops/fused_mlp.py:40``);
here it is PyTorch's own erf. Inference only: dropout comes with the
training slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class FeedForwardBlock(nn.Module):
    def __init__(self, d_model: int = 512, d_ff: int = 2048,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.linear_in = nn.Linear(d_model, d_ff, device=device)
        self.linear_out = nn.Linear(d_ff, d_model, device=device)

    def forward(self, x):
        dt = self.dtype
        h = F.linear(x.to(dt), self.linear_in.weight.to(dt),
                     self.linear_in.bias.to(dt))
        h = F.gelu(h)
        return F.linear(h, self.linear_out.weight.to(dt),
                        self.linear_out.bias.to(dt))
