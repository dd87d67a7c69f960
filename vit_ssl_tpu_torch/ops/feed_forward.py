"""Transformer feed-forward block (port of ``vit_ssl_tpu/ops/feed_forward.py``).

Linear(d_model→d_ff) → exact (erf) GELU → dropout → Linear(d_ff→d_model),
computed in ``dtype`` with fp32 parameters named as in the reference state
dict (``linear_in``, ``linear_out``). The JAX package evaluates erf with the
Abramowitz–Stegun polynomial (|error| ≤ 1.5e-7, ``ops/fused_mlp.py:40``);
here it is PyTorch's own erf. Dropout is ``dropout16``
(:mod:`.dropout`), drawn from the caller's generator.

The JAX package's fused-MLP Pallas kernel (B4, ``use_fused_mlp=true``) is
not ported yet: asking for it raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .dropout import Dropout


class FeedForwardBlock(nn.Module):
    def __init__(self, d_model: int = 512, d_ff: int = 2048,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32,
                 use_fused: bool = False, fast_dropout: bool = True,
                 device=None):
        super().__init__()
        if use_fused:
            raise NotImplementedError(
                "use_fused_mlp=true needs kernel B4 (fused MLP), which is not "
                "ported yet; see ROADMAP.md queue B"
            )
        self.dtype = dtype
        self.linear_in = nn.Linear(d_model, d_ff, device=device)
        self.linear_out = nn.Linear(d_ff, d_model, device=device)
        self.dropout = Dropout(dropout, fast_dropout)

    def forward(self, x, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        dt = self.dtype
        h = F.linear(x.to(dt), self.linear_in.weight.to(dt),
                     self.linear_in.bias.to(dt))
        h = self.dropout(F.gelu(h), deterministic, generator)
        return F.linear(h, self.linear_out.weight.to(dt),
                        self.linear_out.bias.to(dt))
