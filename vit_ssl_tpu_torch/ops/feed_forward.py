"""Transformer feed-forward block (port of ``vit_ssl_tpu/ops/feed_forward.py``).

Linear(d_model→d_ff) → exact (erf) GELU → dropout → Linear(d_ff→d_model),
computed in ``dtype`` with fp32 parameters named as in the reference state
dict (``linear_in``, ``linear_out``). The JAX package evaluates erf with the
Abramowitz–Stegun polynomial (|error| ≤ 1.5e-7, ``ops/fused_mlp.py:40``);
here it is PyTorch's own erf. Dropout is ``dropout16``, or with
``fast_dropout=False`` the Bernoulli rule (:mod:`.dropout`), drawn from the
caller's generator.

``use_fused`` (the config's ``model.use_fused_mlp``) runs the whole block
as kernel B4 (:func:`.fused_mlp.fused_mlp`) on the same parameters. Both
paths draw the keep-mask by the same rule (``fast_dropout``), with the same
number of draws at the same point of the generator's stream, so from one
generator state they drop the same units; they round at different places (the fused path keeps GELU's output
in fp32 through the dropout scale, as the JAX kernel does).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .dropout import Dropout, keep_mask
from .fused_mlp import fused_mlp


class FeedForwardBlock(nn.Module):
    def __init__(self, d_model: int = 512, d_ff: int = 2048,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32,
                 use_fused: bool = False, fast_dropout: bool = True,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.use_fused = use_fused
        self.linear_in = nn.Linear(d_model, d_ff, device=device)
        self.linear_out = nn.Linear(d_ff, d_model, device=device)
        self.dropout = Dropout(dropout, fast_dropout)

    def forward(self, x, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        dt = self.dtype
        w1, b1 = self.linear_in.weight.to(dt), self.linear_in.bias.to(dt)
        w2, b2 = self.linear_out.weight.to(dt), self.linear_out.bias.to(dt)
        if self.use_fused:
            return self._fused(x.to(dt), w1, b1, w2, b2, deterministic, generator)
        h = self.dropout(F.gelu(F.linear(x.to(dt), w1, b1)), deterministic, generator)
        return F.linear(h, w2, b2)

    def _fused(self, x, w1, b1, w2, b2, deterministic, generator):
        """``vit_ssl_tpu/ops/feed_forward.py:68-76``: tokens flattened to
        (B·N, d_model), the keep-mask drawn where the unfused path draws
        its dropout mask."""
        *lead, d = x.shape
        flat = x.reshape(-1, d)
        rate = self.dropout.rate
        mask = None
        if not deterministic and rate > 0.0:
            if generator is None:
                raise ValueError("dropout in training mode needs a torch.Generator")
            mask = keep_mask((flat.shape[0], w1.shape[0]), rate, generator,
                             self.dropout.fast)
        out = fused_mlp(flat, w1, b1, w2, b2, mask, 1.0 - rate)
        return out.reshape(*lead, d)
