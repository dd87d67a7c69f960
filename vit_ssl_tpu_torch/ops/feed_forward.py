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
paths draw the (tokens, d_ff) keep-mask by the same rule (``fast_dropout``)
before the first product, so from one generator state they drop the same
units; they round at different places (the fused path keeps GELU's output
in fp32 through the dropout scale, as the JAX kernel does).

Under tensor parallelism (:mod:`..parallel.tensor_parallel`) ``linear_in``
holds this rank's rows of the hidden width and ``linear_out`` its columns:
the block (unfused, or B4 at the local d_ff) gives a partial output, summed
over the model axis, and ``linear_out``'s bias is added once after the
sum. The keep-mask is this rank's columns of the whole (tokens, d_ff)
draw, so the ranks drop what one process drops.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.tensor_parallel import axis_of, run, shard
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
        *lead, d = x.shape
        rate = self.dropout.rate
        mask = None
        if not deterministic and rate > 0.0:
            if generator is None:
                raise ValueError("dropout in training mode needs a torch.Generator")
            rows = x.numel() // d
            mask = keep_mask((rows, self.linear_in.out_features), rate, generator,
                             self.dropout.fast)
        b2 = self.linear_out.bias.to(dt)

        def body(x, w1, b1, w2, rank, size):
            keep = None if mask is None else shard(mask, 1, rank, size)
            bias = b2 if size == 1 else None  # added once after the sum otherwise
            w1, b1, w2 = w1.to(dt), b1.to(dt), w2.to(dt)
            if self.use_fused:
                bias = torch.zeros_like(b2) if bias is None else bias
                return fused_mlp(x.reshape(-1, d), w1, b1, w2, bias, keep,
                                 1.0 - rate).reshape(*lead, d)
            h = F.gelu(F.linear(x, w1, b1))
            if keep is not None:
                h = torch.where(keep.reshape(h.shape), h / (1.0 - rate), h.new_zeros(()))
            return F.linear(h, w2, bias)

        axis = axis_of(self.linear_in)
        out = run(axis, body, (x.to(dt),), (self.linear_in.weight, self.linear_in.bias,
                                             self.linear_out.weight), (0, 0, 1))
        return out if axis is None else out + b2
