"""Dropout (port of ``vit_ssl_tpu/ops/dropout.py``).

The JAX package thresholds raw uint16 random bits (``dropout16``):
``drop ⇔ bits < min(round(rate·65536), 65535)``, kept values scaled by
1/(1 − rate) in x's dtype. The realised drop rate is quantised to 1/65536
(rate 0.1 → 6554/65536). The port keeps that rule; its bits come from an
explicit ``torch.Generator`` on the tensor's device, so its streams differ
from ``jax.random.bits`` by design. Masks are drawn in plain PyTorch, as the
JAX package leaves them to XLA.

``fast_dropout=false`` is the JAX package's ``dropout_bernoulli``: keep
where an fp32 uniform draw is below 1 − rate (``jax.random.bernoulli``),
kept values scaled by 1/(1 − rate). :class:`Dropout` picks the rule by its
``fast`` flag.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def drop_threshold(rate: float) -> int:
    """Bits below this value drop: min(round(rate·65536), 65535)."""
    return min(round(rate * 65536), 65535)


def keep_mask16(shape, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Boolean keep-mask (True = keep) from uint16 random bits drawn with
    ``generator``, on the generator's device."""
    # uint16 bits held in int32: torch draws no uint16 with a range
    bits = torch.randint(0, 65536, tuple(shape), generator=generator,
                         device=generator.device, dtype=torch.int32)
    return bits >= drop_threshold(rate)


def dropout16(x: torch.Tensor, rate: float,
              generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout by uint16 threshold; kept values scaled by
    1/(1 − rate), in x's dtype. ``generator`` lives on x's device."""
    if rate <= 0.0:
        return x
    keep = keep_mask16(x.shape, rate, generator)
    return torch.where(keep, x / (1.0 - rate), x.new_zeros(()))


def keep_mask_bernoulli(shape, rate: float,
                        generator: torch.Generator) -> torch.Tensor:
    """Boolean keep-mask (True = keep): an fp32 uniform draw below
    1 − rate, drawn with ``generator`` on its device."""
    u = torch.rand(tuple(shape), generator=generator, device=generator.device)
    return u < 1.0 - rate


def keep_mask(shape, rate: float, generator: torch.Generator,
              fast: bool = True) -> torch.Tensor:
    """:func:`keep_mask16` when ``fast``, else :func:`keep_mask_bernoulli`."""
    return (keep_mask16 if fast else keep_mask_bernoulli)(shape, rate, generator)


def dropout_bernoulli(x: torch.Tensor, rate: float,
                      generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout with an fp32-uniform Bernoulli keep-mask; kept
    values scaled by 1/(1 − rate), in x's dtype."""
    if rate <= 0.0:
        return x
    keep = keep_mask_bernoulli(x.shape, rate, generator)
    return torch.where(keep, x / (1.0 - rate), x.new_zeros(()))


class Dropout(nn.Module):
    """``dropout16`` (``fast``) or ``dropout_bernoulli`` as a module. The
    identity when ``deterministic`` is set or the rate is 0; otherwise the
    caller's ``generator`` draws the mask."""

    def __init__(self, rate: float, fast: bool = True):
        super().__init__()
        self.rate = float(rate)
        self.fast = bool(fast)

    def forward(self, x, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        if deterministic or self.rate <= 0.0:
            return x
        if generator is None:
            raise ValueError("dropout in training mode needs a torch.Generator")
        return (dropout16 if self.fast else dropout_bernoulli)(x, self.rate, generator)
