"""Dropout (port of ``vit_ssl_tpu/ops/dropout.py``).

The JAX package thresholds raw uint16 random bits (``dropout16``):
``drop ⇔ bits < min(round(rate·65536), 65535)``, kept values scaled by
1/(1 − rate) in x's dtype. The realised drop rate is quantised to 1/65536
(rate 0.1 → 6554/65536). The port keeps that rule; its bits come from an
explicit ``torch.Generator`` on the tensor's device, so its streams differ
from ``jax.random.bits`` by design. Masks are drawn in plain PyTorch, as the
JAX package leaves them to XLA.

The JAX package's ``fast_dropout=false`` (an fp32-uniform Bernoulli draw)
is not ported: :class:`Dropout` raises for it (``ROADMAP.md`` queue A
item 5).
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


class Dropout(nn.Module):
    """``dropout16`` as a module. The identity when ``deterministic`` is set
    or the rate is 0; otherwise the caller's ``generator`` draws the mask."""

    def __init__(self, rate: float, fast: bool = True):
        super().__init__()
        if not fast:
            raise NotImplementedError(
                "fast_dropout=false (Bernoulli dropout) is not ported yet; "
                "see ROADMAP.md queue A item 5"
            )
        self.rate = float(rate)

    def forward(self, x, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        if deterministic or self.rate <= 0.0:
            return x
        if generator is None:
            raise ValueError("dropout in training mode needs a torch.Generator")
        return dropout16(x, self.rate, generator)
