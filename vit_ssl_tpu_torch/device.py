"""Device choice for the port's entry points.

Entry points run on the CUDA card. They take the CPU only when the caller
asks for it (the CPU tests do); with no card and no such request they raise
rather than silently run somewhere slower.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` → ``cuda`` when a card is present, else ``RuntimeError``.

    An explicit ``"cpu"`` (or ``"cuda"``, ``"cuda:1"``) is honoured; asking
    for CUDA without a card raises too."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}; use 'cuda' or 'cpu'")
    return device
