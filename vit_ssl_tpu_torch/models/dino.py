"""DINO ViT backbone (port of ``vit_ssl_tpu/models/dino.py::ViTBackbone``).

DynamicPatchEmbed → encoder blocks → CLS token, with no final LayerNorm.
It is what ``DINONetwork.features`` runs for serving: the teacher
backbone's CLS embedding. The DINO head, dropout and the packed multi-crop
forward come with the training slice.

PyTorch's default ``nn.Linear``/``nn.Conv2d`` initialisation and the
uniform [0, 1) CLS/positional embeddings equal the JAX package's
``"reference"`` init scheme; :meth:`ViTBackbone.reset_parameters` redraws
them all from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..ops import DynamicPatchEmbed, EncoderBlock


class ViTBackbone(nn.Module):
    def __init__(self, num_blocks: int, input_shape: Tuple[int, int, int],
                 embed_dim: int, patch_size: int, num_heads: int = 8,
                 mlp_dim: int = 3072, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.patch_embedding = DynamicPatchEmbed(
            input_shape, embed_dim, patch_size, dtype=dtype, device=device
        )
        self.encoder_blocks = nn.ModuleList(
            EncoderBlock(embed_dim, num_heads, mlp_dim, dtype=dtype, device=device)
            for _ in range(num_blocks)
        )

    def embed(self, x):
        return self.patch_embedding(x)

    def encode(self, x, block_size: int = 0):
        for block in self.encoder_blocks:
            x = block(x, block_size)
        return x

    def forward(self, x):
        """(B, H, W, C) images → (B, embed_dim) CLS embeddings in ``dtype``."""
        return self.encode(self.embed(x))[:, 0]

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Redraw every parameter with the reference init: Kaiming-uniform
        (a=√5) weights and U(±1/√fan_in) biases for Linear/Conv2d, ones and
        zeros for LayerNorm, U[0, 1) CLS and positional embeddings."""
        for module in self.modules():
            if isinstance(module, (nn.Linear, nn.Conv2d)):
                nn.init.kaiming_uniform_(module.weight, a=math.sqrt(5),
                                         generator=generator)
                if module.bias is not None:
                    fan_in = module.weight[0].numel()
                    bound = 1.0 / math.sqrt(fan_in)
                    nn.init.uniform_(module.bias, -bound, bound,
                                     generator=generator)
            elif isinstance(module, nn.LayerNorm):
                nn.init.ones_(module.weight)
                nn.init.zeros_(module.bias)
            elif isinstance(module, DynamicPatchEmbed):
                nn.init.uniform_(module.cls_token, generator=generator)
                nn.init.uniform_(module.positional_embedding,
                                 generator=generator)
        return self
