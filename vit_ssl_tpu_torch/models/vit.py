"""Supervised Vision Transformer (port of ``vit_ssl_tpu/models/vit.py``).

:class:`ConvPatchEmbed` → pre-LN encoder blocks → CLS token →
:class:`MLPHead` (LayerNorm + Linear in fp32): fp32 logits.
``return_attn`` also returns the last block's attention probabilities.
The forward is ``embed`` → ``encode`` → ``finish``, as in the JAX module.

``reset_parameters`` draws with the model's ``init_scheme`` and
``use_flash=False`` takes the plain attention, as for the DINO backbone
(:mod:`.dino`).

``remat`` (``parallel.remat``) checkpoints each encoder block
(:func:`~..ops.encoder_block.remat_block`) where a backward will run
through it; the dropout masks, the output and the gradients are those of
the plain forward.

Not ported yet, and refused with ``NotImplementedError`` (``ROADMAP.md``
queue A item 9): ``scan_layers``, ``patch_dropout`` and Mixture-of-Experts
blocks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops import ConvPatchEmbed, EncoderBlock, MLPHead
from ..ops.encoder_block import remat_block, wants_remat
from ..ops.initializers import check_scheme, init_


def _refuse(option: str, item: int, why: str = "") -> None:
    raise NotImplementedError(
        f"{option} is not ported yet{why}; see ROADMAP.md queue A item {item}"
    )


def refuse_unported(scan_layers: bool = False, patch_dropout: float = 0.0,
                    moe_experts: int = 0) -> None:
    """Raise ``NotImplementedError`` for the first model option asked for
    that the port does not run yet, naming its ``ROADMAP.md`` item."""
    if scan_layers:
        _refuse("model.scan_layers", 9)
    if patch_dropout > 0.0:
        _refuse("model.patch_dropout > 0", 9)
    if moe_experts > 0:
        _refuse("model.moe_experts > 0 (Mixture-of-Experts blocks)", 9)


class ViT(nn.Module):
    def __init__(self, num_classes: int, num_blocks: int,
                 input_shape: Tuple[int, int, int], embed_dim: int,
                 patch_size: int, num_heads: int = 8, mlp_dim: int = 3072,
                 dropout: float = 0.1, patch_dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, fast_dropout: bool = True,
                 use_fused_mlp: bool = False, use_flash: bool = True,
                 init_scheme: str = "reference", remat: bool = False,
                 scan_layers: bool = False, moe_experts: int = 0, device=None):
        super().__init__()
        refuse_unported(scan_layers, patch_dropout, moe_experts)
        self.dtype = dtype
        self.remat = bool(remat)
        self.init_scheme = check_scheme(init_scheme)
        self.patch_embedding = ConvPatchEmbed(
            input_shape, embed_dim, patch_size, dtype=dtype, device=device
        )
        self.encoder_blocks = nn.ModuleList(
            EncoderBlock(embed_dim, num_heads, mlp_dim, dtype=dtype,
                         dropout=dropout, fast_dropout=fast_dropout,
                         use_fused_mlp=use_fused_mlp, use_flash=use_flash,
                         device=device)
            for _ in range(num_blocks)
        )
        self.classification_head = MLPHead(embed_dim, num_classes, device=device)

    def embed(self, x):
        return self.patch_embedding(x)

    def encode(self, x, deterministic: bool = True,
               generator: Optional[torch.Generator] = None,
               return_attn: bool = False):
        """The encoder blocks; with ``return_attn``, (tokens, the last
        block's probabilities). With ``remat``, each block that a backward
        will run through is checkpointed."""
        probs = None
        last = len(self.encoder_blocks) - 1
        for i, block in enumerate(self.encoder_blocks):
            if return_attn and i == last:
                x, probs = block(x, 0, deterministic, generator, return_attn=True)
            elif self.remat and wants_remat(block, x):
                x = remat_block(block, x, 0, deterministic, generator)
            else:
                x = block(x, 0, deterministic, generator)
        return (x, probs) if return_attn else x

    def finish(self, x):
        """The CLS token's fp32 logits."""
        return self.classification_head(x[:, 0].float())

    def forward(self, x, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                return_attn: bool = False):
        """(B, H, W, C) images → (B, num_classes) fp32 logits [, the last
        block's attention probabilities (B, heads, N, N)]. Unless
        ``deterministic``, ``generator`` draws the dropout masks."""
        x = self.embed(x)
        if return_attn:
            x, probs = self.encode(x, deterministic, generator, True)
            return self.finish(x), probs
        return self.finish(self.encode(x, deterministic, generator))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Redraw every parameter with the model's init scheme
        (:func:`~..ops.initializers.init_`)."""
        return init_(self, self.init_scheme, generator)
