"""Patch embedders (port of ``vit_ssl_tpu/ops/patch_embedding.py``).

Conv(k = stride = patch) tokenizer + learnable ``cls_token`` + learnable
``positional_embedding`` of length (H/p)²+1. Images come in NHWC, the JAX
package's layout, and are permuted to NCHW for the convolution.
:class:`ConvPatchEmbed` (the supervised ViT's, tokenizer ``conv``) takes the
configured image size only; :class:`DynamicPatchEmbed` (DINO's, tokenizer
``proj``) takes other grids too. :class:`ManualPatchEmbed` (tokenizer
``linear``) is the unfold + Linear form of :class:`ConvPatchEmbed`; no model
builds it, as in the JAX package.

:func:`extract_patches` flattens each patch in torch-unfold (C, ph, pw)
order, SimMIM's pixel targets and ``projection`` layout;
:func:`patches_to_image` is its inverse.

A patch grid other than the stored one (DINO's 48 px local crops: 6×6
against 12×12) resizes the positional embedding as the JAX package does,
``jax.image.resize(..., "bicubic")``: Keys' cubic with a = −0.5,
antialiased when it downsamples (:mod:`.resample`), in fp32 on the fp32
parameter, cast to ``dtype`` with the rest of the embedding.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .resample import resize_hw


def extract_patches(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, C) → (B, N, C·p·p), each patch in (C, ph, pw) order."""
    b, h, w, c = x.shape
    p = patch_size
    gh, gw = h // p, w // p
    x = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 5, 2, 4)  # (B, gh, gw, C, p, p)
    return x.reshape(b, gh * gw, c * p * p)


def patches_to_image(patches: torch.Tensor, image_hw: Tuple[int, int],
                     patch_size: int, channels: int) -> torch.Tensor:
    """Inverse of :func:`extract_patches`: (B, N, C·p·p) → (B, H, W, C)."""
    b = patches.shape[0]
    p = patch_size
    gh, gw = image_hw[0] // p, image_hw[1] // p
    x = patches.reshape(b, gh, gw, channels, p, p).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, gh * p, gw * p, channels)


def _check_divisible(h: int, w: int, patch_size: int) -> None:
    if h % patch_size != 0 or w % patch_size != 0:
        raise ValueError(
            f"Image dimensions H={h}, W={w} must be divisible by "
            f"patch_size={patch_size}"
        )


class ConvPatchEmbed(nn.Module):
    """``ConvPatchEmbed`` (``vit_ssl_tpu/ops/patch_embedding.py:63-110``):
    the conv runs in ``dtype`` on the fp32 parameters cast to it; the CLS
    token and the positional embedding are cast to ``dtype`` and added."""

    def __init__(self, input_shape: Tuple[int, int, int], embed_dim: int,
                 patch_size: int, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        c, h, w = input_shape
        _check_divisible(h, w, patch_size)
        self.embed_dim = embed_dim
        self.patch_size = patch_size
        self.dtype = dtype
        num_patches = (h // patch_size) ** 2
        self.conv = nn.Conv2d(c, embed_dim, patch_size, stride=patch_size,
                              device=device)
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim, device=device))
        self.positional_embedding = nn.Parameter(
            torch.empty(1, num_patches + 1, embed_dim, device=device)
        )
        nn.init.uniform_(self.cls_token)  # torch.rand, as the reference
        nn.init.uniform_(self.positional_embedding)

    def forward(self, x):
        """(B, H, W, C) → (B, (H/p)² + 1, embed_dim) in ``dtype``."""
        dt = self.dtype
        tokens = F.conv2d(
            x.to(dt).permute(0, 3, 1, 2), self.conv.weight.to(dt),
            self.conv.bias.to(dt), stride=self.patch_size,
        )  # (B, D, gh, gw)
        tokens = tokens.flatten(2).transpose(1, 2)  # (B, gh·gw, D)
        cls = self.cls_token.to(dt).expand(x.shape[0], 1, self.embed_dim)
        return torch.cat([cls, tokens], dim=1) + self.positional_embedding.to(dt)


class ManualPatchEmbed(nn.Module):
    """``ManualPatchEmbed`` (``vit_ssl_tpu/ops/patch_embedding.py:113-156``):
    :func:`extract_patches` then ``linear`` (C·p² → embed_dim) in
    ``dtype``, the CLS token prepended and the positional embedding
    added."""

    def __init__(self, input_shape: Tuple[int, int, int], embed_dim: int,
                 patch_size: int, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        c, h, w = input_shape
        _check_divisible(h, w, patch_size)
        self.embed_dim = embed_dim
        self.patch_size = patch_size
        self.dtype = dtype
        num_patches = (h // patch_size) ** 2
        self.linear = nn.Linear(c * patch_size ** 2, embed_dim, device=device)
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim, device=device))
        self.positional_embedding = nn.Parameter(
            torch.empty(1, num_patches + 1, embed_dim, device=device)
        )
        nn.init.uniform_(self.cls_token)  # torch.rand, as the reference
        nn.init.uniform_(self.positional_embedding)

    def forward(self, x):
        """(B, H, W, C) → (B, (H/p)² + 1, embed_dim) in ``dtype``."""
        dt = self.dtype
        patches = extract_patches(x.to(dt), self.patch_size)
        tokens = F.linear(patches, self.linear.weight.to(dt), self.linear.bias.to(dt))
        cls = self.cls_token.to(dt).expand(x.shape[0], 1, self.embed_dim)
        return torch.cat([cls, tokens], dim=1) + self.positional_embedding.to(dt)


class DynamicPatchEmbed(nn.Module):
    def __init__(self, input_shape: Tuple[int, int, int], embed_dim: int,
                 patch_size: int, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        c, h0, w0 = input_shape
        self.embed_dim = embed_dim
        self.patch_size = patch_size
        self.dtype = dtype
        self.grid = (h0 // patch_size, w0 // patch_size)
        num_patches = self.grid[0] * self.grid[1]
        self.proj = nn.Conv2d(c, embed_dim, patch_size, stride=patch_size,
                              device=device)
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim, device=device))
        self.positional_embedding = nn.Parameter(
            torch.empty(1, num_patches + 1, embed_dim, device=device)
        )
        # the reference initialises both with torch.rand
        nn.init.uniform_(self.cls_token)
        nn.init.uniform_(self.positional_embedding)

    def forward(self, x):
        """(B, H, W, C) → (B, (H/p)·(W/p) + 1, embed_dim) in ``dtype``."""
        b, h, w, _ = x.shape
        _check_divisible(h, w, self.patch_size)
        gh, gw = h // self.patch_size, w // self.patch_size
        dt = self.dtype
        tokens = F.conv2d(
            x.to(dt).permute(0, 3, 1, 2), self.proj.weight.to(dt),
            self.proj.bias.to(dt), stride=self.patch_size,
        )  # (B, D, gh, gw)
        tokens = tokens.flatten(2).transpose(1, 2)  # (B, gh·gw, D)
        cls = self.cls_token.to(dt).expand(b, 1, self.embed_dim)
        tokens = torch.cat([cls, tokens], dim=1)
        return tokens + self.interpolate_pos_encoding(gh, gw).to(dt)

    def interpolate_pos_encoding(self, gh: int, gw: int):
        """The positional embedding for a gh×gw patch grid (JAX's
        ``_interpolate_pos_encoding``, ``ops/patch_embedding.py:216-226``):
        the stored one when the grid is square with the stored patch count,
        else its patch part resized bicubically; the CLS entry is kept."""
        pe = self.positional_embedding
        if gh * gw == self.grid[0] * self.grid[1] and gh == gw:
            return pe
        patch = pe[:, 1:].reshape(1, self.grid[0], self.grid[1], self.embed_dim)
        patch = resize_hw(patch, gh, gw, "cubic").reshape(1, gh * gw, self.embed_dim)
        return torch.cat([pe[:, :1], patch], dim=1)
