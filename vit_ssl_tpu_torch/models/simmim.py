"""SimMIM masked-image-modelling ViT (port of ``vit_ssl_tpu/models/simmim.py``).

- :func:`make_random_mask`: exactly k = int(N · mask_ratio) masked patches
  a row, by the JAX rule: uniform scores, the k-th smallest as the
  threshold, ``scores <= kth`` (not ``topk``); all false at k = 0.
- :class:`SimMIMViT`: the patches (:func:`~..ops.extract_patches`, torch
  unfold's (C, ph, pw) order) through ``projection``, masked tokens
  replaced by ``mask_token`` before the positional embedding (length N, no
  CLS slot) is added, the encoder blocks, and ``simmim_head`` in fp32
  predicting every patch's pixels. The parameters carry the reference
  layout that ``simmim_params_to_torch`` writes (``projection.*``,
  ``mask_token``, ``positional_embedding``, ``simmim_head.*``,
  ``encoder_blocks.{i}.*``), so a JAX export loads with ``strict=True``.
- :func:`masked_l1_loss`: the mean L1 over masked patches only.

``remat`` checkpoints each block where a backward runs through it, and
``scan_layers`` holds the blocks as one stacked body
(``encoder_scan.block.*``), as the ViT does (:mod:`.vit`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import extract_patches
from ..ops.encoder_block import remat_block, wants_remat
from ..ops.initializers import check_scheme, init_
from ..parallel.context import rand_rows
from ..parallel.tensor_parallel import axis_of, linear_body, run
from .vit import block_kwargs, encoder_stack


def make_random_mask(generator: torch.Generator, batch: int, num_patches: int,
                     mask_ratio: float) -> torch.Tensor:
    """(batch, num_patches) bool on the generator's device, exactly
    int(num_patches · mask_ratio) True a row (scores tie with probability
    0); the scores are this data rank's rows of the global batch's
    draws."""
    num_masked = int(num_patches * mask_ratio)
    if num_masked == 0:
        return torch.zeros(batch, num_patches, dtype=torch.bool,
                           device=generator.device)
    scores = rand_rows(generator, (batch, num_patches))
    kth = scores.sort(dim=-1).values[:, num_masked - 1:num_masked]
    return scores <= kth


class SimMIMViT(nn.Module):
    def __init__(self, num_blocks: int, input_shape: Tuple[int, int, int],
                 embed_dim: int, patch_size: int, num_heads: int = 8,
                 mlp_dim: int = 3072, dropout: float = 0.1,
                 mask_ratio: float = 0.6, dtype: torch.dtype = torch.float32,
                 fast_dropout: bool = True, use_fused_mlp: bool = False,
                 use_flash: bool = True, init_scheme: str = "reference",
                 remat: bool = False, scan_layers: bool = False, device=None):
        super().__init__()
        c, h, _ = input_shape
        self.dtype = dtype
        self.patch_size = patch_size
        self.mask_ratio = float(mask_ratio)
        self.remat = bool(remat)
        self.init_scheme = check_scheme(init_scheme)
        patch_dim = c * patch_size ** 2
        num_patches = (h // patch_size) ** 2
        self.projection = nn.Linear(patch_dim, embed_dim, device=device)
        self.mask_token = nn.Parameter(torch.empty(1, 1, embed_dim, device=device))
        self.positional_embedding = nn.Parameter(
            torch.empty(1, num_patches, embed_dim, device=device))
        self.encoder_blocks, self.encoder_scan = encoder_stack(
            num_blocks, block_kwargs(embed_dim, num_heads, mlp_dim, dtype, dropout,
                                     fast_dropout, use_fused_mlp, use_flash),
            scan_layers, device)
        self.simmim_head = nn.Linear(embed_dim, patch_dim, device=device)
        self.reset_parameters()

    def _tokens(self, patches):
        dt = self.dtype
        return F.linear(patches.to(dt), self.projection.weight.to(dt),
                        self.projection.bias.to(dt))

    def encode(self, x, deterministic: bool = True,
               generator: Optional[torch.Generator] = None):
        """The blocks (over the pipeline's stages under ``_pipeline``:
        :mod:`..parallel.integrate`)."""
        pipe = getattr(self, "_pipeline", None)
        if pipe is not None:
            return pipe(self.encoder_blocks, x, 0, deterministic, generator, self.remat)
        if self.encoder_scan is not None:
            return self.encoder_scan(x, 0, deterministic, generator, self.remat)
        for block in self.encoder_blocks:
            if self.remat and wants_remat(block, x):
                x = remat_block(block, x, 0, deterministic, generator)
            else:
                x = block(x, 0, deterministic, generator)
        return x

    def embed_masked(self, x, mask_generator: Optional[torch.Generator] = None,
                     mask: Optional[torch.Tensor] = None):
        """Patchify, mask, project, add the positional embedding: (tokens,
        target patches, bool mask). ``mask`` (B, N) is used as given;
        otherwise ``mask_generator`` draws it."""
        patches = extract_patches(x, self.patch_size)
        if mask is not None:
            bool_mask = mask.to(device=patches.device, dtype=torch.bool)
        else:
            if mask_generator is None:
                raise ValueError("a SimMIM forward without a mask needs a mask generator")
            bool_mask = make_random_mask(mask_generator, patches.shape[0],
                                         patches.shape[1], self.mask_ratio)
        dt = self.dtype
        tokens = torch.where(bool_mask[..., None], self.mask_token.to(dt),
                             self._tokens(patches))
        return tokens + self.positional_embedding.to(dt), patches, bool_mask

    def predict(self, tokens):
        """The reconstruction head, fp32: (B, N, C·p²); column-parallel under
        tensor parallelism, the predictions gathered."""
        head = self.simmim_head
        return run(axis_of(head), linear_body, (tokens.float(),), (head.weight, head.bias),
                   (0, 0), "cat")

    def forward(self, x, deterministic: bool = True,
                generators: Sequence[Optional[torch.Generator]] = (None, None),
                mask: Optional[torch.Tensor] = None):
        """The masked forward of (B, H, W, C) images; ``generators`` is
        (dropout, mask): the dropout generator is needed unless
        ``deterministic``, the mask generator unless ``mask`` is given.
        Returns (predictions (B, N, C·p²) fp32, target patches (B, N, C·p²)
        as x's dtype, bool mask (B, N))."""
        g_dropout, g_mask = generators
        tokens, patches, bool_mask = self.embed_masked(x, g_mask, mask)
        tokens = self.encode(tokens, deterministic, g_dropout)
        return self.predict(tokens), patches, bool_mask

    def inference_forward(self, x, return_patch_features: bool = False):
        """The unmasked forward, dropout off: the mean over patch tokens
        (B, embed_dim), or every patch token with
        ``return_patch_features``, in ``dtype``."""
        tokens = self._tokens(extract_patches(x, self.patch_size))
        tokens = self.encode(tokens + self.positional_embedding.to(self.dtype), True)
        return tokens if return_patch_features else tokens.mean(dim=1)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Redraw every parameter with the model's init scheme
        (:func:`~..ops.initializers.init_`)."""
        return init_(self, self.init_scheme, generator)


def masked_l1_loss(predictions, targets, bool_mask) -> torch.Tensor:
    """Mean L1 over the masked patches only: Σ |p − t|·m / max(Σm · C·p², 1)."""
    err = (predictions.float() - targets.float()).abs()
    weights = bool_mask[..., None].float()
    denom = torch.clamp(weights.sum() * err.shape[-1], min=1.0)
    return (err * weights).sum() / denom
