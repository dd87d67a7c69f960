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

``scan_layers`` holds the blocks as one stacked body
(:class:`~..ops.encoder_stack.ScannedEncoder`, parameters
``encoder_scan.block.*``); it trains bit-equal to the unrolled stack from
the same weights, and refuses ``return_attn``, as JAX does.

``patch_dropout`` p > 0 (PatchDropout, Liu et al., arXiv:2208.07220): in
training, and never under ``return_attn``, each image keeps
``max(1, round(n·(1 − p)))`` of its n patch tokens after the positional
embedding, the CLS token always: the first ones of the argsort of uniform
scores drawn from the step's dropout generator before any block draws
(under data parallelism each data rank's own draws, as for its dropout
masks; :func:`patch_keep_count`, :func:`draw_patch_scores`,
:func:`patch_keep_indices`, :func:`drop_patches`).

``moe_experts`` E > 0: blocks ``moe_every − 1, 2·moe_every − 1, …`` (the
V-MoE layout, every other block from the second by default) hold a
Mixture-of-Experts FFN (:mod:`..ops.moe`). ``forward(..., return_aux=True)``
also returns the router losses summed over those blocks and their mean
dropped share, which the supervised train step adds to its loss.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops import ConvPatchEmbed, EncoderBlock, MLPHead
from ..ops.encoder_block import remat_block, wants_remat
from ..ops.encoder_stack import ScannedEncoder, refuse_return_attn
from ..ops.initializers import check_scheme, init_


def patch_keep_count(num_patches: int, rate: float) -> int:
    """The patch tokens an image keeps: max(1, round(n·(1 − rate)))."""
    return max(1, int(round(num_patches * (1.0 - rate))))


def draw_patch_scores(generator: torch.Generator, batch: int,
                      num_patches: int) -> torch.Tensor:
    """(batch, num_patches) uniform fp32 scores on the generator's device,
    from the forward's dropout stream (JAX draws them from its ``dropout``
    rng): under data parallelism each data rank's own draws, as its
    dropout masks are."""
    return torch.rand((batch, num_patches), generator=generator,
                      device=generator.device)


def patch_keep_indices(scores: torch.Tensor, keep: int) -> torch.Tensor:
    """The first ``keep`` patch indices of each row's stable argsort."""
    return torch.argsort(scores, dim=-1, stable=True)[:, :keep]


def drop_patches(tokens: torch.Tensor, keep_idx: torch.Tensor) -> torch.Tensor:
    """(B, 1 + n, D) tokens → (B, 1 + keep, D): the CLS token, then the
    patch tokens at ``keep_idx`` (B, keep), in that order."""
    d = tokens.shape[-1]
    patches = torch.gather(tokens[:, 1:], 1, keep_idx[..., None].expand(-1, -1, d))
    return torch.cat([tokens[:, :1], patches], dim=1)


def block_kwargs(embed_dim: int, num_heads: int, mlp_dim: int,
                 dtype: torch.dtype, dropout: float, fast_dropout: bool,
                 use_fused_mlp: bool, use_flash: bool) -> dict:
    """The encoder block's constructor arguments every model shares."""
    return dict(d_model=embed_dim, num_heads=num_heads, mlp_dim=mlp_dim, dtype=dtype,
                dropout=dropout, fast_dropout=fast_dropout, use_fused_mlp=use_fused_mlp,
                use_flash=use_flash)


def encoder_stack(num_blocks: int, kwargs: dict, scan_layers: bool, device,
                  moe_kwargs: Optional[dict] = None, is_moe=lambda i: False):
    """``(encoder_blocks, encoder_scan)``: the unrolled ``nn.ModuleList``
    (MoE FFNs where ``is_moe(i)``) and None, or an empty list and the
    :class:`ScannedEncoder`."""
    if scan_layers:
        return nn.ModuleList(), ScannedEncoder(num_blocks, kwargs, device=device)
    moe_kwargs = moe_kwargs or {}
    return nn.ModuleList(
        EncoderBlock(**kwargs, **(moe_kwargs if is_moe(i) else {}), device=device)
        for i in range(num_blocks)), None


class ViT(nn.Module):
    def __init__(self, num_classes: int, num_blocks: int,
                 input_shape: Tuple[int, int, int], embed_dim: int,
                 patch_size: int, num_heads: int = 8, mlp_dim: int = 3072,
                 dropout: float = 0.1, patch_dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, fast_dropout: bool = True,
                 use_fused_mlp: bool = False, use_flash: bool = True,
                 init_scheme: str = "reference", remat: bool = False,
                 scan_layers: bool = False, moe_experts: int = 0, moe_every: int = 2,
                 moe_top_k: int = 2, moe_capacity_factor: float = 1.25,
                 moe_group_size: int = 0, moe_aux_weight: float = 0.01,
                 moe_zloss_weight: float = 1e-3, moe_router_noise: float = 0.0,
                 device=None):
        super().__init__()
        if scan_layers and moe_experts > 0:
            raise ValueError("model.scan_layers cannot be combined with "
                             "model.moe_experts > 0: the scanned stack is homogeneous; "
                             "MoE blocks alternate with dense ones")
        self.dtype = dtype
        self.remat = bool(remat)
        self.init_scheme = check_scheme(init_scheme)
        self.patch_dropout = float(patch_dropout)
        self.moe_experts, self.moe_every = int(moe_experts), max(1, int(moe_every))
        self.patch_embedding = ConvPatchEmbed(
            input_shape, embed_dim, patch_size, dtype=dtype, device=device
        )
        moe = dict(num_experts=self.moe_experts, moe_top_k=moe_top_k,
                   moe_capacity_factor=moe_capacity_factor, moe_group_size=moe_group_size,
                   moe_aux_weight=moe_aux_weight, moe_zloss_weight=moe_zloss_weight,
                   moe_router_noise=moe_router_noise)
        self.encoder_blocks, self.encoder_scan = encoder_stack(
            num_blocks, block_kwargs(embed_dim, num_heads, mlp_dim, dtype, dropout,
                                     fast_dropout, use_fused_mlp, use_flash),
            scan_layers, device, moe, self._is_moe_block)
        self.classification_head = MLPHead(embed_dim, num_classes, device=device)

    def _is_moe_block(self, i: int) -> bool:
        """The V-MoE placement: block i holds experts when (i + 1) %
        moe_every == 0."""
        return self.moe_experts > 0 and (i + 1) % self.moe_every == 0

    def embed(self, x, deterministic: bool = True,
              generator: Optional[torch.Generator] = None,
              allow_patch_dropout: bool = True):
        """Patch tokens with the CLS token; in training with
        ``patch_dropout``, each image's kept subset (drawn first from
        ``generator``)."""
        x = self.patch_embedding(x)
        if not deterministic and self.patch_dropout > 0.0 and allow_patch_dropout:
            if generator is None:
                raise ValueError("patch dropout in training mode needs a torch.Generator")
            b, n = x.shape[0], x.shape[1] - 1
            scores = draw_patch_scores(generator, b, n)
            x = drop_patches(x, patch_keep_indices(
                scores, patch_keep_count(n, self.patch_dropout)))
        return x

    def encode(self, x, deterministic: bool = True,
               generator: Optional[torch.Generator] = None,
               return_attn: bool = False, return_aux: bool = False):
        """The encoder blocks; with ``return_attn``, (tokens, the last
        block's probabilities); with ``return_aux``, (tokens, the MoE
        blocks' summed router loss, their mean dropped share), zeros
        without MoE blocks. With ``remat``, each block that a backward
        will run through is checkpointed. Under pipeline parallelism
        (``_pipeline``, :mod:`..parallel.integrate`) the blocks run over the
        stages, without ``return_attn`` or ``return_aux``."""
        pipe = getattr(self, "_pipeline", None)
        if pipe is not None:
            if return_attn or return_aux:
                raise ValueError("return_attn and return_aux run on an unpipelined "
                                 "model (PipelineState.unsharded)")
            return pipe(self.encoder_blocks, x, 0, deterministic, generator, self.remat)
        if self.encoder_scan is not None:
            if return_attn:
                refuse_return_attn()
            x = self.encoder_scan(x, 0, deterministic, generator, self.remat)
            return (x, x.new_zeros((), dtype=torch.float32),
                    x.new_zeros((), dtype=torch.float32)) if return_aux else x
        probs = None
        aux, dropped = [], []
        last = len(self.encoder_blocks) - 1
        for i, block in enumerate(self.encoder_blocks):
            moe_aux = return_aux and block.is_moe
            kwargs = {"return_aux": True} if moe_aux else {}
            if return_attn and i == last:
                x, probs = block(x, 0, deterministic, generator, return_attn=True)
            elif self.remat and wants_remat(block, x):
                x = remat_block(block, x, 0, deterministic, generator, **kwargs)
            else:
                x = block(x, 0, deterministic, generator, **kwargs)
            if moe_aux:
                x, block_aux, block_dropped = x
                aux.append(block_aux)
                dropped.append(block_dropped)
        if return_attn:
            return x, probs
        if return_aux:
            zero = x.new_zeros((), dtype=torch.float32)
            total = sum(aux, zero)
            mean = sum(dropped, zero) / len(dropped) if dropped else zero
            return x, total, mean
        return x

    def finish(self, x):
        """The CLS token's fp32 logits."""
        return self.classification_head(x[:, 0].float())

    def forward(self, x, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                return_attn: bool = False, return_aux: bool = False):
        """(B, H, W, C) images → (B, num_classes) fp32 logits [, the last
        block's attention probabilities (B, heads, N, N)] [, the MoE
        router loss and dropped share (``return_aux``)]. Unless
        ``deterministic``, ``generator`` draws the patch subset and the
        dropout masks."""
        x = self.embed(x, deterministic, generator, allow_patch_dropout=not return_attn)
        if return_attn:
            x, probs = self.encode(x, deterministic, generator, True)
            return self.finish(x), probs
        if return_aux:
            x, aux, dropped = self.encode(x, deterministic, generator, return_aux=True)
            return self.finish(x), aux, dropped
        return self.finish(self.encode(x, deterministic, generator))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Redraw every parameter with the model's init scheme
        (:func:`~..ops.initializers.init_`)."""
        return init_(self, self.init_scheme, generator)
