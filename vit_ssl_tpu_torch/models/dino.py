"""DINO self-distillation ViT (port of ``vit_ssl_tpu/models/dino.py``).

- :class:`ViTBackbone`: DynamicPatchEmbed → encoder blocks → CLS token, with
  no final LayerNorm. ``features`` of it is what serving runs.
- :class:`DINOHead`: three Linears with exact-erf GELU between them, an
  fp32 L2-normalise (eps 1e-12), then :class:`WeightNormDense`, which runs
  in fp32 whatever the compute dtype.
- :class:`DINONetwork`: backbone + head, with the packed multi-crop
  forward (``forward_packed``).
- The pure functions of DINO's dynamics: :func:`dino_loss`,
  :func:`update_center` (weighted), :func:`momentum_update` and the two
  cosine schedules.

``reset_parameters`` redraws every parameter from a ``torch.Generator``
with the model's ``init_scheme`` (``"reference"`` or ``"tpu"``,
:mod:`..ops.initializers`). ``use_flash=False`` (the config's
``model.use_flash_attention=false``) sends every attention call to the
plain PyTorch attention. Dropout follows the JAX package's explicit
``deterministic`` flag (not ``nn.Module.train``), and its masks come from
the caller's generator. ``remat`` checkpoints each backbone block where a
backward runs through it (the student, globals and packed locals alike; not
the teacher), as the supervised ViT does; ``scan_layers`` holds the blocks
as one stacked body (``backbone.encoder_scan.block.*``), as there
(:mod:`.vit`). :func:`momentum_update` is elementwise, so the teacher's EMA
is the same on stacked parameters.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import DynamicPatchEmbed
from ..ops.encoder_block import remat_block, wants_remat
from ..ops.initializers import bias_, check_scheme, init_, linear_, weight_
from ..parallel.context import dp_sum
from ..parallel.fsdp import local_tensors
from ..parallel.tensor_parallel import axis_of, linear_body, run
from .vit import block_kwargs, encoder_stack


class ViTBackbone(nn.Module):
    def __init__(self, num_blocks: int, input_shape: Tuple[int, int, int],
                 embed_dim: int, patch_size: int, num_heads: int = 8,
                 mlp_dim: int = 3072, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.1, fast_dropout: bool = True,
                 use_fused_mlp: bool = False, use_flash: bool = True,
                 init_scheme: str = "reference", remat: bool = False,
                 scan_layers: bool = False, device=None):
        super().__init__()
        self.dtype = dtype
        self.remat = bool(remat)
        self.init_scheme = check_scheme(init_scheme)
        self.patch_embedding = DynamicPatchEmbed(
            input_shape, embed_dim, patch_size, dtype=dtype, device=device
        )
        self.encoder_blocks, self.encoder_scan = encoder_stack(
            num_blocks, block_kwargs(embed_dim, num_heads, mlp_dim, dtype, dropout,
                                     fast_dropout, use_fused_mlp, use_flash),
            scan_layers, device)

    def embed(self, x):
        return self.patch_embedding(x)

    def encode(self, x, block_size: int = 0, deterministic: bool = True,
               generator: Optional[torch.Generator] = None):
        """The blocks (over the pipeline's stages under ``_pipeline``:
        :mod:`..parallel.integrate`); ``block_size`` > 0 for packed crops."""
        pipe = getattr(self, "_pipeline", None)
        if pipe is not None:
            return pipe(self.encoder_blocks, x, block_size, deterministic, generator,
                        self.remat)
        if self.encoder_scan is not None:
            return self.encoder_scan(x, block_size, deterministic, generator, self.remat)
        for block in self.encoder_blocks:
            if self.remat and wants_remat(block, x):
                x = remat_block(block, x, block_size, deterministic, generator)
            else:
                x = block(x, block_size, deterministic, generator)
        return x

    def forward(self, x, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """(B, H, W, C) images → (B, embed_dim) CLS embeddings in ``dtype``."""
        return self.encode(self.embed(x), 0, deterministic, generator)[:, 0]

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Redraw every parameter with the model's init scheme
        (:func:`~..ops.initializers.init_`)."""
        return init_(self, self.init_scheme, generator)


class _WeightParts(nn.Module):
    """``original0`` (g, (out, 1)) and ``original1`` (v, (out, in)): the
    names torch's ``weight_norm`` parametrisation gives them."""

    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__()
        self.original0 = nn.Parameter(torch.empty(out_features, 1, device=device))
        self.original1 = nn.Parameter(
            torch.empty(out_features, in_features, device=device))


class WeightNormDense(nn.Module):
    """Dense layer with each output unit's weight row g·v/(‖v‖ + 1e-12),
    computed and applied in fp32 (JAX ``WeightNormDense``). Parameters are
    named as in the reference state dict:
    ``parametrizations.weight.original{0,1}`` and ``bias``."""

    def __init__(self, in_features: int, out_features: int, device=None,
                 init_scheme: str = "reference"):
        super().__init__()
        self.init_scheme = check_scheme(init_scheme)
        self.parametrizations = nn.Module()
        self.parametrizations.weight = _WeightParts(in_features, out_features,
                                                    device)
        self.bias = nn.Parameter(torch.empty(out_features, device=device))

    def forward(self, x):
        """Under tensor parallelism (the output dim K sharded) each rank's
        rows of v are normalised where they lie, and the (rows, K) output is
        gathered."""
        parts = self.parametrizations.weight

        def body(x, g, v, bias, rank, size):
            g, v = g.float(), v.float()
            weight = g * v / (torch.linalg.vector_norm(v, dim=1, keepdim=True) + 1e-12)
            return F.linear(x.float(), weight, bias.float())

        return run(axis_of(self), body, (x,), (parts.original0, parts.original1, self.bias),
                   (0, 0, 0), "cat")

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """v and bias as an ``nn.Linear``'s under the init scheme; g = ‖v‖
        per output unit."""
        v = self.parametrizations.weight.original1
        weight_(v, self.init_scheme, generator)
        bias_(self.bias, v.shape[1], self.init_scheme, generator)
        self.parametrizations.weight.original0.copy_(
            torch.linalg.vector_norm(v, dim=1, keepdim=True))
        return self


def _gelu_erf(x):
    return x * 0.5 * (1.0 + torch.erf(x * 0.7071067811865476))


class DINOHead(nn.Module):
    """3-layer GELU MLP → fp32 L2-normalise → fp32 weight-norm Linear."""

    def __init__(self, embed_dim: int, output_dim: int, hidden_dim: int = 2048,
                 dtype: torch.dtype = torch.float32, device=None,
                 init_scheme: str = "reference"):
        super().__init__()
        self.dtype = dtype
        self.init_scheme = check_scheme(init_scheme)
        self.mlp = nn.Sequential(
            nn.Linear(embed_dim, hidden_dim, device=device),
            nn.GELU(),
            nn.Linear(hidden_dim, hidden_dim, device=device),
            nn.GELU(),
            nn.Linear(hidden_dim, embed_dim, device=device),
        )
        self.fully_connected = WeightNormDense(embed_dim, output_dim, device,
                                               init_scheme)

    def forward(self, x):
        """Under tensor parallelism (JAX's rule rows) ``mlp.0`` is
        column-parallel and ``mlp.2`` row-parallel (its partial outputs
        summed, its bias added once after), ``mlp.4`` column-parallel with
        its output gathered for the fp32 L2 normalise, which needs the whole
        row, and ``fully_connected`` gathers its (rows, K) output."""
        dt = self.dtype
        l0, l2, l4 = self.mlp[0], self.mlp[2], self.mlp[4]
        b2 = l2.bias.to(dt)

        def hidden(x, w0, b0, w2, rank, size):
            h = _gelu_erf(F.linear(x, w0.to(dt), b0.to(dt)))
            return F.linear(h, w2.to(dt), b2 if size == 1 else None)

        axis = axis_of(l0)
        x = run(axis, hidden, (x.to(dt),), (l0.weight, l0.bias, l2.weight), (0, 0, 1))
        x = _gelu_erf(x if axis is None else x + b2)
        x = run(axis_of(l4), linear_body, (x,), (l4.weight, l4.bias), (0, 0), "cat")
        x32 = x.float()
        x = (x32 / torch.clamp(torch.linalg.vector_norm(x32, dim=1, keepdim=True),
                               min=1e-12)).to(dt)
        return self.fully_connected(x)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for i in (0, 2, 4):
            linear_(self.mlp[i], self.init_scheme, generator)
        self.fully_connected.reset_parameters(generator)
        return self


class DINONetwork(nn.Module):
    """Backbone + projection head: the student, or the teacher."""

    def __init__(self, num_blocks: int, input_shape: Tuple[int, int, int],
                 embed_dim: int, patch_size: int, num_heads: int = 8,
                 mlp_dim: int = 3072, dropout: float = 0.1,
                 output_dim: int = 65536, dtype: torch.dtype = torch.float32,
                 fast_dropout: bool = True, use_fused_mlp: bool = False,
                 use_flash: bool = True, init_scheme: str = "reference",
                 remat: bool = False, scan_layers: bool = False, device=None):
        super().__init__()
        self.backbone = ViTBackbone(
            num_blocks, input_shape, embed_dim, patch_size, num_heads, mlp_dim,
            dtype=dtype, dropout=dropout, fast_dropout=fast_dropout,
            use_fused_mlp=use_fused_mlp, use_flash=use_flash,
            init_scheme=init_scheme, remat=remat, scan_layers=scan_layers,
            device=device,
        )
        self.head = DINOHead(embed_dim, output_dim, dtype=dtype, device=device,
                             init_scheme=init_scheme)

    def forward(self, x, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        return self.head(self.backbone(x, deterministic, generator))

    def forward_packed(self, x, num_views: int, deterministic: bool = True,
                       generator: Optional[torch.Generator] = None):
        """Multi-crop views packed into block-diagonal sequences: the
        view-major (V·B, h, w, C) crops of each image become one length-V·N
        sequence after patch embedding, with a block mask keeping crops
        apart. Output (V·B, K), view-major, as the unpacked forward."""
        tokens = self.backbone.embed(x)  # (V·B, N, D)
        vb, n, d = tokens.shape
        b = vb // num_views
        packed = (tokens.reshape(num_views, b, n, d).transpose(0, 1)
                  .reshape(b, num_views * n, d))
        enc = self.backbone.encode(packed, n, deterministic, generator)
        cls = (enc.reshape(b, num_views, n, d)[:, :, 0]  # (B, V, D)
               .transpose(0, 1).reshape(vb, d))
        return self.head(cls)

    def features(self, x):
        """Backbone CLS features (the teacher-side inference path)."""
        return self.backbone(x, True)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.backbone.reset_parameters(generator)
        self.head.reset_parameters(generator)
        return self


# ---------------------------------------------------------------------------
# DINO's dynamics: loss, center, EMA, schedules


def dino_loss(teacher_output, student_output, center, teacher_temp: float,
              student_temp: float):
    """Teacher (Vt, B, K) and student (Vs, B, K) outputs: the centred,
    sharpened teacher softmax against the student log-softmax, summed over
    student views and averaged over the rest (the same-view pair kept, as
    in the reference)."""
    t = teacher_output.detach().float()
    sp = F.log_softmax(student_output.float() / student_temp, dim=-1)
    tp = F.softmax((t - center[None]) / teacher_temp, dim=-1)
    return -(tp * sp.sum(dim=0)[None]).mean()


def update_center(center, teacher_output, center_momentum: float, weight=None):
    """EMA of the center (1, K) toward the batch mean of the teacher output,
    flattened to (rows, K); ``weight`` (rows,) excludes padding rows. Under
    data parallelism the mean is the global batch's: the weighted sum and
    the weight sum go through one all-reduce over the data axis."""
    flat = teacher_output.reshape(-1, teacher_output.shape[-1]).float()
    w = (torch.ones(flat.shape[0], 1, device=flat.device) if weight is None
         else weight.reshape(-1, 1).float())
    sums = dp_sum(torch.cat([(flat * w).sum(dim=0), w.sum().reshape(1)]))
    if weight is None:
        batch_mean = sums[None, :-1] / sums[-1]
    else:
        batch_mean = sums[None, :-1] / torch.clamp(sums[-1], min=1.0)
    return center_momentum * center + (1.0 - center_momentum) * batch_mean


@torch.no_grad()
def momentum_update(teacher: nn.Module, student: nn.Module, momentum: float):
    """teacher ← momentum·teacher + (1 − momentum)·student, every parameter,
    in place; under ``parallel.fsdp`` chunk to chunk
    (:func:`..parallel.fsdp.local_tensors`), under tensor parallelism shard
    to shard (the teacher is sharded as the student)."""
    t = local_tensors(teacher)
    s = local_tensors(student)
    torch._foreach_mul_(t, momentum)
    torch._foreach_add_(t, torch._foreach_mul(s, 1.0 - momentum))


def cosine_momentum_schedule(step, m_start: float, m_end: float,
                             total_iters: int) -> float:
    """m_end − (m_end − m_start)·(1 + cos(π·step/T))/2, m_end from T on."""
    if step >= total_iters:
        return float(m_end)
    cos_term = math.cos(math.pi * step / total_iters)
    return m_end - (m_end - m_start) * 0.5 * (1.0 + cos_term)


def teacher_temp_schedule(step, t_start: float, t_end: float, total_iters: int,
                          schedule_type: str = "cosine") -> float:
    """The teacher temperature, linear or cosine from t_start to t_end over
    ``total_iters``, t_end from there on."""
    if step >= total_iters:
        return float(t_end)
    progress = step / total_iters
    if schedule_type == "linear":
        return t_start + (t_end - t_start) * progress
    return t_end - (t_end - t_start) * 0.5 * (1.0 + math.cos(math.pi * progress))
