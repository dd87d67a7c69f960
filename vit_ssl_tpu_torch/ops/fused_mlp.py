"""Fused Linear → exact GELU (→ dropout) → Linear, forward and gradient.

Port of ``vit_ssl_tpu/ops/fused_mlp.py`` (kernel B4). :func:`fused_mlp` is
a ``torch.autograd.Function`` over (T, d_in) tokens; on a CUDA tensor it
launches the hand-written Hopper kernels:

- ``fused_mlp_fwd`` (``csrc/fused_mlp_fwd.cu``), the forward when no
  gradient is wanted (serving, ``eval_step``, the DINO teacher under
  ``no_grad``), with or without a keep-mask;
- ``fused_mlp_fwd_pre`` (same source), the training forward: the same
  output bit for bit, plus the pre-activation saved in x's dtype;
- ``fused_mlp_bwd`` (``csrc/fused_mlp_bwd.cu``), the backward: dx and the
  four weight and bias gradients, no atomics.

In bfloat16 each entry runs wgmma/TMA products with the GELU, dropout and
GELU' in their epilogues (``csrc/mlp_gemm_sm90.cuh``; the kernels by name
in :data:`HOPPER_BODIES`): the forward two, through a (T, d_ff) scratch h
that the wrapper allocates; the backward three and an ordered reduction of
its weight gradients' slices. float32 runs CUDA-core bodies.

On a CPU tensor the same Function runs the plain PyTorch versions,
:func:`fused_mlp_reference` and :func:`fused_mlp_bwd_reference`. There is
no fallback from one to the other: a CUDA call that a kernel cannot take
raises.

The weights are taken in the ``nn.Linear`` (out, in) layout the module
holds: w1 (d_ff, d_in), w2 (d_in, d_ff). The JAX function takes them as
(in, out); the tests transpose. Rounding points are the JAX kernels'
(``vit_ssl_tpu/ops/fused_mlp.py:72-114``, ``:198-230``), and erf is
PyTorch's (the kernels' ``erff``) where the JAX package uses the
Abramowitz–Stegun polynomial (|error| ≤ 1.5e-7).

The kernels take d_in 384, 768 and 1024 (ViT-S, ViT-B and ViT-L) and d_ff
a multiple of 128; any other d_in is refused with a ``ValueError``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import kernels

KERNEL = "fused_mlp_fwd"  # forward, no pre saved
KERNEL_TRAIN = "fused_mlp_fwd_pre"  # training forward, in KERNEL's library
KERNEL_BWD = "fused_mlp_bwd"
# the bf16 entries' Hopper kernels (csrc/mlp_gemm_sm90.cuh), by entry: the
# forward's fc1 (pre, h) and fc2 (out); the backward's dh (dpre, h), dx and
# the weight gradients' slices, which weight_grad.cuh's reduce_splits adds
HOPPER_BODIES = {
    KERNEL: ("mlp_fc1_sm90_kernel", "mlp_fc2_sm90_kernel"),
    KERNEL_TRAIN: ("mlp_fc1_sm90_kernel", "mlp_fc2_sm90_kernel"),
    KERNEL_BWD: ("mlp_dh_sm90_kernel", "mlp_dx_sm90_kernel", "mlp_wgrad_sm90_kernel"),
}
D_MODELS = (384, 768, 1024)
D_FF_MULTIPLE = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SQRT2_INV = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


def _gelu_exact(x):
    """x · 0.5 · (1 + erf(x/√2)), in the JAX package's order."""
    return x * 0.5 * (1.0 + torch.erf(x * _SQRT2_INV))


def _gelu_grad(x):
    """Φ(x) + x·φ(x), in the JAX package's order."""
    cdf = 0.5 * (1.0 + torch.erf(x * _SQRT2_INV))
    pdf = _INV_SQRT_2PI * torch.exp(-0.5 * x * x)
    return cdf + x * pdf


def _scale(mask, keep_prob: float):
    """The fp32 dropout factor mask / keep_prob (0 or 1/keep_prob)."""
    return mask.float() / keep_prob


def fused_mlp_reference(x, w1, b1, w2, b2, mask=None, keep_prob: float = 1.0,
                        save_pre: bool = False):
    """Plain PyTorch version of the forward, with the JAX kernels' rounding
    points: pre = x·w1ᵀ + b1 in fp32; GELU on the unrounded fp32 pre; with a
    mask, h·(mask/keep_prob) in fp32; h rounded to x's dtype before the
    second product; out = h·w2ᵀ + b2 in fp32, rounded to x's dtype.

    Returns out, or (out, pre rounded to x's dtype) with ``save_pre``."""
    dtype = x.dtype
    pre = torch.matmul(x.float(), w1.float().t()) + b1.float()
    h = _gelu_exact(pre)
    if mask is not None:
        h = h * _scale(mask, keep_prob)
    out = (torch.matmul(h.to(dtype).float(), w2.float().t()) + b2.float()).to(dtype)
    return (out, pre.to(dtype)) if save_pre else out


def fused_mlp_bwd_reference(x, pre, do, w1, w2, mask=None, keep_prob: float = 1.0):
    """Plain version of the backward with the JAX kernel's rounding points:
    ``do`` cast to x's dtype; GELU and GELU′ of the saved (rounded) pre;
    h·scale rounded to x's dtype for dw2 = doᵀ·h and db2 = Σ do; dh = do·w2
    times the scale; dpre = dh·GELU′(pre) rounded to x's dtype; dw1 =
    dpreᵀ·x, db1 = Σ dpre, dx = dpre·w1; fp32 sums throughout.

    Returns (dx, dw1, db1, dw2, db2), all in x's dtype, the weight
    gradients in the ``nn.Linear`` layout of w1 and w2."""
    dtype = x.dtype
    g = do.to(dtype).float()
    p = pre.float()
    h = _gelu_exact(p)
    dh = torch.matmul(g, w2.float())
    if mask is not None:
        scale = _scale(mask, keep_prob)
        h = h * scale
        dh = dh * scale
    h = h.to(dtype).float()
    dpre = (dh * _gelu_grad(p)).to(dtype).float()
    dx = torch.matmul(dpre, w1.float())
    dw1 = torch.matmul(dpre.t(), x.float())
    dw2 = torch.matmul(g.t(), h)
    return (dx.to(dtype), dw1.to(dtype), dpre.sum(0).to(dtype), dw2.to(dtype),
            g.sum(0).to(dtype))


def _check(x, w1, w2, mask, **others) -> None:
    """Validate what the kernels take: x (T, d_in), w1 (d_ff, d_in), w2
    (d_in, d_ff) and an optional (T, d_ff) bool keep-mask; ``others`` by
    name: b1 (d_ff,), b2 (d_in,), pre (T, d_ff), do (T, d_in)."""
    if x.dim() != 2 or w1.dim() != 2:
        raise ValueError(f"expected (T, d_in) tokens and a 2-D w1, got shapes "
                         f"{tuple(x.shape)} and {tuple(w1.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"dtype {x.dtype} not supported (float32, bfloat16)")
    t, d = x.shape
    d_ff = w1.shape[0]
    if d not in D_MODELS or d_ff < D_FF_MULTIPLE or d_ff % D_FF_MULTIPLE:
        raise ValueError(
            f"the fused MLP kernels take d_in {D_MODELS} and d_ff a multiple of "
            f"{D_FF_MULTIPLE}, not d_in {d}, d_ff {d_ff}")
    if t < 1:
        raise ValueError("the fused MLP kernels need at least one token")
    shapes = {"w1": (d_ff, d), "w2": (d, d_ff), "b1": (d_ff,), "b2": (d,),
              "pre": (t, d_ff), "do": (t, d)}
    tensors = {"w1": w1, "w2": w2, **others}
    for name, y in tensors.items():
        if tuple(y.shape) != shapes[name] or y.dtype != x.dtype or y.device != x.device:
            raise ValueError(
                f"{name} {tuple(y.shape)} {y.dtype} {y.device} does not match x "
                f"{tuple(x.shape)} {x.dtype} {x.device} (want {shapes[name]}; "
                "weights in the nn.Linear layout)")
    tensors["x"] = x
    if mask is not None:
        if (tuple(mask.shape) != (t, d_ff) or mask.dtype not in (torch.bool, torch.uint8)
                or mask.device != x.device):
            raise ValueError(f"mask {tuple(mask.shape)} {mask.dtype} is not a "
                             f"(T, d_ff) = {(t, d_ff)} bool keep-mask on {x.device}")
        tensors["mask"] = mask
    if not all(y.is_contiguous() for y in tensors.values()):
        raise ValueError("x, the weights, pre, do and the mask must be contiguous")
    if any(y.data_ptr() % 16 for y in tensors.values()):
        raise ValueError("x, the weights, pre, do and the mask must start 16-byte "
                         "aligned (the kernels copy 16 bytes a thread)")


@functools.cache
def _kernel_fn(entry: str):
    """A C entry point, its library built and loaded at first use."""
    p, i = ctypes.c_void_p, ctypes.c_int
    if entry == KERNEL_BWD:
        fn = kernels.load(KERNEL_BWD).fused_mlp_bwd
        fn.argtypes = [p] * 14 + [i] * 4 + [ctypes.c_float, p]
    else:
        fn = getattr(kernels.load(KERNEL), entry)
        pointers = 9 if entry == KERNEL_TRAIN else 8  # the last: the scratch h
        fn.argtypes = [p] * pointers + [i] * 4 + [ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _partial_floats(d: int, d_ff: int) -> int:
    """The fp32 scratch ``fused_mlp_bwd`` sums its weight gradients in."""
    fn = kernels.load(KERNEL_BWD).fused_mlp_bwd_partial_floats
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return fn(d, d_ff)


def _launch(entry: str, device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _kernel_fn(entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    kernels.launches[entry] += 1


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _scratch_h(x, d_ff: int) -> Optional[torch.Tensor]:
    """The (T, d_ff) activation that the bf16 forward's two products pass
    through device memory; float32 takes none."""
    if x.dtype != torch.bfloat16:
        return None
    return torch.empty(x.shape[0], d_ff, device=x.device, dtype=x.dtype)


def _require_cuda(x) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp runs on cuda or cpu, not {x.device}")


def fused_mlp_fwd(x, w1, b1, w2, b2, mask=None, keep_prob: float = 1.0,
                  save_pre: bool = False):
    """The forward: kernel ``fused_mlp_fwd`` (or, with ``save_pre``,
    ``fused_mlp_fwd_pre``, which also returns pre) on a CUDA tensor,
    :func:`fused_mlp_reference` on a CPU tensor. In bfloat16 the kernels
    pass the activation h through (T, d_ff) scratch allocated here."""
    if x.device.type == "cpu":
        return fused_mlp_reference(x, w1, b1, w2, b2, mask, keep_prob, save_pre)
    _require_cuda(x)
    _check(x, w1, w2, mask, b1=b1, b2=b2)
    t, d = x.shape
    d_ff = w1.shape[0]
    out = torch.empty_like(x)
    pre = torch.empty(t, d_ff, device=x.device, dtype=x.dtype) if save_pre else None
    h = _scratch_h(x, d_ff)
    ptrs = [x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            _ptr(mask), out.data_ptr()]
    if save_pre:
        ptrs.append(pre.data_ptr())
    ptrs.append(_ptr(h))
    _launch(KERNEL_TRAIN if save_pre else KERNEL, x.device, *ptrs, t, d, d_ff,
            _DTYPES[x.dtype], float(keep_prob))
    return (out, pre) if save_pre else out


def fused_mlp_bwd(x, pre, do, w1, w2, mask=None, keep_prob: float = 1.0):
    """(dx, dw1, db1, dw2, db2) of :func:`fused_mlp` for the upstream
    gradient ``do``, all in x's dtype. On a CUDA tensor kernel
    ``fused_mlp_bwd`` (``do`` is cast to x's dtype and made contiguous
    here, never in the kernel); on a CPU tensor
    :func:`fused_mlp_bwd_reference`."""
    if x.device.type == "cpu":
        return fused_mlp_bwd_reference(x, pre, do, w1, w2, mask, keep_prob)
    _require_cuda(x)
    t, d = x.shape
    d_ff = w1.shape[0]
    do = do.to(x.dtype).contiguous()
    _check(x, w1, w2, mask, pre=pre, do=do)
    dx = torch.empty_like(x)
    dw1, dw2 = torch.empty_like(w1), torch.empty_like(w2)
    db1 = torch.empty(d_ff, device=x.device, dtype=x.dtype)
    db2 = torch.empty(d, device=x.device, dtype=x.dtype)
    # scratch: dpre and h between the first kernel and the weight kernel,
    # the weight kernel's fp32 partial sums
    dpre = torch.empty(t, d_ff, device=x.device, dtype=x.dtype)
    h = torch.empty_like(dpre)
    partial = torch.empty(_partial_floats(d, d_ff), device=x.device,
                          dtype=torch.float32)
    _launch(KERNEL_BWD, x.device, x.data_ptr(), pre.data_ptr(), do.data_ptr(),
            w1.data_ptr(), w2.data_ptr(), _ptr(mask), dx.data_ptr(), dw1.data_ptr(),
            db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(), dpre.data_ptr(),
            h.data_ptr(), partial.data_ptr(), t, d, d_ff, _DTYPES[x.dtype],
            float(keep_prob))
    return dx, dw1, db1, dw2, db2


class _FusedMLP(torch.autograd.Function):
    """Kernel B4 with its gradient: the training forward saves pre, the
    backward takes it (each the plain version on a CPU tensor)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, mask, keep_prob):
        out, pre = fused_mlp_fwd(x, w1, b1, w2, b2, mask, keep_prob, save_pre=True)
        ctx.save_for_backward(x, pre, w1, w2, mask)
        ctx.keep_prob = keep_prob
        return out

    @staticmethod
    def backward(ctx, do):
        x, pre, w1, w2, mask = ctx.saved_tensors
        return (*fused_mlp_bwd(x, pre, do, w1, w2, mask, ctx.keep_prob), None, None)


def _wants_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def fused_mlp(x, w1, b1, w2, b2, mask=None, keep_prob: float = 1.0):
    """GELU(x·w1ᵀ + b1) [· mask/keep_prob] · w2ᵀ + b2 over (T, d_in) tokens,
    in x's dtype, with a gradient when an input requires one. ``mask``: an
    optional (T, d_ff) bool keep-mask (True = keep).

    On the card: the training forward and backward kernels when a gradient
    is wanted, the forward kernel otherwise. On the CPU: the plain
    versions."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_mlp runs on cuda or cpu, not {x.device}")
    if not _wants_grad(x, w1, b1, w2, b2):
        return fused_mlp_fwd(x, w1, b1, w2, b2, mask, keep_prob)
    return _FusedMLP.apply(x, w1, b1, w2, b2, mask, keep_prob)

