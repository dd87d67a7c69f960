"""Dropout-masked second FFN product, forward and gradient (kernel P2).

Port of ``scripts/dropout_epilogue_probe.py::masked_matmul``:
o = (h · mask / keep_prob) · w2ᵀ + b2 over (T, d_ff) activations, the
keep-mask applied while h is loaded for the product, so the masked
activation never reaches device memory as a tensor of its own.
:func:`masked_matmul` is a ``torch.autograd.Function``; on a CUDA tensor it
launches the hand-written Hopper kernels of ``csrc/masked_matmul.cu``:

- ``masked_mm_fwd``, the forward;
- ``masked_mm_bwd``, the backward: dh, dw2 and db2, three kernels and no
  atomics (the mask gets no gradient).

In bfloat16 each entry runs kernel B4's wgmma/TMA product
(``csrc/mlp_gemm_sm90.cuh``; the kernels by name in :data:`HOPPER_BODIES`)
with h scaled by mask / keep_prob between the TMA copy that lands its tile
and the tensor cores that read it: the forward is B4's second product with
h masked in registers on its way in; the backward is B4's dh product with a
mask-only epilogue, and B4's weight product with h rewritten masked in
shared memory, summed over fixed slices of T into fp32 scratch and added
in slice order. What bounds both is bytes: at the DINO student-globals FFN
(T = 37120, 1536 → 384) about 0.060 ms forward and 0.094 ms backward at
3.35 TB/s. float32 runs CUDA-core bodies.

On a CPU tensor the same Function runs the plain PyTorch versions,
:func:`masked_matmul_reference` and :func:`masked_matmul_bwd_reference`.
There is no fallback from one to the other: a CUDA call that the kernels
cannot take raises.

w2 is taken in the ``nn.Linear`` (d_out, d_ff) layout, as :mod:`.fused_mlp`
takes it; the JAX function takes (d_ff, d_out), and the tests transpose.
The JAX package does not wire its kernel into the FFN, and neither does
the port: the dropout-epilogue probe
(``vit_ssl_tpu_torch/scripts/dropout_epilogue_probe.py``) is its path.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels

LIBRARY = "masked_matmul"
KERNEL = "masked_mm_fwd"
KERNEL_BWD = "masked_mm_bwd"
# the bf16 entries' Hopper kernels (defined in csrc/masked_matmul.cu on
# csrc/mlp_gemm_sm90.cuh's product), by entry: the forward's masked
# product; the backward's dh and the weight gradients' slices, which
# weight_grad.cuh's reduce_splits adds
HOPPER_BODIES = {
    KERNEL: ("masked_mm_fwd_sm90_kernel",),
    KERNEL_BWD: ("masked_mm_dh_sm90_kernel", "masked_mm_wgrad_sm90_kernel"),
}
DIM_MULTIPLE = 128  # d_ff and d_out
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _scale(mask, keep_prob: float):
    """The fp32 dropout factor mask / keep_prob (0 or 1/keep_prob)."""
    return mask.float() / keep_prob


def masked_matmul_reference(h, mask, w2, b2, keep_prob: float):
    """Plain PyTorch version of the forward, at the JAX kernel's rounding
    points: h·(mask/keep_prob) in fp32, rounded to h's dtype; the product
    with fp32 sums; + b2 in fp32; rounded to h's dtype."""
    dtype = h.dtype
    hm = (h.float() * _scale(mask, keep_prob)).to(dtype)
    return (torch.matmul(hm.float(), w2.float().t()) + b2.float()).to(dtype)


def masked_matmul_bwd_reference(h, mask, do, w2, keep_prob: float):
    """Plain version of the backward, at the JAX kernel's rounding points:
    ``do`` cast to h's dtype; hm = h·(mask/keep_prob) rounded to h's dtype;
    dw2 = doᵀ·hm and db2 = Σ do with fp32 sums, in w2's dtype (the
    ``nn.Linear`` layout); dh = (do·w2)·mask/keep_prob in fp32, rounded to
    h's dtype. Returns (dh, dw2, db2)."""
    dtype = h.dtype
    g = do.to(dtype).float()
    scale = _scale(mask, keep_prob)
    hm = (h.float() * scale).to(dtype).float()
    dh = (torch.matmul(g, w2.float()) * scale).to(dtype)
    dw2 = torch.matmul(g.t(), hm).to(w2.dtype)
    return dh, dw2, g.sum(0).to(w2.dtype)


def _check(h, mask, w2, **others) -> None:
    """Validate what the kernels take: h (T, d_ff), a (T, d_ff) bool or
    uint8 keep-mask, w2 (d_out, d_ff); ``others`` by name: b2 (d_out,), do
    (T, d_out)."""
    if h.dim() != 2 or w2.dim() != 2:
        raise ValueError(f"expected (T, d_ff) activations and a 2-D w2, got shapes "
                         f"{tuple(h.shape)} and {tuple(w2.shape)}")
    if h.dtype not in _DTYPES:
        raise ValueError(f"dtype {h.dtype} not supported (float32, bfloat16)")
    t, d_ff = h.shape
    d_out = w2.shape[0]
    if t < 1:
        raise ValueError("the masked matmul kernels need at least one token")
    if min(d_ff, d_out) < DIM_MULTIPLE or d_ff % DIM_MULTIPLE or d_out % DIM_MULTIPLE:
        raise ValueError(f"the masked matmul kernels take d_ff and d_out multiples of "
                         f"{DIM_MULTIPLE}, not d_ff {d_ff}, d_out {d_out}")
    shapes = {"w2": (d_out, d_ff), "b2": (d_out,), "do": (t, d_out)}
    for name, y in {"w2": w2, **others}.items():
        if tuple(y.shape) != shapes[name] or y.dtype != h.dtype or y.device != h.device:
            raise ValueError(
                f"{name} {tuple(y.shape)} {y.dtype} {y.device} does not match h "
                f"{tuple(h.shape)} {h.dtype} {h.device} (want {shapes[name]}; w2 in "
                "the nn.Linear layout)")
    if (tuple(mask.shape) != (t, d_ff) or mask.dtype not in (torch.bool, torch.uint8)
            or mask.device != h.device):
        raise ValueError(f"mask {tuple(mask.shape)} {mask.dtype} is not a (T, d_ff) = "
                         f"{(t, d_ff)} bool or uint8 keep-mask on {h.device}")
    tensors = [h, mask, w2, *others.values()]
    if not all(y.is_contiguous() for y in tensors):
        raise ValueError("h, the mask, w2, b2 and do must be contiguous")
    if any(y.data_ptr() % 16 for y in tensors):
        raise ValueError("h, the mask, w2, b2 and do must start 16-byte aligned "
                         "(the kernels copy 16 bytes a thread)")


@functools.cache
def _kernel_fn(entry: str):
    """A C entry point, its library built and loaded at first use."""
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = getattr(kernels.load(LIBRARY), entry)
    pointers = 8 if entry == KERNEL_BWD else 5
    fn.argtypes = [p] * pointers + [i] * 4 + [ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _partial_floats(d_ff: int, d_out: int) -> int:
    """The fp32 scratch ``masked_mm_bwd`` sums dw2 and db2 in."""
    fn = kernels.load(LIBRARY).masked_mm_bwd_partial_floats
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return fn(d_ff, d_out)


def _launch(entry: str, device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _kernel_fn(entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    kernels.launches[entry] += 1


def _require_cuda(h) -> None:
    if h.device.type != "cuda":
        raise ValueError(f"masked_matmul runs on cuda or cpu, not {h.device}")


def masked_matmul_fwd(h, mask, w2, b2, keep_prob: float):
    """The forward: kernel ``masked_mm_fwd`` on a CUDA tensor,
    :func:`masked_matmul_reference` on a CPU tensor."""
    if h.device.type == "cpu":
        return masked_matmul_reference(h, mask, w2, b2, keep_prob)
    _require_cuda(h)
    _check(h, mask, w2, b2=b2)
    t, d_ff = h.shape
    d_out = w2.shape[0]
    out = torch.empty(t, d_out, device=h.device, dtype=h.dtype)
    _launch(KERNEL, h.device, h.data_ptr(), mask.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), t, d_ff, d_out, _DTYPES[h.dtype], float(keep_prob))
    return out


def masked_matmul_bwd(h, mask, do, w2, keep_prob: float):
    """(dh, dw2, db2) of :func:`masked_matmul` for the upstream gradient
    ``do``: kernel ``masked_mm_bwd`` on a CUDA tensor (``do`` is cast to h's
    dtype and made contiguous here, never in the kernel),
    :func:`masked_matmul_bwd_reference` on a CPU tensor."""
    if h.device.type == "cpu":
        return masked_matmul_bwd_reference(h, mask, do, w2, keep_prob)
    _require_cuda(h)
    do = do.to(h.dtype).contiguous()
    _check(h, mask, w2, do=do)
    t, d_ff = h.shape
    d_out = w2.shape[0]
    dh = torch.empty_like(h)
    dw2 = torch.empty_like(w2)
    db2 = torch.empty(d_out, device=h.device, dtype=h.dtype)
    partial = torch.empty(_partial_floats(d_ff, d_out), device=h.device,
                          dtype=torch.float32)
    _launch(KERNEL_BWD, h.device, h.data_ptr(), mask.data_ptr(), do.data_ptr(),
            w2.data_ptr(), dh.data_ptr(), dw2.data_ptr(), db2.data_ptr(),
            partial.data_ptr(), t, d_ff, d_out, _DTYPES[h.dtype], float(keep_prob))
    return dh, dw2, db2


class _MaskedMatmul(torch.autograd.Function):
    """Kernel P2 with its gradient (the plain versions on a CPU tensor)."""

    @staticmethod
    def forward(ctx, h, mask, w2, b2, keep_prob):
        ctx.save_for_backward(h, mask, w2)
        ctx.keep_prob = keep_prob
        return masked_matmul_fwd(h, mask, w2, b2, keep_prob)

    @staticmethod
    def backward(ctx, do):
        h, mask, w2 = ctx.saved_tensors
        dh, dw2, db2 = masked_matmul_bwd(h, mask, do, w2, ctx.keep_prob)
        return dh, None, dw2, db2, None


def masked_matmul(h, mask, w2, b2, keep_prob: float):
    """(h · mask/keep_prob) · w2ᵀ + b2 over (T, d_ff) activations, in h's
    dtype, with a gradient for h, w2 and b2 when one requires it. ``mask``:
    a (T, d_ff) bool or uint8 keep-mask (nonzero = keep)."""
    kernels.refuse_dtensor("masked_matmul", h=h, mask=mask, w2=w2, b2=b2)
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"masked_matmul runs on cuda or cpu, not {h.device}")
    if not (torch.is_grad_enabled() and any(x.requires_grad for x in (h, w2, b2))):
        return masked_matmul_fwd(h, mask, w2, b2, keep_prob)
    return _MaskedMatmul.apply(h, mask, w2, b2, keep_prob)
