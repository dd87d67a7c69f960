"""Multi-head attention on the projections' native (B, N, H·D) layout.

Port of ``vit_ssl_tpu/ops/flash_attention.py::attention_nhd`` (kernel B1):
the forward and its gradient. :func:`attention_nhd` is a
``torch.autograd.Function``; on a CUDA tensor it launches the hand-written
Hopper kernels:

- ``attention_nhd_fwd`` (``csrc/attention_nhd_fwd.cu``), the inference
  forward, when no gradient is wanted (serving under ``inference_mode``,
  the DINO teacher under ``no_grad``);
- ``attention_nhd_fwd_stats`` (same source), the training forward: the same
  output bit for bit, plus each row's softmax statistics (row max m and
  1/l, fp32). They replace the (B, H, N, N) probabilities that the TPU
  kernel saves for its backward;
- ``attention_nhd_bwd`` (``csrc/attention_nhd_bwd.cu``), the backward: it
  rebuilds the forward's rounded probabilities from q, k and the
  statistics and returns dq, dk and dv.

On a CPU tensor the same Function runs the plain PyTorch versions,
:func:`attention_nhd_reference` forward and
:func:`attention_nhd_bwd_reference` backward. There is no fallback from one
to the other: a CUDA call that a kernel cannot take raises.

The JAX package gates its kernel with TPU measurements
(``attention_nhd_profitable``); the port carries no such gate — on the card
every self-attention call without ``return_attn`` goes to the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels

KERNEL = "attention_nhd_fwd"  # inference forward
KERNEL_TRAIN = "attention_nhd_fwd_stats"  # training forward, in KERNEL's library
KERNEL_BWD = "attention_nhd_bwd"
MAX_SEQ = 1024  # the JAX single-tile ceiling (MAX_FUSED_SEQ)
HEAD_DIMS = (32, 64, 128)
STATS_ROWS = 64  # the statistics' rows per (b, h) are padded to this multiple
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _heads(x, num_heads: int):
    """(B, N, H·D) -> (B, H, N, D) fp32."""
    b, n, hd = x.shape
    return x.reshape(b, n, num_heads, hd // num_heads).transpose(1, 2).float()


def _unheads(x, dtype):
    """(B, H, N, D) -> (B, N, H·D) in ``dtype``."""
    b, h, n, d = x.shape
    return x.to(dtype).transpose(1, 2).reshape(b, n, h * d)


def _scores(xq, xk, num_heads: int, scale: float, block_size: int):
    """fp32 scaled scores (B, H, N, N), -inf off the diagonal blocks."""
    s = torch.matmul(_heads(xq, num_heads),
                     _heads(xk, num_heads).transpose(-1, -2)) * scale
    if block_size:
        n = xq.shape[1]
        row = torch.arange(n, device=xq.device)[:, None] // block_size
        col = torch.arange(n, device=xq.device)[None, :] // block_size
        s = s.masked_fill(row != col, float("-inf"))
    return s


def _probs(xq, xk, num_heads: int, scale: float, block_size: int):
    """The normalised probabilities rounded to the input dtype, as fp32."""
    s = _scores(xq, xk, num_heads, scale, block_size)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return (p / p.sum(dim=-1, keepdim=True)).to(xq.dtype).float()


def attention_nhd_reference(xq, xk, xv, num_heads: int, scale: float,
                            block_size: int = 0):
    """Plain PyTorch version of the forward: fp32 scores scaled by
    ``scale``, optional block-diagonal mask (``i//bs == j//bs``), fp32
    softmax whose normalised probabilities are cast to the input dtype
    before P·V, fp32 accumulation, output in the input dtype."""
    o = torch.matmul(_probs(xq, xk, num_heads, scale, block_size),
                     _heads(xv, num_heads))
    return _unheads(o, xq.dtype)


def attention_nhd_stats_reference(xq, xk, num_heads: int, scale: float,
                                  block_size: int = 0):
    """Plain version of the training forward's statistics: fp32
    (B, H, N, 2) holding each row's max m of the scaled, masked scores and
    1/l, l = Σⱼ exp(s − m)."""
    s = _scores(xq, xk, num_heads, scale, block_size)
    m = s.amax(dim=-1)
    inv_l = 1.0 / torch.exp(s - m[..., None]).sum(dim=-1)
    return torch.stack([m, inv_l], dim=-1)


def attention_nhd_bwd_reference(xq, xk, xv, do, num_heads: int, scale: float,
                                block_size: int = 0):
    """Plain version of the backward with JAX's rounding points
    (``_nhd_bwd_kernel``, ``vit_ssl_tpu/ops/flash_attention.py:396-423``):
    ``do`` cast to the input dtype; p the normalised probabilities rounded
    to the input dtype; dv = pᵀ·do, dp = do·vᵀ, δ = Σⱼ p·dp,
    ds = (p·(dp − δ)·scale) rounded to the input dtype; dq = ds·k,
    dk = dsᵀ·q; fp32 accumulation, each result in the input dtype.
    Returns (dq, dk, dv) in (B, N, H·D)."""
    dtype = xq.dtype
    p = _probs(xq, xk, num_heads, scale, block_size)
    g = _heads(do.to(dtype), num_heads)
    dv = torch.matmul(p.transpose(-1, -2), g)
    dp = torch.matmul(g, _heads(xv, num_heads).transpose(-1, -2))
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(dtype).float()
    dq = torch.matmul(ds, _heads(xk, num_heads))
    dk = torch.matmul(ds.transpose(-1, -2), _heads(xq, num_heads))
    return _unheads(dq, dtype), _unheads(dk, dtype), _unheads(dv, dtype)


def _check(xq, xk, xv, num_heads: int, block_size: int) -> int:
    """Validate what the kernels take; returns the head dim."""
    for name, x in (("xk", xk), ("xv", xv)):
        if x.shape != xq.shape or x.dtype != xq.dtype or x.device != xq.device:
            raise ValueError(
                f"{name} {tuple(x.shape)} {x.dtype} {x.device} differs from "
                f"xq {tuple(xq.shape)} {xq.dtype} {xq.device}"
            )
    if xq.dim() != 3:
        raise ValueError(f"expected (B, N, H·D), got shape {tuple(xq.shape)}")
    if xq.dtype not in _DTYPES:
        raise ValueError(f"dtype {xq.dtype} not supported (float32, bfloat16)")
    if not all(x.is_contiguous() for x in (xq, xk, xv)):
        raise ValueError("q, k and v must be contiguous (B, N, H·D)")
    if any(x.data_ptr() % 16 for x in (xq, xk, xv)):
        raise ValueError("q, k and v must start 16-byte aligned (the kernel "
                         "reads 16 bytes a thread)")
    b, n, hd = xq.shape
    if num_heads < 1 or hd % num_heads:
        raise ValueError(f"H·D={hd} does not split into {num_heads} heads")
    d = hd // num_heads
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported (one of {HEAD_DIMS})")
    if not 1 <= n <= MAX_SEQ:
        raise ValueError(f"sequence length {n} outside 1..{MAX_SEQ}")
    if not 1 <= b <= 65535 or num_heads > 65535:
        raise ValueError(f"batch {b} / heads {num_heads} outside the grid limits")
    if block_size < 0:
        raise ValueError(f"block_size must be >= 0, got {block_size}")
    return d


def _stats_rows(n: int) -> int:
    return -(-n // STATS_ROWS) * STATS_ROWS


@functools.cache
def _kernel_fn(entry: str):
    """A C entry point, its library built and loaded at first use."""
    if entry == KERNEL_BWD:
        fn = kernels.load(KERNEL_BWD).attention_nhd_bwd
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
    else:
        fn = getattr(kernels.load(KERNEL), entry)
        pointers = 5 if entry == KERNEL_TRAIN else 4
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
    fn.restype = ctypes.c_int
    return fn


def _launch(entry: str, device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _kernel_fn(entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    kernels.launches[entry] += 1


def _require_cuda(x) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"attention_nhd runs on cuda or cpu, not {x.device}")


def attention_nhd_fwd(xq, xk, xv, num_heads: int, scale: float,
                      block_size: int = 0):
    """The inference forward: kernel ``attention_nhd_fwd`` on a CUDA
    tensor, :func:`attention_nhd_reference` on a CPU tensor."""
    if xq.device.type == "cpu":
        return attention_nhd_reference(xq, xk, xv, num_heads, scale, block_size)
    _require_cuda(xq)
    d = _check(xq, xk, xv, num_heads, block_size)
    b, n, _ = xq.shape
    out = torch.empty_like(xq)
    _launch(KERNEL, xq.device, xq.data_ptr(), xk.data_ptr(), xv.data_ptr(),
            out.data_ptr(), b, n, num_heads, d, _DTYPES[xq.dtype],
            float(scale), int(block_size))
    return out


def attention_nhd_fwd_stats(xq, xk, xv, num_heads: int, scale: float,
                            block_size: int = 0):
    """The training forward: (output, statistics). On a CUDA tensor kernel
    ``attention_nhd_fwd_stats``, whose output equals the inference kernel's
    bit for bit and whose statistics are fp32 (B, H, Np, 2), Np = N rounded
    up to 64, rows < N holding (m, 1/l) and the rest zero. On a CPU tensor
    the plain versions, statistics (B, H, N, 2)."""
    if xq.device.type == "cpu":
        return (attention_nhd_reference(xq, xk, xv, num_heads, scale, block_size),
                attention_nhd_stats_reference(xq, xk, num_heads, scale, block_size))
    _require_cuda(xq)
    d = _check(xq, xk, xv, num_heads, block_size)
    b, n, _ = xq.shape
    out = torch.empty_like(xq)
    stats = torch.zeros(b, num_heads, _stats_rows(n), 2, device=xq.device,
                        dtype=torch.float32)
    _launch(KERNEL_TRAIN, xq.device, xq.data_ptr(), xk.data_ptr(),
            xv.data_ptr(), out.data_ptr(), stats.data_ptr(), b, n, num_heads,
            d, _DTYPES[xq.dtype], float(scale), int(block_size))
    return out, stats


def attention_nhd_bwd(xq, xk, xv, do, stats, num_heads: int, scale: float,
                      block_size: int = 0):
    """(dq, dk, dv) of :func:`attention_nhd` for the upstream gradient
    ``do``. On a CUDA tensor kernel ``attention_nhd_bwd``, from the
    statistics of :func:`attention_nhd_fwd_stats` (``do`` is cast to the
    input dtype and made contiguous here, never in the kernel); on a CPU
    tensor :func:`attention_nhd_bwd_reference`, which needs no statistics."""
    if xq.device.type == "cpu":
        return attention_nhd_bwd_reference(xq, xk, xv, do, num_heads, scale,
                                           block_size)
    _require_cuda(xq)
    d = _check(xq, xk, xv, num_heads, block_size)
    b, n, _ = xq.shape
    do = do.to(xq.dtype).contiguous()
    if do.shape != xq.shape or do.device != xq.device or do.data_ptr() % 16:
        raise ValueError(f"do {tuple(do.shape)} {do.device} does not match "
                         f"xq {tuple(xq.shape)} {xq.device}")
    want = (b, num_heads, _stats_rows(n), 2)
    if (tuple(stats.shape) != want or stats.dtype != torch.float32
            or stats.device != xq.device or not stats.is_contiguous()):
        raise ValueError(f"stats {tuple(stats.shape)} {stats.dtype} are not "
                         f"the training forward's fp32 {want}")
    dq, dk, dv = (torch.empty_like(xq) for _ in range(3))
    delta = torch.zeros(want[:3], device=xq.device, dtype=torch.float32)
    _launch(KERNEL_BWD, xq.device, xq.data_ptr(), xk.data_ptr(), xv.data_ptr(),
            do.data_ptr(), stats.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), b, n, num_heads, d,
            _DTYPES[xq.dtype], float(scale), int(block_size))
    return dq, dk, dv


class _AttentionNHD(torch.autograd.Function):
    """Kernel B1 with its gradient. ``plain`` runs the plain versions,
    forward and backward, whatever the device."""

    @staticmethod
    def forward(ctx, xq, xk, xv, num_heads, scale, block_size, plain):
        if plain:
            out, stats = attention_nhd_reference(
                xq, xk, xv, num_heads, scale, block_size), None
        else:
            out, stats = attention_nhd_fwd_stats(xq, xk, xv, num_heads, scale,
                                                 block_size)
        ctx.save_for_backward(xq, xk, xv, stats)
        ctx.args = (num_heads, scale, block_size, plain)
        return out

    @staticmethod
    def backward(ctx, do):
        xq, xk, xv, stats = ctx.saved_tensors
        num_heads, scale, block_size, plain = ctx.args
        if plain:
            grads = attention_nhd_bwd_reference(xq, xk, xv, do, num_heads,
                                                scale, block_size)
        else:
            grads = attention_nhd_bwd(xq, xk, xv, do, stats, num_heads, scale,
                                      block_size)
        return (*grads, None, None, None, None)


def _wants_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def attention_nhd(xq, xk, xv, num_heads: int, scale: float,
                  block_size: int = 0):
    """softmax(q·kᵀ·scale)·v per head over (B, N, H·D) activations; the
    output has the input's layout and dtype, and a gradient when an input
    requires one.

    ``block_size`` > 0 masks attention block-diagonally (a packed sequence
    behaves as N/bs independent sequences).

    On the card: the training forward and backward kernels when a gradient
    is wanted, the inference kernel otherwise. On the CPU: the plain
    versions."""
    if xq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention_nhd runs on cuda or cpu, not {xq.device}")
    if not _wants_grad(xq, xk, xv):
        return attention_nhd_fwd(xq, xk, xv, num_heads, scale, block_size)
    return _AttentionNHD.apply(xq, xk, xv, num_heads, scale, block_size,
                               xq.device.type == "cpu")


def attention_nhd_plain(xq, xk, xv, num_heads: int, scale: float,
                        block_size: int = 0):
    """:func:`attention_nhd` through the plain versions, forward and
    backward, on any device: the yardstick the card's kernels are held to."""
    if not _wants_grad(xq, xk, xv):
        return attention_nhd_reference(xq, xk, xv, num_heads, scale, block_size)
    return _AttentionNHD.apply(xq, xk, xv, num_heads, scale, block_size, True)
