"""Multi-head attention on the projections' native (B, N, H·D) layout.

Port of ``vit_ssl_tpu/ops/flash_attention.py::attention_nhd`` (kernel B1),
inference forward only. On a CUDA tensor :func:`attention_nhd` launches the
hand-written Hopper kernel ``csrc/attention_nhd_fwd.cu``; on a CPU tensor it
runs :func:`attention_nhd_reference`, the plain PyTorch version of the same
arithmetic. There is no fallback from one to the other: a CUDA call that
the kernel cannot take raises.

The JAX package gates its kernel with TPU measurements
(``attention_nhd_profitable``); the port carries no such gate — on the card
every self-attention call without ``return_attn`` goes to the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels

KERNEL = "attention_nhd_fwd"
MAX_SEQ = 1024  # the JAX single-tile ceiling (MAX_FUSED_SEQ)
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_nhd_reference(xq, xk, xv, num_heads: int, scale: float,
                            block_size: int = 0):
    """Plain PyTorch version of the kernel: fp32 scores scaled by ``scale``,
    optional block-diagonal mask (``i//bs == j//bs``), fp32 softmax whose
    normalised probabilities are cast to the input dtype before P·V, fp32
    accumulation, output in the input dtype."""
    b, n, hd = xq.shape
    d = hd // num_heads

    def heads(x):  # (B, N, H·D) -> (B, H, N, D) fp32
        return x.reshape(b, x.shape[1], num_heads, d).transpose(1, 2).float()

    q, k, v = heads(xq), heads(xk), heads(xv)
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if block_size:
        row = torch.arange(n, device=xq.device)[:, None] // block_size
        col = torch.arange(k.shape[2], device=xq.device)[None, :] // block_size
        s = s.masked_fill(row != col, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    pn = (p / p.sum(dim=-1, keepdim=True)).to(xv.dtype)
    o = torch.matmul(pn.float(), v)
    return o.to(xq.dtype).transpose(1, 2).reshape(b, n, hd)


def _check(xq, xk, xv, num_heads: int, block_size: int) -> int:
    """Validate what the kernel takes; returns the head dim."""
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


@functools.cache
def _kernel_fn():
    """The C entry point, built and loaded at first use."""
    fn = kernels.load(KERNEL).attention_nhd_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def attention_nhd(xq, xk, xv, num_heads: int, scale: float,
                  block_size: int = 0):
    """softmax(q·kᵀ·scale)·v per head over (B, N, H·D) activations; the
    output has the input's layout and dtype.

    ``block_size`` > 0 masks attention block-diagonally (a packed sequence
    behaves as N/bs independent sequences)."""
    if xq.device.type == "cpu":
        return attention_nhd_reference(xq, xk, xv, num_heads, scale, block_size)
    if xq.device.type != "cuda":
        raise ValueError(f"attention_nhd runs on cuda or cpu, not {xq.device}")
    d = _check(xq, xk, xv, num_heads, block_size)
    b, n, _ = xq.shape
    out = torch.empty_like(xq)
    fn = _kernel_fn()
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = fn(xq.data_ptr(), xk.data_ptr(), xv.data_ptr(), out.data_ptr(),
                 b, n, num_heads, d, _DTYPES[xq.dtype], float(scale),
                 int(block_size), stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err}")
    kernels.launches[KERNEL] += 1
    return out
