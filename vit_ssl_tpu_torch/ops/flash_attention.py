"""Fused multi-head attention: kernels B1 and B3 with their gradients.

Port of ``vit_ssl_tpu/ops/flash_attention.py::attention_nhd`` (kernel B1,
on the projections' native (B, N, H·D) layout) and ``fused_attention``
(kernel B3, on the head-major (B, H, N, D) layout), and of the JAX
package's rule that picks between them (:func:`attention_nhd_feasible`).

:func:`attention_nhd` is a ``torch.autograd.Function``; on a CUDA tensor
it launches the hand-written Hopper kernels:

- ``attention_nhd_fwd`` (``csrc/attention_nhd_fwd.cu``), the inference
  forward, when no gradient is wanted (serving under ``inference_mode``,
  the DINO teacher under ``no_grad``);
- ``attention_nhd_fwd_stats`` (same source), the training forward: the same
  output bit for bit, plus each row's softmax statistics (row max m and
  1/l, fp32). They replace the (B, H, N, N) probabilities that the TPU
  kernel saves for its backward. In bf16 both run the Hopper body of
  ``csrc/attention_fwd_sm90.cuh`` (wgmma, TMA; the softmax scale must be
  positive) in one of two forms, :func:`attention_nhd_form`: one pass over
  the keys up to ``ONE_PASS_MAX_SEQ`` (DINO's N = 145 and 148), two passes
  above, the form B3 runs; in fp32 a CUDA-core body;
- ``attention_nhd_bwd`` (``csrc/attention_nhd_bwd.cu``), the backward: it
  rebuilds the forward's rounded probabilities from q, k and the
  statistics and returns dq, dk and dv. In bf16 it runs the Hopper
  backward of ``csrc/attention_bwd_sm90.cuh`` (wgmma, TMA; B3's and B2's
  body, on B1's layout with the mask; the softmax scale must be positive)
  in one of two forms, :func:`attention_nhd_bwd_form`: resident up to
  ``RESIDENT_MAX_SEQ`` (DINO's N = 145 and 148), streamed above; in fp32
  a CUDA-core body.

On a CPU tensor the same Function runs the plain PyTorch versions,
:func:`attention_nhd_reference` forward and
:func:`attention_nhd_bwd_reference` backward. There is no fallback from one
to the other: a CUDA call that a kernel cannot take raises.

:func:`fused_attention` is B3, the same function without the mask on
contiguous (B, H, N, D) tensors, with the same three entries in one library
(``csrc/fused_attention.cu``): ``fused_attention_fwd``,
``fused_attention_fwd_stats`` and ``fused_attention_bwd``; on a CPU tensor
:func:`fused_attention_reference` and :func:`fused_attention_bwd_reference`.
Its bf16 forwards run the two-pass form of B1's Hopper body, its bf16
backward the streamed form of B1's Hopper backward
(``csrc/attention_bwd_sm90.cuh``: wgmma, TMA, two consumer warpgroups a
block; the softmax scale must be positive), which B2's backward shares in
its lse form;
its fp32 forwards and backward are B1's CUDA-core bodies, all instantiated
for the head-major layout.

The JAX package gates B1 with TPU measurements
(``attention_nhd_profitable``); the port keeps only its feasibility rule,
:func:`attention_nhd_feasible`, so that every model config reaches the same
kernel family as in the JAX package. Where JAX's timing gate sends a
feasible shape to XLA, the port keeps B1.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .. import kernels

KERNEL = "attention_nhd_fwd"  # inference forward
KERNEL_TRAIN = "attention_nhd_fwd_stats"  # training forward, in KERNEL's library
KERNEL_BWD = "attention_nhd_bwd"
# kernel B3: three entries of one library
FUSED_LIBRARY = "fused_attention"
FUSED_KERNEL = "fused_attention_fwd"  # inference forward
FUSED_KERNEL_TRAIN = "fused_attention_fwd_stats"  # training forward
FUSED_KERNEL_BWD = "fused_attention_bwd"
MAX_SEQ = 1024  # the JAX single-tile ceiling (MAX_FUSED_SEQ)
HEAD_DIMS = (32, 64, 128)
STATS_ROWS = 64  # the statistics' rows per (b, h) are padded to this multiple
# B1's bf16 forward takes one pass over the keys up to this length (four
# 64-key tiles of scores in a warpgroup's registers), two passes above:
# csrc/attention_fwd_sm90.cuh's kOnePassMaxSeq
ONE_PASS_MAX_SEQ = 256
# each form's kernel, as a profiler names it
FORWARD_BODIES = {"one-pass": "attention_fwd_onepass_sm90_kernel",
                  "two-pass": "attention_fwd_sm90_kernel"}
# B1's bf16 backward holds every tile a 64-row block needs in shared memory
# up to this length (four 64-row tiles), streams them through a ring above:
# csrc/attention_bwd_sm90.cuh's kResidentMaxSeq
RESIDENT_MAX_SEQ = 256
# each backward form's (dq, dk/dv) kernels, as a profiler names them
BACKWARD_BODIES = {
    "resident": ("attention_nhd_bwd_dq_resident_sm90_kernel",
                 "attention_nhd_bwd_dkv_resident_sm90_kernel"),
    "streamed": ("attention_nhd_bwd_dq_sm90_kernel", "attention_nhd_bwd_dkv_sm90_kernel"),
    "cuda-core": ("attention_bwd_dq_f32_kernel", "attention_bwd_dkv_f32_kernel"),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# entry -> (library, pointer arguments, takes block_size)
_ENTRIES = {
    KERNEL: (KERNEL, 4, True),
    KERNEL_TRAIN: (KERNEL, 5, True),
    KERNEL_BWD: (KERNEL_BWD, 9, True),
    FUSED_KERNEL: (FUSED_LIBRARY, 4, False),
    FUSED_KERNEL_TRAIN: (FUSED_LIBRARY, 5, False),
    FUSED_KERNEL_BWD: (FUSED_LIBRARY, 9, False),
}


# ---------------------------------------------------------------------------
# Routing: the JAX package's rule for B1 against B3


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _nhd_pad(n: int, lane: int = 128) -> Tuple[int, int]:
    """Mosaic-padded (sublane, lane) extents of an (n, n) tile."""
    return _round_up(n, 16), _round_up(n, lane)


_VMEM_HARD = 15 * 1024 * 1024  # scoped-vmem ceiling (16 MB) minus margin


def attention_nhd_feasible(b: int, n: int, num_heads: int, hd: int,
                           itemsize: int = 2) -> bool:
    """The JAX package's routing rule between kernels B1 and B3, copied as
    plain arithmetic (``vit_ssl_tpu/ops/flash_attention.py:282-330``): True
    when B1's TPU training forward (probabilities saved) and backward fit a
    TPU core's VMEM at one image per grid cell. It is kept so that each
    model config reaches the same kernel family as in the JAX package
    (ViT-B/16 at 384 px, N = 577, 12 heads: B3). Its numbers describe a
    TPU's VMEM, not the H100; a gate measured on the card is queued in
    ``ROADMAP.md``."""
    del b  # one image per grid cell: the batch does not enter
    n_sub, n_lane = _nhd_pad(n)
    fwd = (2 * (4 * n_sub * hd + num_heads * n_sub * n_lane) * itemsize
           + 2 * n_sub * n_lane * 4)
    bwd = (2 * (7 * n_sub * hd + num_heads * n_sub * n_lane) * itemsize
           + 2 * n_sub * n_lane * 4 + n_sub * n_lane * itemsize)
    return max(fwd, bwd) <= _VMEM_HARD


def attention_route(b: int, n: int, num_heads: int, hd: int, itemsize: int,
                    block_size: int = 0) -> str:
    """The kernel a self-attention of this shape takes: ``"B1"``
    (:func:`attention_nhd`) for a packed sequence or where B1 fits
    (:func:`attention_nhd_feasible`), else ``"B3"`` (:func:`fused_attention`)
    up to N = ``MAX_SEQ``, and ``"B2"``
    (:func:`.flash_blockwise.blockwise_attention`) for a longer unpacked
    sequence, as the JAX package sends N > ``MAX_FUSED_SEQ`` to
    ``blockwise_attention``. B1's and B3's kernels stop at ``MAX_SEQ``, so
    a long sequence takes B2 even where JAX's rule would let B1 fit (one
    narrow head)."""
    if block_size:
        return "B1"
    if n > MAX_SEQ:
        return "B2"
    return "B1" if attention_nhd_feasible(b, n, num_heads, hd, itemsize) else "B3"


def attention_nhd_form(n: int) -> str:
    """The form of B1's bf16 forward kernel at sequence length ``n``, as
    ``csrc/attention_fwd_sm90.cuh`` picks it: ``"one-pass"`` up to
    ``ONE_PASS_MAX_SEQ`` (every score of a 64-row block in registers: the
    exact row max and sum, then p and P·V), else ``"two-pass"`` (the row
    max and sum in a first sweep over the keys, the scores again, p and
    P·V in a second). Both entries, inference and training, run the same
    form. B3's bf16 forward runs the two-pass form at every N."""
    if not 1 <= n <= MAX_SEQ:
        raise ValueError(f"sequence length {n} outside 1..{MAX_SEQ}")
    return "one-pass" if n <= ONE_PASS_MAX_SEQ else "two-pass"


def attention_nhd_bwd_form(n: int, block_size: int, dtype) -> str:
    """The form of B1's backward kernels for sequence length ``n``,
    ``block_size`` and ``dtype``, as ``csrc/attention_nhd_bwd.cu`` picks it
    (:data:`BACKWARD_BODIES` names each form's two kernels). bf16:
    ``"resident"`` up to ``RESIDENT_MAX_SEQ`` (blocks of 64 query or key
    rows, several an SM, each holding every K and V, or Q and dO, tile it
    needs in shared memory; under the block-diagonal mask only the tiles
    that hold a kept score), else ``"streamed"`` (blocks of 128 rows whose
    tiles stream through a ring, the form of B3's and B2's backward). The
    mask (``block_size`` > 0) is a template parameter of both forms, not a
    form of its own. fp32: ``"cuda-core"``, at every n and block size."""
    if not 1 <= n <= MAX_SEQ:
        raise ValueError(f"sequence length {n} outside 1..{MAX_SEQ}")
    if block_size < 0:
        raise ValueError(f"block_size must be >= 0, got {block_size}")
    if dtype not in _DTYPES:
        raise ValueError(f"dtype {dtype} not supported (float32, bfloat16)")
    if dtype == torch.float32:
        return "cuda-core"
    return "resident" if n <= RESIDENT_MAX_SEQ else "streamed"


# ---------------------------------------------------------------------------
# Plain versions, on head-major (..., N, D) tensors of the input dtype


def _head_scores(q, k, scale: float, block_size: int):
    """fp32 scaled scores (..., N, N), -inf off the diagonal blocks."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if block_size:
        n = q.shape[-2]
        row = torch.arange(n, device=q.device)[:, None] // block_size
        col = torch.arange(n, device=q.device)[None, :] // block_size
        s = s.masked_fill(row != col, float("-inf"))
    return s


def _head_probs(q, k, scale: float, block_size: int):
    """The normalised probabilities rounded to the input dtype, as fp32."""
    s = _head_scores(q, k, scale, block_size)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return (p / p.sum(dim=-1, keepdim=True)).to(q.dtype).float()


def _head_forward(q, k, v, scale: float, block_size: int):
    return torch.matmul(_head_probs(q, k, scale, block_size), v.float()).to(q.dtype)


def _head_stats(q, k, scale: float, block_size: int):
    s = _head_scores(q, k, scale, block_size)
    m = s.amax(dim=-1)
    inv_l = 1.0 / torch.exp(s - m[..., None]).sum(dim=-1)
    return torch.stack([m, inv_l], dim=-1)


def _head_bwd(q, k, v, do, scale: float, block_size: int):
    dtype = q.dtype
    p = _head_probs(q, k, scale, block_size)
    g = do.to(dtype).float()
    dv = torch.matmul(p.transpose(-1, -2), g)
    dp = torch.matmul(g, v.float().transpose(-1, -2))
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(dtype).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def _split(x, num_heads: int):
    """(B, N, H·D) -> (B, H, N, D), a view in the input dtype."""
    b, n, hd = x.shape
    return x.reshape(b, n, num_heads, hd // num_heads).transpose(1, 2)


def _unheads(x, dtype):
    """(B, H, N, D) -> (B, N, H·D) in ``dtype``."""
    b, h, n, d = x.shape
    return x.to(dtype).transpose(1, 2).reshape(b, n, h * d)


def attention_nhd_reference(xq, xk, xv, num_heads: int, scale: float,
                            block_size: int = 0):
    """Plain PyTorch version of the forward: fp32 scores scaled by
    ``scale``, optional block-diagonal mask (``i//bs == j//bs``), fp32
    softmax whose normalised probabilities are cast to the input dtype
    before P·V, fp32 accumulation, output in the input dtype."""
    o = _head_forward(_split(xq, num_heads), _split(xk, num_heads),
                      _split(xv, num_heads), scale, block_size)
    return _unheads(o, xq.dtype)


def attention_nhd_stats_reference(xq, xk, num_heads: int, scale: float,
                                  block_size: int = 0):
    """Plain version of the training forward's statistics: fp32
    (B, H, N, 2) holding each row's max m of the scaled, masked scores and
    1/l, l = Σⱼ exp(s − m)."""
    return _head_stats(_split(xq, num_heads), _split(xk, num_heads), scale,
                       block_size)


def attention_nhd_bwd_reference(xq, xk, xv, do, num_heads: int, scale: float,
                                block_size: int = 0):
    """Plain version of the backward with JAX's rounding points
    (``_nhd_bwd_kernel``, ``vit_ssl_tpu/ops/flash_attention.py:396-423``):
    ``do`` cast to the input dtype; p the normalised probabilities rounded
    to the input dtype; dv = pᵀ·do, dp = do·vᵀ, δ = Σⱼ p·dp,
    ds = (p·(dp − δ)·scale) rounded to the input dtype; dq = ds·k,
    dk = dsᵀ·q; fp32 accumulation, each result in the input dtype.
    Returns (dq, dk, dv) in (B, N, H·D)."""
    grads = _head_bwd(*(_split(x, num_heads) for x in (xq, xk, xv, do)), scale,
                      block_size)
    return tuple(_unheads(g, xq.dtype) for g in grads)


def fused_attention_reference(q, k, v, scale: float):
    """Plain version of B3's forward (``_attn_kernel``,
    ``vit_ssl_tpu/ops/flash_attention.py:60-95``) on (B, H, N, D): fp32
    q·kᵀ times ``scale``, fp32 softmax, the normalised probabilities rounded
    to the input dtype before P·V, fp32 accumulation, output in the input
    dtype."""
    return _head_forward(q, k, v, scale, 0)


def fused_attention_stats_reference(q, k, scale: float):
    """Plain version of B3's training statistics: fp32 (B, H, N, 2), each
    row's max m of the scaled scores and 1/l, l = Σⱼ exp(s − m)."""
    return _head_stats(q, k, scale, 0)


def fused_attention_bwd_reference(q, k, v, do, scale: float):
    """Plain version of B3's backward (``_attn_bwd_kernel``,
    ``vit_ssl_tpu/ops/flash_attention.py:150-182``), B1's rounding points
    without the mask: ``do`` cast to the input dtype; p rounded to the
    input dtype; dv = pᵀ·do, dp = do·vᵀ, δ = Σⱼ p·dp,
    ds = (p·(dp − δ)·scale) rounded; dq = ds·k, dk = dsᵀ·q in fp32, each
    stored in the input dtype. Returns (dq, dk, dv) in (B, H, N, D)."""
    return _head_bwd(q, k, v, do, scale, 0)


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


def _bwd_buffers(q, do, stats, b: int, h: int, n: int):
    """A backward kernel's inputs checked and its outputs allocated: ``do``
    cast to q's dtype and made contiguous (never in the kernel), ``stats``
    the training forward's fp32 (B, H, Np, 2); returns (do, dq, dk, dv,
    delta), delta the zeroed fp32 (B, H, Np) scratch."""
    do = do.to(q.dtype).contiguous()
    if do.shape != q.shape or do.device != q.device or do.data_ptr() % 16:
        raise ValueError(f"do {tuple(do.shape)} {do.device} does not match "
                         f"q {tuple(q.shape)} {q.device}")
    want = (b, h, _stats_rows(n), 2)
    if (tuple(stats.shape) != want or stats.dtype != torch.float32
            or stats.device != q.device or not stats.is_contiguous()):
        raise ValueError(f"stats {tuple(stats.shape)} {stats.dtype} are not "
                         f"the training forward's fp32 {want}")
    grads = (torch.empty_like(q) for _ in range(3))
    return (do, *grads, torch.zeros(want[:3], device=q.device, dtype=torch.float32))


@functools.cache
def _kernel_fn(entry: str):
    """A C entry point, its library built and loaded at first use: its
    pointers, (batch, n, heads, head_dim, is_bf16), scale, B1's block_size,
    the stream."""
    library, pointers, masked = _ENTRIES[entry]
    fn = getattr(kernels.load(library), entry)
    fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * 5
                   + [ctypes.c_float] + [ctypes.c_int] * masked + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(entry: str, device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _kernel_fn(entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    kernels.launches[entry] += 1


def _require_cuda(x, name: str = "attention_nhd") -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")


def attention_nhd_fwd(xq, xk, xv, num_heads: int, scale: float,
                      block_size: int = 0):
    """The inference forward: kernel ``attention_nhd_fwd`` on a CUDA
    tensor, :func:`attention_nhd_reference` on a CPU tensor."""
    if xq.device.type == "cpu":
        return attention_nhd_reference(xq, xk, xv, num_heads, scale, block_size)
    _require_cuda(xq)
    d = _check(xq, xk, xv, num_heads, block_size)
    _check_scale(xq, scale)
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
    _check_scale(xq, scale)
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
    ``do``. On a CUDA tensor kernel ``attention_nhd_bwd`` in the form
    :func:`attention_nhd_bwd_form` names, from the statistics of
    :func:`attention_nhd_fwd_stats` (``do`` is cast to the input dtype and
    made contiguous here, never in the kernel); on a CPU tensor
    :func:`attention_nhd_bwd_reference`, which needs no statistics."""
    if xq.device.type == "cpu":
        return attention_nhd_bwd_reference(xq, xk, xv, do, num_heads, scale,
                                           block_size)
    _require_cuda(xq)
    d = _check(xq, xk, xv, num_heads, block_size)
    _check_scale(xq, scale)
    b, n, _ = xq.shape
    do, dq, dk, dv, delta = _bwd_buffers(xq, do, stats, b, num_heads, n)
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
    kernels.refuse_dtensor("attention_nhd", xq=xq, xk=xk, xv=xv)
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


# ---------------------------------------------------------------------------
# Kernel B3: the head-major (B, H, N, D) layout, no mask


def _check_heads(q, k, v) -> Tuple[int, int, int, int]:
    """Validate what B3's kernels take; returns (B, H, N, D)."""
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(
                f"{name} {tuple(x.shape)} {x.dtype} {x.device} differs from "
                f"q {tuple(q.shape)} {q.dtype} {q.device}"
            )
    if q.dim() != 4:
        raise ValueError(f"expected (B, H, N, D), got shape {tuple(q.shape)}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    if not all(x.is_contiguous() for x in (q, k, v)):
        raise ValueError("q, k and v must be contiguous (B, H, N, D)")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("q, k and v must start 16-byte aligned (the kernel "
                         "reads 16 bytes a thread)")
    b, h, n, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported (one of {HEAD_DIMS})")
    if not 1 <= n <= MAX_SEQ:
        raise ValueError(f"sequence length {n} outside 1..{MAX_SEQ}")
    if not 1 <= b <= 65535 or not 1 <= h <= 65535:
        raise ValueError(f"batch {b} / heads {h} outside the grid limits")
    return b, h, n, d


def _check_scale(q, scale: float) -> None:
    """B1's and B3's bf16 forward kernel takes the row max of the unscaled
    scores, which is the scaled scores' row max only for a positive scale;
    their bf16 backward rebuilds p the same way. fp32 takes any scale."""
    if q.dtype == torch.bfloat16 and not scale > 0:
        raise ValueError(f"scale must be positive for the bf16 kernel, got {scale}")


def fused_attention_fwd(q, k, v, scale: float):
    """B3's inference forward: kernel ``fused_attention_fwd`` on a CUDA
    tensor, :func:`fused_attention_reference` on a CPU tensor."""
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, scale)
    _require_cuda(q, "fused_attention")
    b, h, n, d = _check_heads(q, k, v)
    _check_scale(q, scale)
    out = torch.empty_like(q)
    _launch(FUSED_KERNEL, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, n, h, d, _DTYPES[q.dtype], float(scale))
    return out


def fused_attention_fwd_stats(q, k, v, scale: float):
    """B3's training forward: (output, statistics). On a CUDA tensor kernel
    ``fused_attention_fwd_stats``, whose output equals the inference
    kernel's bit for bit and whose statistics are fp32 (B, H, Np, 2),
    Np = N rounded up to 64, rows < N holding (m, 1/l) and the rest zero.
    On a CPU tensor the plain versions, statistics (B, H, N, 2)."""
    if q.device.type == "cpu":
        return (fused_attention_reference(q, k, v, scale),
                fused_attention_stats_reference(q, k, scale))
    _require_cuda(q, "fused_attention")
    b, h, n, d = _check_heads(q, k, v)
    _check_scale(q, scale)
    out = torch.empty_like(q)
    stats = torch.zeros(b, h, _stats_rows(n), 2, device=q.device,
                        dtype=torch.float32)
    _launch(FUSED_KERNEL_TRAIN, q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), stats.data_ptr(), b, n, h, d,
            _DTYPES[q.dtype], float(scale))
    return out, stats


def fused_attention_bwd(q, k, v, do, stats, scale: float):
    """(dq, dk, dv) of :func:`fused_attention` for the upstream gradient
    ``do``. On a CUDA tensor kernel ``fused_attention_bwd``, from the
    statistics of :func:`fused_attention_fwd_stats` (``do`` is cast to the
    input dtype and made contiguous here, never in the kernel); on a CPU
    tensor :func:`fused_attention_bwd_reference`, which needs no
    statistics."""
    if q.device.type == "cpu":
        return fused_attention_bwd_reference(q, k, v, do, scale)
    _require_cuda(q, "fused_attention")
    b, h, n, d = _check_heads(q, k, v)
    _check_scale(q, scale)
    do, dq, dk, dv, delta = _bwd_buffers(q, do, stats, b, h, n)
    _launch(FUSED_KERNEL_BWD, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), stats.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), b, n, h, d, _DTYPES[q.dtype],
            float(scale))
    return dq, dk, dv


class _FusedAttention(torch.autograd.Function):
    """Kernel B3 with its gradient. ``plain`` runs the plain versions,
    forward and backward, whatever the device."""

    @staticmethod
    def forward(ctx, q, k, v, scale, plain):
        if plain:
            out, stats = fused_attention_reference(q, k, v, scale), None
        else:
            out, stats = fused_attention_fwd_stats(q, k, v, scale)
        ctx.save_for_backward(q, k, v, stats)
        ctx.args = (scale, plain)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, stats = ctx.saved_tensors
        scale, plain = ctx.args
        if plain:
            grads = fused_attention_bwd_reference(q, k, v, do, scale)
        else:
            grads = fused_attention_bwd(q, k, v, do, stats, scale)
        return (*grads, None, None)


def fused_attention(q, k, v, scale: float):
    """softmax(q·kᵀ·scale)·v over contiguous (B, H, N, D) heads, no mask;
    the output has the input's layout and dtype, and a gradient when an
    input requires one.

    On the card: B3's training forward and backward kernels when a gradient
    is wanted, its inference kernel otherwise. On the CPU: the plain
    versions."""
    kernels.refuse_dtensor("fused_attention", q=q, k=k, v=v)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_attention runs on cuda or cpu, not {q.device}")
    if not _wants_grad(q, k, v):
        return fused_attention_fwd(q, k, v, scale)
    return _FusedAttention.apply(q, k, v, scale, q.device.type == "cpu")


def fused_attention_plain(q, k, v, scale: float):
    """:func:`fused_attention` through the plain versions, forward and
    backward, on any device: the yardstick B3's kernels are held to."""
    if not _wants_grad(q, k, v):
        return fused_attention_reference(q, k, v, scale)
    return _FusedAttention.apply(q, k, v, scale, True)
