"""Blockwise flash attention: kernel B2 (forward, dK/dV, dQ) and its exp2
form P1.

Port of ``vit_ssl_tpu/ops/flash_blockwise.py`` (``blockwise_attention``,
``blockwise_attention_lse``) and of the forward of
``scripts/exp2_probe.py`` (``fwd_exp2``). softmax(q·kᵀ·scale)·v over
contiguous (B, H, N, D) heads of any length N, with the log-sum-exp of each
row (fp32 (B, H, N)) kept for the backward: the O(N)-memory kernel that the
JAX package runs for N > 1024 (ViT-B/16 at 512 px, N = 1025) and per ring
hop.

On a CUDA tensor the wrappers launch the hand-written Hopper kernels:

- ``blockwise_fwd`` (``csrc/flash_blockwise_fwd.cu``; in bf16 the Hopper
  body of ``csrc/flash_blockwise_fwd_sm90.cuh``, wgmma and TMA, scale > 0):
  one pass over the key tiles with online rescaling; writes o and lse;
- ``blockwise_fwd_exp2`` (same source, P1): the same forward in the log2
  domain, bf16 only; the model path does not launch it
  (``vit_ssl_tpu_torch/scripts/exp2_probe.py`` times it against
  ``blockwise_fwd``);
- ``blockwise_bwd_dq`` and ``blockwise_bwd_dkv``
  (``csrc/flash_blockwise_bwd.cu``; in bf16 the Hopper backward of
  ``csrc/attention_bwd_sm90.cuh`` in its lse form, wgmma and TMA, which B3's
  backward shares in its own form; scale > 0): the backward's two kernels;
  the first also computes δ = rowsum(dO·O) − dlse for the second. The bf16
  bodies read the lse and δ in whole 64-row tiles, so the wrappers hand
  them copies padded to ``STATS_ROWS`` rows a head (:func:`pad_rows`: lse
  +inf past N, as JAX's ``_flash_bwd`` pads it; δ 0); the Python API keeps
  (B, H, N).

On a CPU tensor they run the plain PyTorch versions. There is no fallback
from one to the other: a CUDA call that a kernel cannot take raises.

Forward rounding (``_fwd_kernel``, ``vit_ssl_tpu/ops/flash_blockwise.py:
100-113``): p is exp(s − m) relative to the running max, cast to v's dtype
before P·V, and the accumulator is divided by l in fp32 at the end. So in
bf16 the output depends on the key-block partition: the plain version takes
``block_k``, and the card holds the kernel to it at the kernel's own tile,
``KERNEL_BLOCK_K`` keys. In fp32 the partition changes only the order of
sums.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from .. import kernels

KERNEL = "blockwise_fwd"  # the forward, o and lse
KERNEL_EXP2 = "blockwise_fwd_exp2"  # P1, in KERNEL's library
KERNEL_DQ = "blockwise_bwd_dq"  # dq and delta
KERNEL_DKV = "blockwise_bwd_dkv"  # dk and dv, in KERNEL_DQ's library
FWD_LIBRARY = "flash_blockwise_fwd"
BWD_LIBRARY = "flash_blockwise_bwd"
# the bf16 forward's key tile (kKeys of csrc/sm90_common.cuh, the tile of
# csrc/flash_blockwise_fwd_sm90.cuh)
KERNEL_BLOCK_K = 64
# the bf16 backward's lse and δ rows a head are padded to a multiple of this
# (its 64-row query tiles, csrc/attention_bwd_sm90.cuh)
STATS_ROWS = 64
HEAD_DIMS = (32, 64, 128)
LOG2E = 1.4426950408889634
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# entry -> (library, pointer arguments)
_ENTRIES = {
    KERNEL: (FWD_LIBRARY, 5),
    KERNEL_EXP2: (FWD_LIBRARY, 5),
    KERNEL_DQ: (BWD_LIBRARY, 9),
    KERNEL_DKV: (BWD_LIBRARY, 8),
}


# ---------------------------------------------------------------------------
# Plain versions


def _blockwise_forward(q, k, v, scale: float, block_k: Optional[int], base2: bool):
    """The online-softmax recurrence over key blocks of ``block_k`` (all N
    keys in one block when None), in the natural or the log2 domain."""
    n = q.shape[-2]
    bk = n if block_k is None else block_k
    if bk < 1:
        raise ValueError(f"block_k must be >= 1, got {block_k}")
    exp = torch.exp2 if base2 else torch.exp
    sscale = scale * LOG2E if base2 else scale
    qf = q.float()
    m = torch.full(q.shape[:-1] + (1,), -math.inf, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, device=q.device, dtype=torch.float32)
    for j in range(0, n, bk):
        s = torch.matmul(qf, k[..., j:j + bk, :].float().transpose(-1, -2)) * sscale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = exp(s - m_new)
        correction = exp(m - m_new)
        l = l * correction + p.sum(dim=-1, keepdim=True)
        acc = acc * correction + torch.matmul(p.to(v.dtype).float(),
                                              v[..., j:j + bk, :].float())
        m = m_new
    l = l.clamp_min(1e-30)
    lse = (m + torch.log2(l)) / LOG2E if base2 else m + torch.log(l)
    return (acc / l).to(q.dtype), lse[..., 0]


def blockwise_attention_reference(q, k, v, scale: float,
                                  block_k: Optional[int] = None):
    """Plain version of B2's forward (``_fwd_kernel``,
    ``vit_ssl_tpu/ops/flash_blockwise.py:76-114``) on (B, H, N, D): over key
    blocks of ``block_k`` (one block of all N keys when None), fp32 scores
    q·kᵀ·scale, running max m, p = exp(s − m) cast to v's dtype before P·V,
    fp32 accumulation rescaled by exp(m_old − m_new), the fp32 sum l;
    returns (acc / l in the input dtype, lse = m + log l as fp32 (B, H, N))."""
    return _blockwise_forward(q, k, v, scale, block_k, base2=False)


def blockwise_attention_exp2_reference(q, k, v, scale: float,
                                       block_k: Optional[int] = None):
    """Plain version of P1 (``_fwd_kernel_exp2``,
    ``scripts/exp2_probe.py:27-64``): the same recurrence with log2 e folded
    into the scale and exp2 in place of exp; lse converted back to natural
    log, (m₂ + log₂ l) / log₂ e."""
    return _blockwise_forward(q, k, v, scale, block_k, base2=True)


def blockwise_attention_delta_reference(o, do, dlse=None):
    """δ = Σ dO·O over the head dim in fp32, minus ``dlse`` when it is
    given: fp32 (B, H, N). ``do`` is taken in o's dtype."""
    delta = (do.to(o.dtype).float() * o.float()).sum(dim=-1)
    return delta if dlse is None else delta - dlse.float()


def _bwd_plain(q, k, v, do, lse, delta, scale: float):
    """(dq, dk, dv) from a given δ, at JAX's rounding points."""
    dtype = q.dtype
    g = do.to(dtype).float()
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - lse.float()[..., None])
    dv = torch.matmul(p.to(dtype).float().transpose(-1, -2), g)
    dp = torch.matmul(g, v.float().transpose(-1, -2))
    ds = (p * (dp - delta.float()[..., None]) * scale).to(dtype).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def blockwise_attention_bwd_reference(q, k, v, o, lse, do, scale: float,
                                      dlse=None):
    """Plain version of B2's backward (``_flash_bwd``, ``_dkv_kernel``,
    ``_dq_kernel``, ``vit_ssl_tpu/ops/flash_blockwise.py:168-318``) with
    JAX's rounding points: ``do`` cast to the input dtype; δ = Σ dO·O in
    fp32, minus ``dlse`` when it is given; p = exp(s − lse) in fp32;
    dv = p.astype(do.dtype)ᵀ·do, dp = do·vᵀ,
    ds = (p·(dp − δ)·scale).astype(q.dtype), dq = ds·k, dk = dsᵀ·q, fp32
    accumulation, each stored in the input dtype. Returns (dq, dk, dv)."""
    delta = blockwise_attention_delta_reference(o, do.to(q.dtype), dlse)
    return _bwd_plain(q, k, v, do, lse, delta, scale)


def blockwise_attention_bwd_dq_reference(q, k, v, o, lse, do, scale: float,
                                         dlse=None):
    """Plain version of :func:`blockwise_attention_bwd_dq`: (dq, δ)."""
    delta = blockwise_attention_delta_reference(o, do.to(q.dtype), dlse)
    return _bwd_plain(q, k, v, do, lse, delta, scale)[0], delta


def blockwise_attention_bwd_dkv_reference(q, k, v, do, lse, delta, scale: float):
    """Plain version of :func:`blockwise_attention_bwd_dkv`: (dk, dv)."""
    return _bwd_plain(q, k, v, do, lse, delta, scale)[1:]


# ---------------------------------------------------------------------------
# Kernel wrappers


def _check(q, k, v, scale: Optional[float] = None) -> Tuple[int, int, int, int]:
    """Validate what B2's kernels take; returns (B, H, N, D). With
    ``scale``, also the scale: the bf16 bodies fold it into their exponent
    (the forward takes the max of the unscaled scores; the backward masks
    with −inf before scaling), so they take scale > 0 only."""
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
        raise ValueError("q, k and v must start 16-byte aligned (the kernels "
                         "read 16 bytes a thread)")
    b, h, n, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported (one of {HEAD_DIMS})")
    if n < 1:
        raise ValueError(f"sequence length {n} < 1")
    if not 1 <= b <= 65535 or not 1 <= h <= 65535:
        raise ValueError(f"batch {b} / heads {h} outside the grid limits 1..65535")
    if scale is not None and q.dtype == torch.bfloat16 and not scale > 0:
        raise ValueError(f"the bf16 kernels take scale > 0 (folded into their "
                         f"exponent), got {scale}")
    return b, h, n, d


def _check_rows(name: str, x, shape, dtype, device) -> None:
    """``x`` must be a contiguous, 16-byte aligned ``shape`` tensor of
    ``dtype`` on ``device``."""
    if (tuple(x.shape) != tuple(shape) or x.dtype != dtype or x.device != device
            or not x.is_contiguous() or x.data_ptr() % 16):
        raise ValueError(f"{name} {tuple(x.shape)} {x.dtype} {x.device} is not a "
                         f"contiguous, 16-byte aligned {tuple(shape)} {dtype} "
                         f"tensor on {device}")


@functools.cache
def _kernel_fn(entry: str):
    """A C entry point, its library built and loaded at first use: its
    pointers, (batch, n, heads, head_dim, is_bf16), scale, the stream."""
    library, pointers = _ENTRIES[entry]
    fn = getattr(kernels.load(library), entry)
    fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(entry: str, device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _kernel_fn(entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    kernels.launches[entry] += 1


def _require_cuda(x, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")


def _forward(entry: str, q, k, v, scale: float):
    b, h, n, d = _check(q, k, v, scale)
    out = torch.empty_like(q)
    lse = torch.empty(b, h, n, device=q.device, dtype=torch.float32)
    _launch(entry, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, n, h, d, _DTYPES[q.dtype],
            float(scale))
    return out, lse


def blockwise_attention_fwd(q, k, v, scale: float):
    """B2's forward: (o, lse). On a CUDA tensor kernel ``blockwise_fwd``
    (key tiles of ``KERNEL_BLOCK_K``); on a CPU tensor
    :func:`blockwise_attention_reference` over one block."""
    if q.device.type == "cpu":
        return blockwise_attention_reference(q, k, v, scale)
    _require_cuda(q, "blockwise_attention")
    return _forward(KERNEL, q, k, v, scale)


def blockwise_attention_fwd_exp2(q, k, v, scale: float):
    """P1: (o, lse) of the exp2 form. On a CUDA tensor kernel
    ``blockwise_fwd_exp2`` (bf16 only); on a CPU tensor
    :func:`blockwise_attention_exp2_reference` over one block."""
    if q.device.type == "cpu":
        return blockwise_attention_exp2_reference(q, k, v, scale)
    _require_cuda(q, "blockwise_attention_fwd_exp2")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"blockwise_fwd_exp2 takes bfloat16, not {q.dtype}")
    return _forward(KERNEL_EXP2, q, k, v, scale)


def stat_rows(n: int, dtype) -> int:
    """Rows a head of the lse and δ that the backward kernels take: the
    bf16 bodies read whole 64-row query tiles of them, round_up(n,
    ``STATS_ROWS``); the fp32 bodies n."""
    return -(-n // STATS_ROWS) * STATS_ROWS if dtype == torch.bfloat16 else n


def pad_rows(x, rows: int, fill: float):
    """(B, H, n) fp32 ``x`` as a contiguous (B, H, ``rows``) tensor, ``fill``
    past n (``x`` itself when it already is one): the lse padded with +inf
    (p = exp(s − ∞) = 0 on padded rows, as JAX's ``_flash_bwd`` pads it), δ
    with 0."""
    n = x.shape[-1]
    if rows == n:
        return x.contiguous()
    out = torch.full((*x.shape[:-1], rows), fill, device=x.device, dtype=torch.float32)
    out[..., :n] = x
    return out


def _bwd_inputs(q, k, v, do, lse, scale: float):
    """Checks a backward kernel's inputs; returns (B, H, N, D) and ``do``
    cast to the input dtype and made contiguous (never in the kernels).
    The bf16 bodies fold the scale into the exponent after the mask's
    −inf, so they take scale > 0 only."""
    b, h, n, d = _check(q, k, v, scale)
    do = do.to(q.dtype).contiguous()
    _check_rows("do", do, q.shape, q.dtype, q.device)
    _check_rows("lse", lse, (b, h, n), torch.float32, q.device)
    return (b, h, n, d), do


def _launch_dq(q, k, v, o, lse_p, do, scale: float, dlse):
    """``blockwise_bwd_dq`` on checked inputs, the lse of ``stat_rows``
    rows a head; returns dq and δ of as many rows."""
    b, h, n, d = q.shape
    if dlse is not None:
        dlse = dlse.to(torch.float32).contiguous()
        _check_rows("dlse", dlse, (b, h, n), torch.float32, q.device)
    dq = torch.empty_like(q)
    delta = torch.empty(b, h, lse_p.shape[-1], device=q.device, dtype=torch.float32)
    _launch(KERNEL_DQ, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), do.data_ptr(), lse_p.data_ptr(),
            None if dlse is None else dlse.data_ptr(), dq.data_ptr(),
            delta.data_ptr(), b, n, h, d, _DTYPES[q.dtype], float(scale))
    return dq, delta


def _launch_dkv(q, k, v, do, lse_p, delta_p, scale: float):
    """``blockwise_bwd_dkv`` on checked inputs, lse and δ of ``stat_rows``
    rows a head."""
    b, h, n, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(KERNEL_DKV, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse_p.data_ptr(), delta_p.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, n, h, d, _DTYPES[q.dtype], float(scale))
    return dk, dv


def blockwise_attention_bwd_dq(q, k, v, o, lse, do, scale: float, dlse=None):
    """(dq, δ) of B2 for the upstream gradient ``do`` (and ``dlse``, the
    lse output's cotangent, when given); δ = Σ dO·O − dlse, fp32
    (B, H, N), is what :func:`blockwise_attention_bwd_dkv` takes (on the
    card in bf16 a view of the kernel's padded δ). On a CUDA tensor kernel
    ``blockwise_bwd_dq``; on a CPU tensor the plain versions."""
    if q.device.type == "cpu":
        return blockwise_attention_bwd_dq_reference(q, k, v, o, lse, do, scale, dlse)
    _require_cuda(q, "blockwise_attention")
    (b, h, n, d), do = _bwd_inputs(q, k, v, do, lse, scale)
    _check_rows("o", o, q.shape, q.dtype, q.device)
    lse_p = pad_rows(lse, stat_rows(n, q.dtype), math.inf)
    dq, delta = _launch_dq(q, k, v, o, lse_p, do, scale, dlse)
    return dq, delta[..., :n]


def blockwise_attention_bwd_dkv(q, k, v, do, lse, delta, scale: float):
    """(dk, dv) of B2 from δ of :func:`blockwise_attention_bwd_dq`, fp32
    (B, H, N) of any strides. On a CUDA tensor kernel ``blockwise_bwd_dkv``;
    on a CPU tensor the plain versions."""
    if q.device.type == "cpu":
        return blockwise_attention_bwd_dkv_reference(q, k, v, do, lse, delta, scale)
    _require_cuda(q, "blockwise_attention")
    (b, h, n, d), do = _bwd_inputs(q, k, v, do, lse, scale)
    if tuple(delta.shape) != (b, h, n) or delta.dtype != torch.float32 \
            or delta.device != q.device:
        raise ValueError(f"delta {tuple(delta.shape)} {delta.dtype} {delta.device} is not "
                         f"a {(b, h, n)} float32 tensor on {q.device}")
    rows = stat_rows(n, q.dtype)
    return _launch_dkv(q, k, v, do, pad_rows(lse, rows, math.inf), pad_rows(delta, rows, 0.0),
                       scale)


def blockwise_attention_bwd(q, k, v, o, lse, do, scale: float, dlse=None):
    """(dq, dk, dv) of B2 for the upstream gradient ``do`` (and ``dlse``,
    the lse output's cotangent, when given). On a CUDA tensor kernels
    ``blockwise_bwd_dq`` then ``blockwise_bwd_dkv`` (``do`` is cast to the
    input dtype and made contiguous here, never in the kernels; the lse is
    padded once and the dq kernel's padded δ handed on); on a CPU tensor
    :func:`blockwise_attention_bwd_reference`."""
    if q.device.type == "cpu":
        return blockwise_attention_bwd_reference(q, k, v, o, lse, do, scale, dlse)
    _require_cuda(q, "blockwise_attention")
    (b, h, n, d), do = _bwd_inputs(q, k, v, do, lse, scale)
    _check_rows("o", o, q.shape, q.dtype, q.device)
    lse_p = pad_rows(lse, stat_rows(n, q.dtype), math.inf)
    dq, delta_p = _launch_dq(q, k, v, o, lse_p, do, scale, dlse)
    return (dq, *_launch_dkv(q, k, v, do, lse_p, delta_p, scale))


# ---------------------------------------------------------------------------
# Autograd


class _Blockwise(torch.autograd.Function):
    """Kernel B2 with its gradient; returns (o, lse). The lse output is
    differentiable: its cotangent folds into δ (``_flash_bwd``,
    ``vit_ssl_tpu/ops/flash_blockwise.py:253-276``). ``plain`` runs the
    plain versions, forward and backward, whatever the device."""

    @staticmethod
    def forward(ctx, q, k, v, scale, plain):
        ctx.set_materialize_grads(False)  # an unused lse gives dlse None
        if plain:
            out, lse = blockwise_attention_reference(q, k, v, scale)
        else:
            out, lse = blockwise_attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, plain)
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        scale, plain = ctx.args
        if do is None:
            do = torch.zeros_like(out)
        bwd = blockwise_attention_bwd_reference if plain else blockwise_attention_bwd
        return (*bwd(q, k, v, out, lse, do, scale, dlse), None, None)


def _wants_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def _device_check(q, k, v) -> None:
    kernels.refuse_dtensor("blockwise_attention", q=q, k=k, v=v)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"blockwise_attention runs on cuda or cpu, not {q.device}")


def blockwise_attention_lse(q, k, v, scale: float):
    """softmax(q·kᵀ·scale)·v over contiguous (B, H, N, D) heads and each
    row's log-sum-exp, fp32 (B, H, N); both outputs carry a gradient when an
    input requires one (the composition primitive of ring attention). On the
    card: B2's kernels; on the CPU: the plain versions."""
    _device_check(q, k, v)
    if not _wants_grad(q, k, v):
        return blockwise_attention_fwd(q, k, v, scale)
    return _Blockwise.apply(q, k, v, scale, q.device.type == "cpu")


def blockwise_attention(q, k, v, scale: float):
    """softmax(q·kᵀ·scale)·v over contiguous (B, H, N, D) heads of any
    length; the output has the input's layout and dtype, and a gradient
    when an input requires one. On the card: B2's forward (and its two
    backward kernels); on the CPU: the plain versions."""
    return blockwise_attention_lse(q, k, v, scale)[0]


def blockwise_attention_lse_plain(q, k, v, scale: float):
    """:func:`blockwise_attention_lse` through the plain versions, forward
    and backward, on any device: the yardstick B2's kernels are held to."""
    if not _wants_grad(q, k, v):
        return blockwise_attention_reference(q, k, v, scale)
    return _Blockwise.apply(q, k, v, scale, True)


def blockwise_attention_plain(q, k, v, scale: float):
    """:func:`blockwise_attention` through the plain versions."""
    return blockwise_attention_lse_plain(q, k, v, scale)[0]
