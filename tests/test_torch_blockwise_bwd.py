"""Kernel B2's backward (``vit_ssl_tpu_torch.ops.flash_blockwise``) against
the JAX package's ``_flash_bwd``, on the CPU.

The same numpy inputs (B·H = 2, head dim 32) go through JAX's forward and
backward kernels in interpret mode at 64-row blocks (the bf16 Hopper
backward's tiles), and JAX's o and lse through the port's plain backward and
its CPU wrappers (the split dq / dk-dv pair included), with and without an
lse cotangent, at N past a 64-row edge (65, 129) and past 1024 (1025):
bf16 gradients to a bf16 ulp of their largest entry, δ at fp32 rounding.
Also the wrappers' padding of the lse and δ to the bf16 bodies' 64-row
tiles against JAX's own padding (+inf and 0), and the sources: the bf16
entries of ``csrc/flash_blockwise_bwd.cu`` reach the generalised Hopper
backward of ``csrc/attention_bwd_sm90.cuh`` in its lse form, B3's library
the same body in its (m, 1/l) form.
"""

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ssl_tpu.ops.flash_blockwise import _flash_bwd as jax_flash_bwd
from vit_ssl_tpu.ops.flash_blockwise import _flash_fwd as jax_flash_fwd
from vit_ssl_tpu.ops.flash_blockwise import _round_up as jax_round_up
from vit_ssl_tpu_torch import kernels
from vit_ssl_tpu_torch.ops import flash_blockwise as fb

BLOCK = 64  # the bf16 backward's query and key tiles
D = 32


def _inputs(n, seed):
    """q, k, v, the output cotangent and the lse cotangent (B, H = 1, 2)."""
    rng = np.random.default_rng(seed)
    qkvo = [rng.standard_normal((1, 2, n, D)).astype(np.float32) for _ in range(4)]
    return (*qkvo, rng.standard_normal((1, 2, n)).astype(np.float32))


def _bf16(x):
    return torch.from_numpy(np.array(x, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("with_dlse", [True, False], ids=["dlse", "no-dlse"])
@pytest.mark.parametrize("n", [65, 129, 1025])
def test_bf16_backward_matches_jax(n, with_dlse):
    """JAX's bf16 forward gives o and lse; ``_flash_bwd`` (interpret mode,
    64-row blocks) and the port's plain backward take them with the same
    do (and dlse): dq, dk, dv to a bf16 ulp of their largest entry (the same
    rounding points: p cast for dv, ds cast before dq and dk); the CPU
    wrappers, whole and split, give the plain version's values bit for
    bit, and δ is Σ dO·O − dlse in fp32."""
    q, k, v, go, gl = _inputs(n, seed=n)
    scale = D ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, go))
    jo, jlse, _ = jax_flash_fwd(jq, jk, jv, scale, BLOCK, BLOCK, True)
    dlse = jnp.asarray(gl) if with_dlse else None
    want = jax_flash_bwd((jq, jk, jv, jo, jlse), jdo, scale, BLOCK, BLOCK, True, dlse)

    tq, tk, tv, to, tdo = (_bf16(x) for x in (q, k, v, jo, go))
    tlse = torch.from_numpy(np.array(jlse, np.float32))
    tdlse = torch.from_numpy(gl) if with_dlse else None
    got = fb.blockwise_attention_bwd_reference(tq, tk, tv, to, tlse, tdo, scale, tdlse)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w, np.float32)
        assert g.dtype == torch.bfloat16 and g.shape == (1, 2, n, D)
        np.testing.assert_allclose(g.float().numpy(), w, atol=1e-2 * np.abs(w).max(), rtol=0,
                                   err_msg=name)

    whole = fb.blockwise_attention_bwd(tq, tk, tv, to, tlse, tdo, scale, tdlse)
    dq, delta = fb.blockwise_attention_bwd_dq(tq, tk, tv, to, tlse, tdo, scale, tdlse)
    dk, dv = fb.blockwise_attention_bwd_dkv(tq, tk, tv, tdo, tlse, delta, scale)
    for g, w in zip((*whole, dq, dk, dv), (*got, *got)):
        assert torch.equal(g, w)
    # JAX's δ (_flash_bwd, before its padding), from the same bf16 do and o
    want_delta = jnp.sum(jdo.astype(jnp.float32) * jo.astype(jnp.float32), axis=-1)
    if with_dlse:
        want_delta = want_delta - dlse
    np.testing.assert_allclose(delta.numpy(), np.asarray(want_delta), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n", [1, 64, 65, 1025])
def test_padding_matches_jax(n):
    """The lse and δ that the bf16 backward kernels take: ``stat_rows`` rows
    a head, round_up(n, 64), the rows of JAX's padding at 64-row blocks;
    ``pad_rows`` fills past n as ``_flash_bwd`` pads (lse +inf: p = exp(s −
    ∞) = 0 on a padded row; δ 0), and leaves the first n rows as they are.
    fp32 keeps n rows, and the tensor itself."""
    rows = fb.stat_rows(n, torch.bfloat16)
    assert rows == jax_round_up(n, BLOCK) and rows % fb.STATS_ROWS == 0
    rng = np.random.default_rng(n)
    lse, delta = (rng.standard_normal((2, 3, n)).astype(np.float32) for _ in range(2))
    pad = ((0, 0), (0, 0), (0, rows - n))
    want_lse = np.asarray(jnp.pad(jnp.asarray(lse), pad, constant_values=jnp.inf))
    want_delta = np.asarray(jnp.pad(jnp.asarray(delta), pad))
    got_lse = fb.pad_rows(torch.from_numpy(lse), rows, math.inf)
    got_delta = fb.pad_rows(torch.from_numpy(delta), rows, 0.0)
    for got, want in ((got_lse, want_lse), (got_delta, want_delta)):
        assert got.shape == (2, 3, rows) and got.dtype == torch.float32
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)
    # a strided (B, H, n) view pads the same
    wide = torch.from_numpy(np.concatenate([lse, lse], axis=-1))
    np.testing.assert_array_equal(fb.pad_rows(wide[..., :n], rows, math.inf).numpy(), want_lse)
    assert fb.stat_rows(n, torch.float32) == n
    x = torch.from_numpy(lse)
    assert fb.pad_rows(x, n, math.inf) is x


@pytest.mark.parametrize("scale", [0.0, -0.125, float("nan")])
def test_bf16_backward_refuses_a_scale_it_cannot_fold(scale):
    """The bf16 Hopper backward folds the scale into its exponent after the
    mask's −inf: the wrappers' checks refuse scale <= 0 (and NaN) by name
    for bf16 before any launch; fp32 takes any."""
    x = torch.zeros(2, 2, 37, 32, dtype=torch.bfloat16)
    lse = torch.zeros(2, 2, 37)
    with pytest.raises(ValueError, match="scale > 0"):
        fb._bwd_inputs(x, x, x, x, lse, scale)
    shape, do = fb._bwd_inputs(*[x.float()] * 4, lse, scale)
    assert shape == (2, 2, 37, 32) and do.dtype == torch.float32


def test_backward_sources_are_the_hopper_body():
    """``flash_blockwise_bwd.cu`` sends its bf16 entries to the generalised
    Hopper backward of ``attention_bwd_sm90.cuh`` (its lse form, kernels
    ``blockwise_bwd_{dq,dkv}_sm90_kernel``) and holds no bf16 body of its
    own; the library's sources are that header, ``sm90_common.cuh`` and the
    common header, and no forward body; B3's library instantiates the same
    body in its (m, 1/l) form; the wrapper's docstring names the header."""
    csrc = kernels.CSRC_DIR
    files = {p.name for p in kernels.source_files(fb.BWD_LIBRARY)}
    assert files == {"flash_blockwise_bwd.cu", "attention_bwd_sm90.cuh", "sm90_common.cuh",
                     "attention_nhd_common.cuh"}
    entry = (csrc / "flash_blockwise_bwd.cu").read_text()
    assert re.search(r"if \(is_bf16\)\s+return sm90::launch_blockwise_dq<D>\(", entry)
    assert re.search(r"if \(is_bf16\)\s+return sm90::launch_blockwise_dkv<D>\(", entry)
    assert not re.search(r"_bf16_kernel|mma_|ldmatrix|cp_async", entry)
    body = (csrc / "attention_bwd_sm90.cuh").read_text()
    assert "attention_fwd_sm90.cuh" not in re.findall(r'#include "([^"]+)"', body)
    for kernel, form in (("blockwise_bwd_dq_sm90_kernel", "bwd_dq<D, true>"),
                         ("blockwise_bwd_dkv_sm90_kernel", "bwd_dkv<D, true>"),
                         ("attention_bwd_dq_sm90_kernel", "bwd_dq<D, false>"),
                         ("attention_bwd_dkv_sm90_kernel", "bwd_dkv<D, false>")):
        definition = re.search(rf"\b{kernel}\((.*?)\n}}", body, re.S)
        assert definition and form in definition.group(1), kernel
    assert "attention_bwd_sm90.cuh" in {p.name for p in kernels.source_files("fused_attention")}
    assert "sm90::launch_bwd<" in (csrc / "fused_attention.cu").read_text()
    assert "csrc/attention_bwd_sm90.cuh" in fb.__doc__
