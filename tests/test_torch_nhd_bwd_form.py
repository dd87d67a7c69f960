"""Kernel B1's backward in the PyTorch port: the host rule that names its
body and form, and the rows whose gradient is exactly zero.

``ops/flash_attention.py::attention_nhd_bwd_form`` names, for each
(n, block_size, dtype), the form of ``csrc/attention_nhd_bwd.cu`` that a
CUDA call runs: bf16 takes the Hopper backward of
``csrc/attention_bwd_sm90.cuh`` (resident up to ``RESIDENT_MAX_SEQ``,
streamed above), fp32 the CUDA-core body of ``csrc/attention_bwd.cuh``. The
rule and the kernels' sources are checked against each other here; the
kernels themselves run on the card (``tests/test_torch_cuda_kernels.py``).

A row that keeps one key (N = 1, or blocks of one token) has p = 1 and
dq = dk = 0 exactly: the plain backward and the JAX package's (interpret
mode, on the same numpy inputs) both give zeros there, the yardstick that
holds the card's kernels to an exact δ = Σ p·dp.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ssl_tpu.ops.flash_attention import attention_nhd as jax_attention_nhd
from vit_ssl_tpu_torch import kernels
from vit_ssl_tpu_torch.ops import flash_attention as fa

BF16, FP32 = torch.bfloat16, torch.float32

# (seq, block_size, dtype, form): DINO's globals and packed locals, both
# sides of RESIDENT_MAX_SEQ, a ragged mask above it, MAX_SEQ, and fp32
FORM_CASES = [
    (1, 0, BF16, "resident"), (64, 0, BF16, "resident"), (65, 1, BF16, "resident"),
    (145, 0, BF16, "resident"), (148, 37, BF16, "resident"), (256, 0, BF16, "resident"),
    (257, 0, BF16, "streamed"), (300, 7, BF16, "streamed"), (577, 0, BF16, "streamed"),
    (1024, 0, BF16, "streamed"), (1, 0, FP32, "cuda-core"), (145, 0, FP32, "cuda-core"),
    (148, 37, FP32, "cuda-core"), (1024, 0, FP32, "cuda-core"),
]


@pytest.mark.parametrize("n,bs,dtype,form", FORM_CASES)
def test_b1_backward_form_follows_length_and_dtype(n, bs, dtype, form):
    """bf16: resident up to RESIDENT_MAX_SEQ, streamed above, whatever the
    mask; fp32: the CUDA-core body. Each form names two kernels."""
    assert fa.attention_nhd_bwd_form(n, bs, dtype) == form
    dq, dkv = fa.BACKWARD_BODIES[form]
    assert "_dq_" in dq and "_dkv_" in dkv


@pytest.mark.parametrize("n,bs,dtype,match", [
    (0, 0, BF16, "sequence length 0"), (fa.MAX_SEQ + 1, 0, BF16, "sequence length"),
    (145, -1, BF16, "block_size"), (145, 0, torch.float16, "not supported"),
])
def test_b1_backward_form_refuses_what_the_kernels_do_not_take(n, bs, dtype, match):
    with pytest.raises(ValueError, match=match):
        fa.attention_nhd_bwd_form(n, bs, dtype)


def _csrc(name):
    return (kernels.CSRC_DIR / name).read_text()


def test_resident_limit_and_kernel_names_are_the_headers():
    """RESIDENT_MAX_SEQ is the header's kResidentTiles tiles of kKeys; the bf16
    forms' kernels are __global__ kernels of attention_bwd_sm90.cuh, each
    running its form of the body (resident: bwd_*<D, false, false, kMasked,
    true>), the fp32 form's of attention_bwd.cuh; the library's sources
    reach both headers."""
    body = _csrc("attention_bwd_sm90.cuh")
    tiles = re.findall(r"constexpr int kResidentTiles = (\d+);", body)
    keys = re.findall(r"constexpr int kKeys = (\d+);", _csrc("sm90_common.cuh"))
    assert len(tiles) == len(keys) == 1
    assert fa.RESIDENT_MAX_SEQ == int(tiles[0]) * int(keys[0])
    for form in ("resident", "streamed"):
        for kernel, part in zip(fa.BACKWARD_BODIES[form], ("bwd_dq", "bwd_dkv")):
            definition = re.search(rf"__global__[^;]*?\b{kernel}\((.*?)\n}}", body, re.S)
            assert definition, kernel
            resident = ", true>" if form == "resident" else f"{part}<D, false, false, kMasked>"
            assert part in definition.group(1) and resident in definition.group(1), kernel
    f32 = _csrc("attention_bwd.cuh")
    for kernel in fa.BACKWARD_BODIES["cuda-core"]:
        assert re.search(rf"\b{kernel}\(", f32), kernel
    files = {p.name for p in kernels.source_files(fa.KERNEL_BWD)}
    assert {"attention_bwd_sm90.cuh", "attention_bwd.cuh"} <= files


def test_b1_bf16_backward_has_one_body():
    """The entry sends bf16 to the Hopper backward and fp32 to the CUDA-core
    body; no mma.sync backward body or its helpers are left."""
    entry = _csrc("attention_nhd_bwd.cu")
    assert re.search(r"if \(is_bf16\) \{.*?sm90::launch_nhd_bwd<", entry, re.S)
    assert "bwd_dispatch<false>(" in entry
    for name in ("attention_bwd.cuh", "attention_nhd_common.cuh", "attention_nhd_bwd.cu"):
        assert not re.search(r"_bf16_kernel|mma_abt8|mma_ab16|load_a_frags|load_tile_bf16",
                             _csrc(name)), name


def _jax_grads(xs, do, h, scale, bs, dtype):
    def f(q, k, v):
        return jax_attention_nhd(q, k, v, h, scale, True, bs)

    _, vjp = jax.vjp(f, *(jnp.asarray(x, dtype) for x in xs))
    return [np.asarray(g, np.float32) for g in vjp(jnp.asarray(do, dtype))]


# (batch, seq, heads, head_dim, block_size): one token; blocks of one token
ONE_KEY_CASES = [(2, 1, 2, 32, 0), (1, 20, 2, 32, 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,h,d,bs", ONE_KEY_CASES)
def test_one_kept_key_gives_exactly_zero_dq_and_dk(b, n, h, d, bs, dtype):
    """Every row keeps one key, so p = 1 and ds = p (dp - δ) scale = 0: the
    plain backward's dq and dk are exactly zero, as the JAX package's, and
    its dv (= do) matches JAX's."""
    rng = np.random.default_rng(n + bs)
    xs = [rng.standard_normal((b, n, h * d), dtype=np.float32) for _ in range(3)]
    do = rng.standard_normal((b, n, h * d), dtype=np.float32)
    scale = 1.0 / d ** 0.5
    want = _jax_grads(xs, do, h, scale, bs, dtype)
    tdt = getattr(torch, dtype)
    got = fa.attention_nhd_bwd_reference(*(torch.from_numpy(x).to(tdt) for x in xs),
                                         torch.from_numpy(do), h, scale, bs)
    for name, g, w in zip(("dq", "dk"), got, want):
        assert not g.any() and not w.any(), name
    np.testing.assert_array_equal(got[2].float().numpy(), want[2])
