"""Kernel B1 forward in the PyTorch port (``vit_ssl_tpu_torch.ops.flash_attention``).

The plain PyTorch version (what the wrapper runs for a CPU tensor) is held
against the JAX package's ``attention_nhd`` run in interpret mode, on the
same numpy inputs; the wrapper's checks are exercised on the CPU. The CUDA
kernel itself is held against this plain version on the card, in
``tests/test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ssl_tpu.ops.flash_attention import attention_nhd as jax_attention_nhd
from vit_ssl_tpu_torch import kernels
from vit_ssl_tpu_torch.ops import flash_attention as fa

# (batch, seq, heads, head_dim, block_size): the serving global, the packed
# DINO locals with their block-diagonal mask, and a narrow ragged case
CPU_CASES = [
    (2, 145, 6, 64, 0),
    (2, 148, 6, 64, 37),
    (3, 37, 2, 32, 0),
]

# bf16 outputs: one bf16 ulp is 2^-8 relative, and the two sides may round
# an fp32 value on either side of a tie
BF16_TOL = dict(atol=1e-2, rtol=1e-2)
FP32_TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(b, n, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, n, h * d), dtype=np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,h,d,bs", CPU_CASES)
def test_reference_matches_jax_interpret(b, n, h, d, bs, dtype):
    xs = _inputs(b, n, h, d, seed=n)
    scale = 1.0 / d ** 0.5
    want = jax_attention_nhd(*(jnp.asarray(x, dtype) for x in xs), h, scale,
                             True, bs)
    got = fa.attention_nhd_reference(
        *(torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs), h, scale, bs
    )
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, n, h * d)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32),
        **(FP32_TOL if dtype == "float32" else BF16_TOL),
    )


def test_wrapper_takes_plain_version_for_cpu_tensor():
    xq, xk, xv = (torch.from_numpy(x) for x in _inputs(2, 37, 2, 32))
    before = kernels.launches[fa.KERNEL]
    out = fa.attention_nhd(xq, xk, xv, 2, 0.125, 0)
    torch.testing.assert_close(
        out, fa.attention_nhd_reference(xq, xk, xv, 2, 0.125, 0), rtol=0, atol=0
    )
    assert kernels.launches[fa.KERNEL] == before  # no kernel ran


def test_wrapper_refuses_other_devices():
    x = torch.empty(2, 37, 64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.attention_nhd(x, x, x, 2, 0.125)


@pytest.mark.parametrize("shape,heads,dtype,bs,match", [
    ((2, 37, 96), 2, torch.float32, 0, "head dim 48"),
    ((2, 1025, 128), 2, torch.float32, 0, "sequence length 1025"),
    ((2, 37, 64), 2, torch.float16, 0, "not supported"),
    ((2, 37, 64), 3, torch.float32, 0, "does not split"),
    ((37, 64), 2, torch.float32, 0, "expected"),
    ((2, 37, 64), 2, torch.float32, -1, "block_size"),
])
def test_kernel_input_checks(shape, heads, dtype, bs, match):
    x = torch.zeros(shape, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        fa._check(x, x, x, heads, bs)


def test_kernel_input_checks_layout():
    x = torch.zeros(2, 37, 64)
    with pytest.raises(ValueError, match="contiguous"):
        fa._check(x, x.transpose(0, 1).contiguous().transpose(0, 1), x, 2, 0)
    with pytest.raises(ValueError, match="differs"):
        fa._check(x, torch.zeros(2, 36, 64), x, 2, 0)
    shifted = torch.zeros(2 * 37 * 64 + 1)[1:].view(2, 37, 64)  # 4 bytes off
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._check(x, x, shifted, 2, 0)
    assert fa._check(x, x, x, 2, 0) == 32


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build()
    assert not (tmp_path / "_build").exists()
