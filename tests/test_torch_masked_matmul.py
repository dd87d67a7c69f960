"""Kernel P2 (dropout-masked second FFN product) in the PyTorch port
(``vit_ssl_tpu_torch.ops.masked_matmul``) and its probe
(``vit_ssl_tpu_torch/scripts/dropout_epilogue_probe.py``).

The port's ``masked_matmul`` (its plain PyTorch versions for a CPU tensor)
is held against ``masked_matmul`` of ``scripts/dropout_epilogue_probe.py``,
loaded by file and run interpreted off the TPU as that script runs it, on
the same numpy inputs: the output, and dh, dw2 and db2 through
``jax.vjp``, at fp32 and bf16, at a ragged token count. The JAX function
takes w2 as (d_ff, d_out); the port takes the ``nn.Linear`` (d_out, d_ff)
layout, so the tests transpose. The CUDA kernels are held against the plain
versions on the card, in ``tests/test_torch_cuda_kernels.py``.
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ssl_tpu_torch import kernels
from vit_ssl_tpu_torch.ops import masked_matmul as mm

REPO = Path(__file__).resolve().parent.parent
T, D_FF, D_OUT = 300, 256, 128  # a ragged token count at small widths
KEEP = 0.9

# fp32: the same products summed in other orders
FP32 = dict(atol=1e-5, rtol=1e-5)


def _bf16_tol(want):
    """One bf16 ulp at the scale of the largest value: both sides round at
    the same points, and an fp32 sum near a rounding tie may land on either
    side of it."""
    return dict(atol=2.0 ** -7 * float(np.abs(want).max()), rtol=0)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_probe():
    return _load(REPO / "scripts" / "dropout_epilogue_probe.py", "jax_dropout_epilogue_probe")


def _port_probe():
    return _load(REPO / "vit_ssl_tpu_torch" / "scripts" / "dropout_epilogue_probe.py",
                 "port_dropout_epilogue_probe")


def _inputs(seed=0):
    """h (GELU-like), a keep-mask at rate 0.1, JAX-layout w2 (d_ff, d_out),
    b2 and an upstream gradient, all numpy."""
    rng = np.random.default_rng(seed)
    pre = rng.standard_normal((T, D_FF), dtype=np.float32)
    h = pre * 0.5 * (1 + np.tanh(0.8 * pre))
    mask = rng.random((T, D_FF)) >= 0.1
    w2 = rng.standard_normal((D_FF, D_OUT), dtype=np.float32) / np.sqrt(D_FF)
    b2 = 0.1 * rng.standard_normal(D_OUT, dtype=np.float32)
    do = rng.standard_normal((T, D_OUT), dtype=np.float32)
    return h, mask, w2, b2, do


def _torch_args(h, mask, w2, b2, dtype):
    """The port's arguments: w2 transposed to the nn.Linear layout."""
    return (torch.from_numpy(h).to(dtype), torch.from_numpy(mask),
            torch.from_numpy(np.ascontiguousarray(w2.T)).to(dtype),
            torch.from_numpy(b2).to(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_matmul_matches_the_probe(dtype):
    h, mask, w2, b2, do = _inputs(seed=1)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(a, jd) for a in (h, w2, b2)]
    jmask = jnp.asarray(mask, jnp.int8)
    probe = _jax_probe()
    out, vjp = jax.vjp(lambda a, w, b: probe.masked_matmul(a, jmask, w, b, KEEP), *jargs)
    dh, dw2, db2 = vjp(jnp.asarray(do, jd))
    want_out = np.asarray(out, np.float32)
    want_grads = [np.asarray(g, np.float32) for g in (dh, dw2.T, db2)]

    th, tmask, tw2, tb2 = _torch_args(h, mask, w2, b2, td)
    leaves = [x.requires_grad_() for x in (th, tw2, tb2)]
    before = dict(kernels.launches)
    got = mm.masked_matmul(leaves[0], tmask, leaves[1], leaves[2], KEEP)
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(do).to(td))
    assert dict(kernels.launches) == before  # CPU: the plain versions, no kernel
    assert got.dtype == td and got.shape == (T, D_OUT)
    np.testing.assert_allclose(got.detach().float().numpy(), want_out,
                               **(FP32 if dtype == "float32" else _bf16_tol(want_out)))
    for name, g, w, a in zip(("dh", "dw2", "db2"), grads, want_grads, leaves):
        assert g.dtype == td and g.shape == a.shape, name
        np.testing.assert_allclose(g.float().numpy(), w, err_msg=name,
                                   **(FP32 if dtype == "float32" else _bf16_tol(w)))


def test_plain_versions_round_where_the_kernel_rounds():
    """bf16: h·mask/keep is rounded before the product, and dh after the
    mask scale, as the JAX kernel rounds them; a uint8 mask is the bool
    mask."""
    h, mask, w2, b2, do = _inputs(seed=2)
    th, tmask, tw2, tb2 = _torch_args(h, mask, w2, b2, torch.bfloat16)
    hm = (th.float() * (tmask.float() / KEEP)).to(torch.bfloat16)
    want = (hm.float() @ tw2.float().t() + tb2.float()).to(torch.bfloat16)
    assert torch.equal(mm.masked_matmul_reference(th, tmask, tw2, tb2, KEEP), want)
    assert torch.equal(mm.masked_matmul_reference(th, tmask.to(torch.uint8), tw2, tb2,
                                                  KEEP), want)
    tdo = torch.from_numpy(do)
    dh, dw2, db2 = mm.masked_matmul_bwd_reference(th, tmask, tdo, tw2, KEEP)
    g = tdo.to(torch.bfloat16).float()
    assert torch.equal(dh, ((g @ tw2.float()) * (tmask.float() / KEEP)).to(torch.bfloat16))
    assert torch.equal(dw2, (g.t() @ hm.float()).to(torch.bfloat16))
    assert torch.equal(db2, g.sum(0).to(torch.bfloat16))
    assert bool((dh[~tmask] == 0).all())  # dropped units get no gradient


def test_wrappers_take_plain_versions_on_cpu():
    h, mask, w2, b2, do = _inputs(seed=3)
    th, tmask, tw2, tb2 = _torch_args(h, mask, w2, b2, torch.float32)
    tdo = torch.from_numpy(do)
    before = dict(kernels.launches)
    assert torch.equal(mm.masked_matmul_fwd(th, tmask, tw2, tb2, KEEP),
                       mm.masked_matmul_reference(th, tmask, tw2, tb2, KEEP))
    got = mm.masked_matmul_bwd(th, tmask, tdo, tw2, KEEP)
    want = mm.masked_matmul_bwd_reference(th, tmask, tdo, tw2, KEEP)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    # no gradient wanted: the forward alone, the same values
    assert torch.equal(mm.masked_matmul(th, tmask, tw2, tb2, KEEP),
                       mm.masked_matmul_reference(th, tmask, tw2, tb2, KEEP))
    assert dict(kernels.launches) == before


def test_wrapper_refuses_other_devices():
    x = torch.empty(4, 128, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        mm.masked_matmul(x, x, x, x, KEEP)


def _kernel_args(t=8, d_ff=256, d_out=128, dtype=torch.float32):
    return (torch.zeros(t, d_ff, dtype=dtype), torch.ones(t, d_ff, dtype=torch.bool),
            torch.zeros(d_out, d_ff, dtype=dtype))


@pytest.mark.parametrize("t,d_ff,d_out,dtype,match", [
    (8, 192, 128, torch.float32, "multiples of 128"),
    (8, 256, 64, torch.float32, "multiples of 128"),
    (0, 256, 128, torch.float32, "at least one token"),
    (8, 256, 128, torch.float16, "not supported"),
])
def test_kernel_input_checks(t, d_ff, d_out, dtype, match):
    h, mask, w2 = _kernel_args(t, d_ff, d_out, dtype)
    with pytest.raises(ValueError, match=match):
        mm._check(h, mask, w2)


def test_kernel_input_checks_layout():
    h, mask, w2 = _kernel_args()
    mm._check(h, mask, w2, b2=torch.zeros(128), do=torch.zeros(8, 128))
    mm._check(h, mask.to(torch.uint8), w2)
    with pytest.raises(ValueError, match="nn.Linear layout"):
        mm._check(h, mask, torch.zeros(256, 128))  # w2 given as (d_ff, d_out)
    with pytest.raises(ValueError, match="keep-mask"):
        mm._check(h, torch.ones(8, 256), w2)  # float, not bool
    with pytest.raises(ValueError, match="keep-mask"):
        mm._check(h, mask[:4], w2)
    with pytest.raises(ValueError, match="contiguous"):
        mm._check(h.t().contiguous().t(), mask, w2)
    shifted = torch.zeros(8 * 256 + 1)[1:].view(8, 256)  # 4 bytes off
    with pytest.raises(ValueError, match="16-byte aligned"):
        mm._check(shifted, mask, w2)
    with pytest.raises(ValueError, match="do"):
        mm._check(h, mask, w2, do=torch.zeros(8, 256))
    with pytest.raises(ValueError, match="b2"):
        mm._check(h, mask, w2, b2=torch.zeros(128, dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# the probe, P2's path


def test_probe_imports_neither_jax_nor_the_jax_package():
    """Loaded by file, as the tests load the JAX probe: no JAX."""
    code = (
        "import importlib.util, sys\n"
        "spec = importlib.util.spec_from_file_location('probe', "
        "'vit_ssl_tpu_torch/scripts/dropout_epilogue_probe.py')\n"
        "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'vit_ssl_tpu')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]"


def test_probe_legs_compute_one_ffn():
    """On the CPU at small widths: the epilogue FFN (P2's plain versions) and
    the fused FFN (B4's) give the plain-pass FFN's output and gradients on
    one keep-mask, well inside the probe's own tolerances."""
    probe = _port_probe()
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((70, 384), dtype=np.float32)).to(torch.bfloat16)
    params = {"w1": torch.from_numpy(0.05 * rng.standard_normal((256, 384), dtype=np.float32)),
              "b1": torch.zeros(256), "w2": torch.from_numpy(
                  0.05 * rng.standard_normal((384, 256), dtype=np.float32)),
              "b2": torch.zeros(384)}
    params = {k: v.to(torch.bfloat16) for k, v in params.items()}
    mask = torch.from_numpy(rng.random((70, 256)) >= 0.1)
    out_b, _, grads_b = probe._loss_and_grads(probe.ffn_xla, params, x, mask)
    for ffn in (probe.ffn_epilogue, probe.ffn_fused):
        out_a, _, grads_a = probe._loss_and_grads(ffn, params, x, mask)
        torch.testing.assert_close(out_a.float(), out_b.float(), atol=2e-2, rtol=2e-2)
        for a, b in zip(grads_a, grads_b):
            torch.testing.assert_close(a.float(), b.float(), atol=0.5, rtol=2e-2)


def test_probe_verdict_follows_the_retire_rule():
    probe = _port_probe()
    assert probe.verdict({"xla": 2.0, "epilogue": 1.9}).startswith("epilogue beats xla")
    assert probe.verdict({"xla": 2.0, "epilogue": 1.96}).startswith("retire")
    assert probe.verdict({"xla": 2.0, "epilogue": 2.5}).startswith("retire")


def test_probe_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the card-less path")
    out = subprocess.run([sys.executable, "-m",
                          "vit_ssl_tpu_torch.scripts.dropout_epilogue_probe"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
