"""Kernel P2's bf16 bodies as wgmma/TMA products (``csrc/masked_matmul.cu``
on ``csrc/mlp_gemm_sm90.cuh``'s product body).

What this host can check without a card: every kernel that the wrapper
(``ops/masked_matmul.py::HOPPER_BODIES``) names for a bf16 entry is a
``__global__`` of P2's source and is launched from its C entries;
``chip_smoke.py``'s ``P2_BODIES`` is the wrapper's table; no mma.sync bf16
body is left in P2's source or in ``csrc/weight_grad.cuh``; and the port's
``masked_matmul`` (its plain versions on the CPU) against the JAX probe's
in interpret mode at the probe's widths (1536 -> 384) and the ragged token
counts 1 and 70, where the Hopper bodies' TMA loads zero-fill and their
stores write nothing, at ``tests/test_torch_masked_matmul.py``'s
tolerances. The kernels themselves are held against the plain versions on
the card (``tests/test_torch_cuda_kernels.py``).
"""

import ast
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_masked_matmul import FP32, KEEP, _bf16_tol, _jax_probe
from vit_ssl_tpu_torch import kernels
from vit_ssl_tpu_torch.ops import masked_matmul as mm

ROOT = Path(__file__).resolve().parents[1]
SOURCE = kernels.CSRC_DIR / "masked_matmul.cu"
D_FF, D_OUT = 1536, 384  # the probe's FFN: DINO ViT-S/8's second product


def _source_kernels():
    """The __global__ kernels that P2's source defines, by name."""
    return set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                          r"(\w+)\s*\(", SOURCE.read_text()))


def _chip_smoke_p2_bodies():
    """The ``P2_BODIES`` table of ``chip_smoke.py``, read without importing
    the script."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(target, "id", None) == "P2_BODIES" for target in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError("chip_smoke.py has no P2_BODIES")


@pytest.mark.parametrize("entry", sorted(mm.HOPPER_BODIES))
def test_wrapper_bodies_are_kernels_of_the_source(entry):
    bodies = mm.HOPPER_BODIES[entry]
    assert bodies and set(bodies) <= _source_kernels(), (entry, bodies)
    text = SOURCE.read_text()
    for body in bodies:
        assert re.search(rf"launch_gemm(?:<\w+>)?\(\s*{body}\b", text), body


def test_every_hopper_kernel_of_the_source_is_named():
    """The source's wgmma/TMA kernels are exactly the wrapper's, and its
    C entries' bf16 branches reach them through the sm90 launchers."""
    hopper = {k for k in _source_kernels() if k.endswith("_sm90_kernel")}
    assert hopper == {b for bodies in mm.HOPPER_BODIES.values() for b in bodies}
    text = SOURCE.read_text()
    assert "sm90::forward(" in text and "sm90::backward(" in text
    assert '#include "mlp_gemm_sm90.cuh"' in text and "reduce_splits" in text


def test_chip_smoke_bodies_are_the_wrappers():
    assert {k: tuple(v) for k, v in _chip_smoke_p2_bodies().items()} == mm.HOPPER_BODIES


def test_no_mma_sync_bf16_body_remains():
    """P2's mma.sync tiles and the bf16 weight kernel are gone; the fp32
    CUDA-core bodies stay."""
    for path in (SOURCE, kernels.CSRC_DIR / "weight_grad.cuh"):
        text = path.read_text()
        for gone in ("mma_bf16(", "mma.sync", "cp_async16(", "masked_mm_bf16",
                     "mlp_weights_bf16", "load_a(", "load_b("):
            assert gone not in text, (path.name, gone)
    assert "masked_mm_f32" in SOURCE.read_text()
    assert "mlp_weights_f32" in (kernels.CSRC_DIR / "weight_grad.cuh").read_text()


def _inputs(t, seed):
    """h (GELU-like), a keep-mask at rate 0.1, JAX-layout w2 (d_ff, d_out),
    b2 and an upstream gradient, all numpy."""
    rng = np.random.default_rng(seed)
    pre = rng.standard_normal((t, D_FF), dtype=np.float32)
    h = pre * 0.5 * (1 + np.tanh(0.8 * pre))
    mask = rng.random((t, D_FF)) >= 0.1
    w2 = rng.standard_normal((D_FF, D_OUT), dtype=np.float32) / np.sqrt(D_FF)
    b2 = 0.1 * rng.standard_normal(D_OUT, dtype=np.float32)
    do = rng.standard_normal((t, D_OUT), dtype=np.float32)
    return h, mask, w2, b2, do


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 70])
def test_masked_matmul_matches_the_probe_at_ragged_t(t, dtype):
    """The output and dh, dw2, db2 (through ``jax.vjp``) at T = 1 and
    T = 70: rows that fill no 128-row tile."""
    h, mask, w2, b2, do = _inputs(t, seed=20 + t)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    probe = _jax_probe()
    jmask = jnp.asarray(mask, jnp.int8)
    out, vjp = jax.vjp(lambda a, w, b: probe.masked_matmul(a, jmask, w, b, KEEP),
                       *(jnp.asarray(a, jd) for a in (h, w2, b2)))
    want = [np.asarray(g, np.float32) for g in (out, *vjp(jnp.asarray(do, jd)))]
    want[2] = want[2].T  # dw2 in the nn.Linear layout

    leaves = [torch.from_numpy(h).to(td).requires_grad_(),
              torch.from_numpy(np.ascontiguousarray(w2.T)).to(td).requires_grad_(),
              torch.from_numpy(b2).to(td).requires_grad_()]
    got = mm.masked_matmul(leaves[0], torch.from_numpy(mask), *leaves[1:], KEEP)
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(do).to(td))
    for name, g, w in zip(("o", "dh", "dw2", "db2"), (got, *grads), want):
        assert g.dtype == td and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.detach().float().numpy(), w, err_msg=name,
                                   **(FP32 if dtype == "float32" else _bf16_tol(w)))
