"""Ring attention of the port (``vit_ssl_tpu_torch/parallel/ring_attention.py``)
against the JAX package's ``ring_attention_sharded``.

The port's ring runs over 2 and 4 gloo processes on the CPU (each hop B2's
plain versions; ``tests/torch_dist_worker.py``), JAX's over a 2- and
4-device CPU mesh (the XLA devices of ``tests/conftest.py``), on the same
numpy inputs: the fp32 output and the q/k/v gradients of sum(out²) at the
tolerances of JAX's own ``tests/test_ring_attention.py``, the bf16 output at
its bf16 bar. The single-process virtual-rank body (the rotation an index
shift; what ``chip_smoke.py`` runs through B2 on the card) equals the gloo
ring bit for bit. The sp dispatch of ``MultiHeadAttention`` falls back,
with one warning, when sp does not divide N; a sharded ``DTensor`` reaching
any kernel wrapper raises by name.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_dist_worker import qkv, spawn
from vit_ssl_tpu.parallel.ring_attention import create_seq_mesh, ring_attention_sharded
from vit_ssl_tpu_torch.ops import attention as port_attention
from vit_ssl_tpu_torch.parallel import context
from vit_ssl_tpu_torch.parallel.mesh import Mesh
from vit_ssl_tpu_torch.parallel.ring_attention import (
    virtual_ring_backward,
    virtual_ring_forward,
)

N = 32


@pytest.fixture(scope="module", params=[2, 4], ids=["ring2", "ring4"])
def ring_run(request, tmp_path_factory):
    """The gloo ring's results on every rank, and JAX's on as many devices."""
    world = request.param
    out = spawn("ring", world, tmp_path_factory.mktemp(f"ring{world}"), N, timeout=180)
    ranks = [dict(np.load(out / f"ring_{r}.npz")) for r in range(world)]
    q, k, v = (jnp.asarray(x.numpy()) for x in qkv(n=N))
    scale = 1.0 / np.sqrt(q.shape[-1])
    mesh = create_seq_mesh(world)

    def loss(q, k, v):
        return jnp.sum(ring_attention_sharded(q, k, v, scale, mesh) ** 2)

    jax_ref = {"o": np.asarray(ring_attention_sharded(q, k, v, scale, mesh))}
    jax_ref.update(zip(("dq", "dk", "dv"),
                       (np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(q, k, v))))
    qb, kb, vb = (x.astype(jnp.bfloat16) for x in (q, k, v))
    jax_ref["o_bf16"] = np.asarray(ring_attention_sharded(qb, kb, vb, scale, mesh),
                                   np.float32)
    return world, ranks, jax_ref


def test_forward_matches_jax(ring_run):
    _, ranks, ref = ring_run
    np.testing.assert_allclose(ranks[0]["o"], ref["o"], atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("name", ["dq", "dk", "dv"])
def test_gradients_match_jax(ring_run, name):
    _, ranks, ref = ring_run
    np.testing.assert_allclose(ranks[0][name], ref[name], atol=1e-4, rtol=1e-3)


def test_bfloat16_forward_matches_jax(ring_run):
    _, ranks, ref = ring_run
    np.testing.assert_allclose(ranks[0]["o_bf16"], ref["o_bf16"], atol=3e-2, rtol=3e-2)


def test_every_rank_holds_the_whole_result(ring_run):
    """The output is all-gathered along the sequence and so are the
    gradients: every seq rank holds the same whole tensors."""
    world, ranks, _ = ring_run
    for r in range(1, world):
        for name in ("o", "dq", "dk", "dv", "o_bf16"):
            np.testing.assert_array_equal(ranks[r][name], ranks[0][name])


@pytest.mark.parametrize("name", ["o", "dq", "dk", "dv"])
def test_virtual_body_equals_gloo_ring(ring_run, name):
    """The per-rank body over virtual ranks in one process (the rotation an
    index shift) is the gloo ring's arithmetic: bit-equal."""
    _, ranks, _ = ring_run
    np.testing.assert_array_equal(ranks[0][f"virtual_{name}"], ranks[0][name])


@pytest.mark.parametrize("sp", [3, 5])
def test_virtual_body_matches_full_attention(sp):
    """An sp that is not a power of two (ViT-B/16 at 512 px takes sp = 5):
    the virtual ring's output and gradients against plain attention."""
    q, k, v = qkv(n=30 if sp == 3 else 40)
    scale = 1.0 / np.sqrt(q.shape[-1])
    o, lse = virtual_ring_forward(q, k, v, scale, sp)
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
    ref = torch.softmax(qr @ kr.transpose(-1, -2) * scale, -1) @ vr
    do = torch.randn_like(ref)
    (ref * do).sum().backward()
    torch.testing.assert_close(o, ref.detach(), atol=2e-5, rtol=1e-4)
    grads = virtual_ring_backward(q, k, v, o, lse, do, scale, sp)
    for got, want in zip(grads, (qr.grad, kr.grad, vr.grad)):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-3)


def test_sp_dispatch_falls_back_once_per_shape(caplog):
    """sp = 2 does not divide N = 5: the single-device path (the output of
    a call without a mesh), one warning for the shape."""
    attn = port_attention.MultiHeadAttention(16, 2)
    x = torch.randn(2, 5, 16)
    want = attn(x)
    port_attention._SP_FALLBACK_WARNED.discard((5, 2))
    context.set_parallel_context(Mesh({"data": 1, "seq": 2}))
    try:
        assert context.sp_size() == 2
        with caplog.at_level(logging.WARNING):
            got = [attn(x), attn(x)]
    finally:
        context.set_parallel_context(None)
    for g in got:
        torch.testing.assert_close(g, want, rtol=0, atol=0)
    assert sum("does not divide" in r.getMessage() for r in caplog.records) == 1


def test_dtensor_reaching_a_kernel_raises_by_name(tmp_path):
    """A sharded DTensor handed to any kernel wrapper (B1, B3, B2, B4, P2)
    raises TypeError naming the kernel and the argument."""
    out = spawn("dtensor", 2, tmp_path, timeout=120)
    messages = dict(np.load(out / "dtensor_0.npz"))
    assert set(messages) == {"attention_nhd", "fused_attention", "blockwise_attention",
                             "fused_mlp", "masked_matmul"}
    for kernel, message in messages.items():
        assert str(message).startswith(f"{kernel}: ") and "DTensor" in str(message), \
            (kernel, message)
