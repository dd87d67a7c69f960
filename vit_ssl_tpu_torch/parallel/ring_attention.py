"""Ring attention: attention over a sequence split across the ``seq`` axis
(after ``vit_ssl_tpu/parallel/ring_attention.py``).

Each of the sp ranks keeps its Q chunk resident while the K/V chunks
rotate once around the seq group (``batch_isend_irecv``: send to the next
rank, receive from the previous one). Every hop attends the Q chunk to the
K/V chunk it holds through kernel B2's lse form
(:func:`..ops.flash_blockwise.blockwise_attention_lse`: the Hopper kernel
on the card, its plain version on the CPU; ``plain=True`` takes the plain
version on the card too) and the hops merge exactly with ``logaddexp``
(JAX ``:135-146``). JAX's ``hop_kernel="auto"`` threshold (1024 tokens, a
TPU measurement) is not copied: every hop on the card is B2, and a shape
B2 refuses raises from its input check.

The backward is one ``torch.autograd.Function`` over the whole ring. Each
hop runs B2's two backward kernels (``blockwise_attention_bwd_dq`` and
``_dkv``) against the **merged** output and log-sum-exp: p = exp(s − lse)
of the whole row is then exactly the hop's share, so each hop's dq, dk and
dv are exact parts of the whole. dq sums at home in fp32; the dK/dV sums
(fp32) travel with their K/V chunk and come home after one more rotation.

The per-rank bodies (:func:`forward_body`, :func:`backward_body`) are
generators that yield at each rotation what they send and take back what
they receive; the rotation is the caller's: :func:`run_ring` (the seq
group's ``batch_isend_irecv``) or :func:`run_virtual` (sp virtual ranks in
one process, the rotation an index shift over the same arithmetic).

:func:`ring_attention` takes the full (B, H, N, D) q, k and v, replicated
over the seq ranks as the model computes them, and returns the full output:
each rank's chunk all-gathered along the sequence, so the rest of the model
runs replicated, as in JAX. Its backward takes the rank's own rows of the
(identical) upstream gradient, and all-gathers the chunks' dq, dk and dv,
so every seq rank holds the whole gradient: neither counts a row twice.
"""

from __future__ import annotations

from typing import Callable, Generator, List, Sequence

import torch
import torch.distributed as dist

from ..ops import flash_blockwise as fb


def merge(o, lse, o_hop, lse_hop):
    """The running fp32 (o, lse) merged with a hop's (o_hop, lse_hop):
    lse' = logaddexp(lse, lse_hop), o' = o·e^(lse−lse') + o_hop·e^(lse_hop−lse')."""
    o_hop = o_hop.float()
    if o is None:
        return o_hop, lse_hop
    lse_new = torch.logaddexp(lse, lse_hop)
    o = (o * torch.exp(lse - lse_new)[..., None]
         + o_hop * torch.exp(lse_hop - lse_new)[..., None])
    return o, lse_new


def _hops(plain: bool):
    """(forward, dq, dkv) of a hop: B2's wrappers, or its plain versions."""
    if plain:
        return (fb.blockwise_attention_lse_plain, fb.blockwise_attention_bwd_dq_reference,
                fb.blockwise_attention_bwd_dkv_reference)
    return (fb.blockwise_attention_lse, fb.blockwise_attention_bwd_dq,
            fb.blockwise_attention_bwd_dkv)


def forward_body(q, k, v, scale: float, n: int, plain: bool = False
                 ) -> Generator[list, list, tuple]:
    """One rank's forward over ``n`` hops: yields ``[kc, vc]`` to rotate and
    takes the next rank's back; returns (o in q's dtype, lse fp32)."""
    fwd = _hops(plain)[0]
    kc, vc = k, v
    o = lse = None
    for hop in range(n):
        o_hop, lse_hop = fwd(q, kc, vc, scale)
        o, lse = merge(o, lse, o_hop, lse_hop)
        if hop < n - 1:
            kc, vc = yield [kc, vc]
    return o.to(q.dtype), lse


def backward_body(q, k, v, o, lse, do, scale: float, n: int, plain: bool = False
                  ) -> Generator[list, list, tuple]:
    """One rank's backward over ``n`` hops against the merged ``o`` and
    ``lse``: yields ``[kc, vc, dk, dv]`` (the last rotation ``[dk, dv]``,
    taking each chunk's sums home) and returns (dq, dk, dv) in q's dtype."""
    _, bwd_dq, bwd_dkv = _hops(plain)
    kc, vc = k, v
    dq = torch.zeros(q.shape, device=q.device, dtype=torch.float32)
    dk = torch.zeros_like(dq)
    dv = torch.zeros_like(dq)
    for hop in range(n):
        dq_hop, delta = bwd_dq(q, kc, vc, o, lse, do, scale)
        dk_hop, dv_hop = bwd_dkv(q, kc, vc, do, lse, delta, scale)
        dq += dq_hop.float()
        dk += dk_hop.float()
        dv += dv_hop.float()
        if hop < n - 1:
            kc, vc, dk, dv = yield [kc, vc, dk, dv]
        else:
            dk, dv = yield [dk, dv]
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def run_ring(body: Generator, rotate: Callable[[list], list]):
    """Drive one rank's body, ``rotate`` sending what it yields to the next
    rank and returning what the previous one sent."""
    try:
        msg = next(body)
        while True:
            msg = body.send(rotate(msg))
    except StopIteration as stop:
        return stop.value


def run_virtual(bodies: Sequence[Generator]) -> list:
    """Drive the bodies of ``len(bodies)`` virtual ranks in lock step in one
    process: at each rotation virtual rank r takes what rank r − 1 yielded."""
    n = len(bodies)
    msgs = [next(b) for b in bodies]
    results: List = [None] * n
    while True:
        received = [msgs[(r - 1) % n] for r in range(n)]
        msgs = []
        for r, body in enumerate(bodies):
            try:
                msgs.append(body.send(received[r]))
            except StopIteration as stop:
                results[r] = stop.value
        if all(res is not None for res in results):
            return results


def group_rotate(group) -> Callable[[list], list]:
    """The seq group's rotation: every tensor to the next rank, the
    previous rank's into fresh buffers (one ``batch_isend_irecv``)."""
    ranks = dist.get_process_group_ranks(group)
    me = dist.get_rank(group)
    nxt, prv = ranks[(me + 1) % len(ranks)], ranks[(me - 1) % len(ranks)]

    def rotate(tensors: list) -> list:
        out = [torch.empty_like(t) for t in tensors]
        ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, group) for t in tensors]
        ops += [dist.P2POp(dist.irecv, t, prv, group) for t in out]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    return rotate


def chunk_rows(x, rank: int, n: int):
    """Rank ``rank``'s chunk of (B, H, N, D) ``x`` along N, contiguous."""
    c = x.shape[2] // n
    return x[:, :, rank * c:(rank + 1) * c].contiguous()


def gather_rows(x, group, n: int):
    """The seq group's chunks of (B, H, c, D) ``x`` joined along the
    sequence in rank order."""
    out = torch.empty(n * x.numel(), device=x.device, dtype=x.dtype)
    dist.all_gather_into_tensor(out, x.contiguous().view(-1), group=group)
    b, h, c, d = x.shape
    return out.view(n, b, h, c, d).permute(1, 2, 0, 3, 4).reshape(b, h, n * c, d)


class _Ring(torch.autograd.Function):
    """Ring attention over the seq group, full (B, H, N, D) in and out."""

    @staticmethod
    def forward(ctx, q, k, v, scale, group, plain):
        n, rank = dist.get_world_size(group), dist.get_rank(group)
        qc, kc, vc = (chunk_rows(x, rank, n) for x in (q, k, v))
        rotate = group_rotate(group)
        o, lse = run_ring(forward_body(qc, kc, vc, scale, n, plain), rotate)
        ctx.save_for_backward(qc, kc, vc, o, lse)
        ctx.args = (scale, group, plain, n, rank, rotate)
        return gather_rows(o, group, n)

    @staticmethod
    def backward(ctx, do):
        qc, kc, vc, o, lse = ctx.saved_tensors
        scale, group, plain, n, rank, rotate = ctx.args
        do_c = chunk_rows(do, rank, n)
        grads = run_ring(backward_body(qc, kc, vc, o, lse, do_c, scale, n, plain),
                         rotate)
        return (*(gather_rows(g, group, n) for g in grads), None, None, None)


def ring_attention(q, k, v, scale: float, group, plain: bool = False):
    """Exact softmax(q·kᵀ·scale)·v of the full (B, H, N, D) heads, computed as
    a ring over the seq ``group`` (N divisible by its size); the output
    carries a gradient when an input requires one."""
    n = dist.get_world_size(group)
    if q.shape[2] % n:
        raise ValueError(f"sequence length {q.shape[2]} is not divisible by the "
                         f"seq group's {n} ranks")
    return _Ring.apply(q, k, v, float(scale), group, bool(plain))


def virtual_ring_forward(q, k, v, scale: float, n: int, plain: bool = False):
    """The ring over ``n`` virtual ranks in one process: (o, lse) of the
    full (B, H, N, D) heads, each rank's chunk in its place."""
    bodies = [forward_body(*(chunk_rows(x, r, n) for x in (q, k, v)), scale, n, plain)
              for r in range(n)]
    outs = run_virtual(bodies)
    return (torch.cat([o for o, _ in outs], dim=2),
            torch.cat([lse for _, lse in outs], dim=2))


def virtual_ring_backward(q, k, v, o, lse, do, scale: float, n: int,
                          plain: bool = False):
    """The ring's backward over ``n`` virtual ranks: (dq, dk, dv) of the full
    heads from the merged ``o`` and ``lse`` (as :func:`virtual_ring_forward`
    gives them) and the upstream ``do``."""
    c = q.shape[2] // n
    bodies = [backward_body(*(chunk_rows(x, r, n) for x in (q, k, v, o)),
                            lse[:, :, r * c:(r + 1) * c].contiguous(),
                            chunk_rows(do, r, n), scale, n, plain)
              for r in range(n)]
    grads = run_virtual(bodies)
    return tuple(torch.cat([g[i] for g in grads], dim=2) for i in range(3))


__all__ = [
    "backward_body", "forward_body", "group_rotate", "merge", "ring_attention",
    "run_ring", "run_virtual", "virtual_ring_backward", "virtual_ring_forward",
]
