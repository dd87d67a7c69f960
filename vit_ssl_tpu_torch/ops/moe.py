"""Mixture-of-Experts feed-forward (port of ``vit_ssl_tpu/ops/moe.py``).

A router sends each token to its top-k of E expert MLPs (V-MoE, Riquelme
et al., arXiv:2106.05974) through the GShard dense dispatch (Lepikhin et
al., arXiv:2006.16668): :func:`moe_routing` turns the router's logits into
a ``combine`` tensor (G, Tg, E, C) of gate weights, C being each expert's
capacity a routing group (:func:`expert_capacity`); one product moves the
tokens into their expert slots, the experts run as one batched pair of
products, and a second product combines their weighted outputs. A token
past an expert's capacity is dropped for that expert (weight 0; the
encoder's residual carries it). Seats go slot-major, then token-major:
every token's first choice is seated before any token's second.

``group_size`` (``model.moe_group_size``) routes the B·N tokens in groups
of that many, each with its own capacity; 0 routes them as one group. The
dispatch is O(Tg²) a group in products and memory, so a real batch routes
per image (``group_size = N``).

The router's two losses, returned by :meth:`MoEFeedForward.forward` as
``aux_weight·balance + zloss_weight·zloss`` where the JAX module sows them:

- load balance (Switch, arXiv:2101.03961): E · Σ_e f_e · P_e, f_e the
  share of top-k assignments to expert e (before capacity), P_e the mean
  router probability; 1 when routing is uniform;
- z-loss (ST-MoE, arXiv:2202.08906): mean(logsumexp(logits)²).

Routing runs in fp32 and its product under PyTorch's fp32 matmul setting,
which the port keeps at ``"highest"`` (:mod:`.precision`: no TF32); the
expert products run in the compute dtype. Ties in the router's
probabilities go to the lower expert index, as ``lax.top_k`` breaks them.
The products are ``torch.einsum``: the JAX module runs them as XLA
einsums, outside any Pallas kernel.

Expert parallelism (``parallel.ep``) and tensor parallelism
(``parallel.tp``, :mod:`..parallel.tensor_parallel`), per JAX's rule rows:
each expert rank holds its experts (``w1``, ``b1``, ``w2``, ``b2`` along
E), each model rank its columns of every expert's hidden (``w1``, ``b1``
along f, ``w2`` along its rows). The router runs whole on every rank, as
the batch is sharded over ``data`` only (JAX's ``_constrain_expert_major``
keeps the tokens of one data index on every expert rank), so the routing,
the aux loss and the dropped share are the same on each and counted once.
An expert rank takes its experts' slice of ``dispatch`` and ``combine``;
a model rank's partial expert outputs are summed over the model axis
before ``b2`` is added, and the partial ``y`` is summed over the expert
axis. The dropout mask is this rank's slice of the whole (G, E, C, f) draw,
so the ranks drop what one process drops.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import EXPERT_AXIS, MODEL_AXIS
from ..parallel.tensor_parallel import axis_of, run, shard
from .dropout import Dropout, keep_mask
from .initializers import bias_, check_scheme, kernel_


def expert_capacity(num_tokens: int, num_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Each expert's slots C: ⌈k·T/E · capacity_factor⌉ rounded up to a
    multiple of 8, at most T and at least 1."""
    c = math.ceil(top_k * num_tokens / num_experts * capacity_factor)
    c = ((c + 7) // 8) * 8
    return max(1, min(num_tokens, c))


def top_k_lower_index(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of the last dim and their indices, ties to the lower
    index (``lax.top_k``'s order; ``torch.topk`` promises none)."""
    values, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def moe_routing(router_logits: torch.Tensor, top_k: int, capacity: int,
                normalize_gates: bool = True
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Top-k routing with a capacity per expert, over (..., T, E) logits:
    each leading index is a routing group of its own.

    Returns ``(combine, aux)``: ``combine`` (..., T, E, C) fp32, a token's
    gate at its expert and slot and 0 elsewhere; ``aux`` the fp32 scalars
    (one a group) ``balance``, ``zloss`` and ``dropped_frac``, the share of
    top-k assignments past capacity. ``normalize_gates`` rescales each
    token's kept top-k probabilities to sum to 1."""
    *lead, t, e = router_logits.shape
    logits = router_logits.float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k_lower_index(probs, top_k)  # (..., T, k)
    if normalize_gates:
        gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    counts = logits.new_zeros((*lead, 1, e), dtype=torch.long)  # seated so far
    combine = logits.new_zeros((*lead, t, e * capacity))
    kept = logits.new_zeros(tuple(lead), dtype=torch.long)
    for slot in range(top_k):
        choice = gate_idx[..., slot]  # (..., T)
        onehot = F.one_hot(choice, e)  # (..., T, E)
        # the slot this token would take at its expert: tokens before it
        # and seats of earlier slots come first
        pos_at = torch.cumsum(onehot, dim=-2) - onehot + counts
        pos = (pos_at * onehot).sum(dim=-1)  # (..., T)
        keep = pos < capacity
        counts = counts + (onehot * keep[..., None]).sum(dim=-2, keepdim=True)
        kept = kept + keep.sum(dim=-1)
        # JAX's one_hot(pos >= C) is all zeros: an overflowing token adds 0
        gate = gate_vals[..., slot] * keep
        seat = choice * capacity + torch.where(keep, pos, torch.zeros_like(pos))
        combine.scatter_add_(-1, seat[..., None], gate[..., None])
    combine = combine.reshape(*lead, t, e, capacity)

    assign_frac = F.one_hot(gate_idx, e).float().sum(dim=(-3, -2)) / (t * top_k)
    mean_prob = probs.mean(dim=-2)
    balance = e * (assign_frac * mean_prob).sum(dim=-1)
    zloss = (torch.logsumexp(logits, dim=-1) ** 2).mean(dim=-1)
    dropped = torch.clamp(1.0 - kept.float() / (t * top_k), 0.0, 1.0)
    return combine, {"balance": balance, "zloss": zloss, "dropped_frac": dropped}


class MoEFeedForward(nn.Module):
    """Router and E expert MLPs in place of :class:`.feed_forward.FeedForwardBlock`:
    (B, N, d) → (B, N, d). The parameters keep the JAX module's names and
    layouts: ``router`` (d, E) fp32, ``w1`` (E, d, f), ``b1`` (E, f), ``w2``
    (E, f, d), ``b2`` (E, d).

    :meth:`forward` returns ``(y, aux_loss, dropped_frac)``. Unless
    ``deterministic``, the generator draws, in order, the router noise
    (``router_noise`` > 0) and the dropout mask after the first product."""

    def __init__(self, d_model: int, d_ff: int, num_experts: int, top_k: int = 2,
                 capacity_factor: float = 1.25, group_size: int = 0,
                 aux_weight: float = 0.01, zloss_weight: float = 1e-3,
                 router_noise: float = 0.0, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32, fast_dropout: bool = True,
                 device=None):
        super().__init__()
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"moe top_k={top_k} must be in [1, num_experts="
                             f"{num_experts}]")
        self.dtype = dtype
        self.num_experts, self.top_k = int(num_experts), int(top_k)
        self.capacity_factor = float(capacity_factor)
        self.group_size = int(group_size)
        self.aux_weight, self.zloss_weight = float(aux_weight), float(zloss_weight)
        self.router_noise = float(router_noise)
        e, d, f = num_experts, d_model, d_ff
        self.router = nn.Parameter(torch.empty(d, e, device=device))
        self.w1 = nn.Parameter(torch.empty(e, d, f, device=device))
        self.b1 = nn.Parameter(torch.empty(e, f, device=device))
        self.w2 = nn.Parameter(torch.empty(e, f, d, device=device))
        self.b2 = nn.Parameter(torch.empty(e, d, device=device))
        self.dropout = Dropout(dropout, fast_dropout)
        self.init_parameters("reference")

    @torch.no_grad()
    def init_parameters(self, scheme: str, generator: Optional[torch.Generator] = None):
        """The router as a (d → E) kernel, then each expert's w1, b1, w2, b2
        as its own (d → f) and (f → d) Linear: fans from (d, f), not E·d."""
        check_scheme(scheme)
        d, f = self.w1.shape[1], self.w1.shape[2]
        kernel_(self.router, d, scheme, generator)
        for i in range(self.num_experts):
            kernel_(self.w1[i], d, scheme, generator)
            bias_(self.b1[i], d, scheme, generator)
            kernel_(self.w2[i], f, scheme, generator)
            bias_(self.b2[i], f, scheme, generator)
        return self

    def forward(self, x, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        b, n, d = x.shape
        t = b * n
        tg = t
        if self.group_size > 0:
            if t % self.group_size != 0:
                raise ValueError(f"moe group_size={self.group_size} must divide the "
                                 f"token count B·N = {b}·{n} = {t}")
            tg = self.group_size
        flat = x.reshape(t // tg, tg, d)

        logits = torch.matmul(flat.float(), self.router.float())  # (G, Tg, E)
        if not deterministic and self.router_noise > 0.0:
            if generator is None:
                raise ValueError("router noise in training mode needs a torch.Generator")
            noise = torch.randn(logits.shape, generator=generator, device=logits.device)
            logits = logits + noise * self.router_noise
        capacity = expert_capacity(tg, self.num_experts, self.top_k,
                                   self.capacity_factor)
        combine, aux = moe_routing(logits, self.top_k, capacity)
        aux = {k: v.mean() for k, v in aux.items()}
        aux_loss = self.aux_weight * aux["balance"] + self.zloss_weight * aux["zloss"]

        dt = self.dtype
        dispatch = (combine > 0).to(dt)
        mask = None
        rate = self.dropout.rate
        if not deterministic and rate > 0.0:
            if generator is None:
                raise ValueError("dropout in training mode needs a torch.Generator")
            mask = keep_mask((t // tg, self.num_experts, capacity, self.w1.shape[-1] *
                              _real_size(axis_of(self, MODEL_AXIS))),
                             rate, generator, self.dropout.fast)

        def experts(flat, combine, w1, b1, w2, b2, e_rank, e_size):
            """This expert rank's experts: their share of y."""
            local = w1.shape[0]
            e0 = e_rank * local
            expert_in = torch.einsum("gtec,gtd->gecd", dispatch[:, :, e0:e0 + local],
                                     flat.to(dt))

            def hidden(expert_in, w1, b1, w2, m_rank, m_size):
                """This model rank's columns of each local expert's hidden."""
                h = torch.einsum("gecd,edf->gecf", expert_in, w1.to(dt)) \
                    + b1.to(dt)[None, :, None, :]
                h = F.gelu(h)
                if mask is not None:
                    keep = shard(mask[:, e0:e0 + local], 3, m_rank, m_size)
                    h = torch.where(keep, h / (1.0 - rate), h.new_zeros(()))
                return torch.einsum("gecf,efd->gecd", h.to(dt), w2.to(dt))

            out = run(axis_of(self, MODEL_AXIS), hidden, (expert_in,), (w1, b1, w2),
                      (2, 1, 1)) + b2.to(dt)[None, :, None, :]
            return torch.einsum("gtec,gecd->gtd", combine[:, :, e0:e0 + local].to(dt), out)

        y = run(axis_of(self, EXPERT_AXIS), experts, (flat, combine),
                (self.w1, self.b1, self.w2, self.b2), (0, 0, 0, 0))
        return y.reshape(b, n, d), aux_loss, aux["dropped_frac"]


def _real_size(axis) -> int:
    """The axis's size where this rank holds a slice of the parameters (real
    ranks), else 1."""
    return 1 if axis is None or axis.virtual else axis.size
