"""Pipeline parallelism over the encoder blocks (``parallel.pp``, the
``pipe`` axis; after ``vit_ssl_tpu/parallel/pipeline.py``).

The L blocks split into P stages (one a rank of the pipe group) and M
microbatches flow through them on JAX's timetables:

- GPipe (``interleave`` V = 1): stage p runs microbatch mb at tick
  ``mb + p``; ``M + P − 1`` ticks;
- Megatron-style interleaving (V > 1): the blocks split into V·P chunks,
  rank p holding chunks p, P + p, …; chunk (v, p) runs microbatch mb at
  tick ``v·M + mb + p``, the ranks form a ring (the last hands pass v's
  output back to the first for pass v + 1), ``V·M + P − 1`` ticks. It
  needs M ≥ P (the wrap arrives before it is needed) and V·P dividing L,
  refused with JAX's messages.

A bubble tick computes nothing (JAX skips it with ``lax.cond``): each rank
runs its work items (:func:`schedule`) in tick order, and
:func:`pipeline_bubble_fraction` is JAX's ``(P−1)/(V·M+P−1)``.

One **work item** (:func:`stage_body`: a chunk's blocks over a microbatch)
serves three drivers, as the tensor-parallel bodies do
(:mod:`.tensor_parallel`): the whole stack (one stage: the model's own loop,
:func:`Pipeline` is not used), real ranks (:class:`GroupTransport`: each
rank its own stage, activations handed to the next stage with
``isend``/``irecv`` on the pipe group: gloo on the CPU, NCCL on the card),
and virtual stages in one process (:class:`VirtualTransport`: every
stage's items in tick order, the tensors handed over in memory; one card
holds one rank, so the card checks the schedule this way).

The backward is one ``torch.autograd.Function`` a pipelined call
(:class:`_Pipelined`). Its forward runs this rank's items under
``enable_grad`` on detached microbatch inputs and keeps each item's input
and output; its backward runs the items in reverse tick order: the
cotangent received from the consumer (the last chunk's: this microbatch's
rows of the upstream gradient), a backward through the kept graph into the
chunk's parameters, the input's cotangent sent to the producer. The last
stage's output reaches every rank of the pipe group (JAX's ``psum``, a
broadcast here); since every rank computes the same loss from it, the last
stage takes its own copy of the upstream gradient, not P summed copies.
The first stage's input cotangent is broadcast back, so that every rank's
embedding takes the same gradient, one process's.

Dropout: each (global layer, microbatch) draws from its own generator,
seeded from one draw of the call's generator (:func:`layer_key`; the same
on every pipe rank of a data index), so P = 2 and P = 4 at the same M,
plain or interleaved, draw the same masks. JAX folds (layer, microbatch)
into its key alike: a stream of its own, held to the unpipelined numerics
at dropout 0 only.

Not ported: ``stack_block_params`` and ``unstack_block_params`` (pytree
plumbing for ``lax.scan``: the port's stages are slices of the unrolled
``encoder_blocks``, ``scan_layers`` × pp is refused as in JAX, and
``ops/encoder_stack.py`` converts the layouts); ``create_pipe_mesh``
(:func:`.mesh.mesh_from_config` lays the pipe axis out);
``pipeline_sharding`` (there is no GSPMD).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..ops.encoder_block import remat_block, wants_remat
from . import context
from .mesh import PIPE_AXIS

__all__ = [
    "PIPE_AXIS", "GroupTransport", "Item", "Pipeline", "VirtualTransport",
    "check_schedule", "chunk_layers", "layer_generator", "layer_key",
    "pipeline_bubble_fraction", "schedule", "stage_body", "stage_layers",
]


class Item(NamedTuple):
    """One work item: ``stage`` runs chunk pass ``v`` on microbatch ``mb``
    at ``tick``."""

    tick: int
    stage: int
    v: int
    mb: int


def pipeline_bubble_fraction(pp: int, m: int, interleave: int = 1) -> float:
    """Idle wall-time share of the schedule: (P−1)/(V·M+P−1) (JAX's)."""
    m = m or pp
    v = int(interleave or 1)
    return (pp - 1) / (v * m + pp - 1)


def check_schedule(num_layers: int, pp: int, m: int, interleave: int = 1) -> None:
    """JAX's refusals of a schedule: V·P must divide the layers, and an
    interleaved schedule needs M ≥ P."""
    v = int(interleave or 1)
    if v > 1:
        if num_layers % (pp * v):
            raise ValueError(f"interleave={v}: pipe size {pp} × interleave must "
                             f"divide the {num_layers} stacked layers")
        if m < pp:
            raise ValueError(
                f"interleave={v} needs microbatches ({m}) >= pipe size ({pp}) — the "
                "wrap activation for pass v+1 would be needed before pass v produces it")
    elif num_layers % pp:
        raise ValueError(f"pipe size {pp} must divide the {num_layers} stacked layers")


def chunk_layers(num_layers: int, pp: int, interleave: int, stage: int, v: int) -> range:
    """The global layer indices of chunk ``v·P + stage``."""
    size = num_layers // (pp * interleave)
    chunk = v * pp + stage
    return range(chunk * size, (chunk + 1) * size)


def stage_layers(num_layers: int, pp: int, interleave: int, stage: int) -> List[int]:
    """Every layer stage ``stage`` holds (its V chunks)."""
    return [i for v in range(interleave)
            for i in chunk_layers(num_layers, pp, interleave, stage, v)]


def schedule(pp: int, m: int, interleave: int = 1) -> List[Item]:
    """The work items of every stage in tick order (stage order within a
    tick): chunk (v, p) on microbatch mb at tick v·M + mb + p."""
    items = [Item(v * m + mb + p, p, v, mb)
             for p in range(pp) for v in range(interleave) for mb in range(m)]
    return sorted(items)


def _producer(item: Item, pp: int) -> Optional[Item]:
    """The item whose output is ``item``'s input (None: the injected
    microbatch)."""
    if item.stage > 0:
        return item._replace(tick=item.tick - 1, stage=item.stage - 1)
    if item.v > 0:
        return Item(-1, pp - 1, item.v - 1, item.mb)
    return None


def _consumer(item: Item, pp: int, interleave: int) -> Optional[Item]:
    """The item that takes ``item``'s output (None: a final output)."""
    if item.stage < pp - 1:
        return item._replace(tick=item.tick + 1, stage=item.stage + 1)
    if item.v < interleave - 1:
        return Item(-1, 0, item.v + 1, item.mb)
    return None


def layer_key(generator: torch.Generator) -> int:
    """One draw of ``generator`` on the host: its state hashed (no device
    synchronisation), then the generator advanced by one draw on its
    device, as if the key had been drawn from it."""
    state = generator.get_state().numpy()
    words = np.frombuffer(state.tobytes() + b"\0" * (-state.nbytes % 4), np.uint32)
    key = int(np.random.SeedSequence(words.tolist()).generate_state(1, np.uint64)[0])
    torch.empty(1, device=generator.device).random_(generator=generator)
    return key


def layer_generator(key: int, layer: int, mb: int, device) -> torch.Generator:
    """The dropout generator of (global ``layer``, microbatch ``mb``)."""
    seed = np.random.SeedSequence((key, layer, mb)).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(seed >> np.uint64(1)))


def stage_body(blocks: Sequence[torch.nn.Module], layers: Sequence[int], x, mb: int,
               block_size: int = 0, deterministic: bool = True,
               key: Optional[int] = None, remat: bool = False):
    """One work item: ``blocks`` (global indices ``layers``) over microbatch
    ``mb``'s activations ``x``; with a ``key``, each block's dropout from its
    (layer, microbatch) generator; with ``remat``, each block that a backward
    runs through checkpointed."""
    for layer, block in zip(layers, blocks):
        gen = None if key is None else layer_generator(key, layer, mb, x.device)
        if remat and wants_remat(block, x):
            x = remat_block(block, x, block_size, deterministic, gen)
        else:
            x = block(x, block_size, deterministic, gen)
    return x


# ---------------------------------------------------------------------------
# the transports: where a stage's output goes


class VirtualTransport:
    """Every stage in this process: tensors handed over in memory."""

    def __init__(self, pp: int):
        self.stages = range(pp)
        self.mailbox: Dict[tuple, torch.Tensor] = {}

    def send(self, to: Item, t: torch.Tensor, direction: str) -> None:
        self.mailbox[(direction, to.stage, to.v, to.mb)] = t

    def recv(self, me: Item, frm: Item, like, direction: str):
        return self.mailbox.pop((direction, me.stage, me.v, me.mb))

    def flush(self) -> None:
        if self.mailbox:
            raise RuntimeError(f"undelivered pipeline messages: {sorted(self.mailbox)}")

    def share_output(self, y: Optional[torch.Tensor], like) -> torch.Tensor:
        return y

    def share_input_grad(self, g: Optional[torch.Tensor], like) -> Optional[torch.Tensor]:
        return g


def _empty(like) -> torch.Tensor:
    """A new tensor as ``like`` says: a tensor, or (shape, dtype, device)."""
    if isinstance(like, torch.Tensor):
        return torch.empty_like(like, memory_format=torch.contiguous_format)
    shape, dtype, device = like
    return torch.empty(shape, dtype=dtype, device=device)


class GroupTransport:
    """This rank's stage of the pipe ``group`` (``ranks``: the global rank
    of each stage): ``isend`` to the consumer's rank, ``irecv`` from the
    producer's, waited on where the value is needed; the sends are waited
    on at the end of the pass. Under gloo each message is tagged with the
    call, the direction and the receiving item (NCCL orders the messages
    of a pair of ranks itself)."""

    def __init__(self, stage: int, ranks: Sequence[int], group, call: int = 0):
        self.stages = (stage,)
        self.ranks = list(ranks)
        self.group = group
        self.tagged = dist.get_backend(group) == "gloo"
        self.call = call
        self.pending: List = []

    def _tag(self, item: Item, direction: str) -> int:
        if not self.tagged:
            return 0
        return ((self.call % 1024) * 2 + (direction == "b")) * 65536 + item.v * 4096 + item.mb

    def send(self, to: Item, t: torch.Tensor, direction: str) -> None:
        t = t.contiguous()
        self.pending.append((t, dist.isend(t, self.ranks[to.stage], self.group,
                                           self._tag(to, direction))))

    def recv(self, me: Item, frm: Item, like, direction: str):
        buf = _empty(like)
        dist.irecv(buf, self.ranks[frm.stage], self.group, self._tag(me, direction)).wait()
        return buf

    def flush(self) -> None:
        for _, req in self.pending:
            req.wait()
        self.pending = []

    def share_output(self, y: Optional[torch.Tensor], like) -> torch.Tensor:
        """The last stage's output on every rank of the group."""
        if y is None:
            y = _empty(like)
        dist.broadcast(y, self.ranks[-1], self.group)
        return y

    def share_input_grad(self, g: Optional[torch.Tensor], like) -> torch.Tensor:
        """The first stage's input cotangent on every rank of the group."""
        g = _empty(like) if g is None else g.contiguous()
        dist.broadcast(g, self.ranks[0], self.group)
        return g


# ---------------------------------------------------------------------------
# one pipelined call


class _Call:
    """One pipelined call over this process's stages: the items, their
    blocks and parameters, the transport; :meth:`forward` keeps each item's
    input and output when a backward will run."""

    def __init__(self, pipe: "Pipeline", blocks, x, block_size, deterministic, key,
                 remat, transport):
        self.pipe, self.blocks, self.transport = pipe, blocks, transport
        self.args = (block_size, deterministic, key, remat)
        self.items = [it for it in schedule(pipe.pp, pipe.m, pipe.v)
                      if it.stage in transport.stages]
        self.layers = {(it.stage, it.v): chunk_layers(pipe.num_layers, pipe.pp, pipe.v,
                                                      it.stage, it.v)
                       for it in self.items}
        self.params = {chunk: [p for i in layers for p in blocks[i].parameters()]
                       for chunk, layers in self.layers.items()}
        b = x.shape[0]
        if b % pipe.m:
            raise ValueError(f"per-group batch {b} not divisible by microbatches {pipe.m}")
        # (shape, dtype, device) of a microbatch's activations, of the
        # output, and of x (the receive buffers)
        dtype = blocks[self.layers[(self.items[0].stage, self.items[0].v)][0]].dtype
        rest = tuple(x.shape[1:])
        self.mb_like = ((b // pipe.m,) + rest, dtype, x.device)
        self.y_like = ((b,) + rest, dtype, x.device)
        self.x_like = (tuple(x.shape), x.dtype, x.device)
        self.kept: Dict[Item, tuple] = {}

    def all_params(self) -> List[torch.Tensor]:
        return [p for params in self.params.values() for p in params]

    def _run(self, item: Item, h):
        block_size, deterministic, key, remat = self.args
        chunk = self.layers[(item.stage, item.v)]
        with context.pipeline_stage():
            return stage_body([self.blocks[i] for i in chunk], chunk, h, item.mb,
                              block_size, deterministic, key, remat)

    def forward(self, x, grad: bool, x_needs_grad: bool = False):
        pipe, tr = self.pipe, self.transport
        mbs = x.reshape((pipe.m, -1) + tuple(x.shape[1:]))
        ys: List[Optional[torch.Tensor]] = [None] * pipe.m
        for item in self.items:
            src = _producer(item, pipe.pp)
            h = mbs[item.mb] if src is None else tr.recv(item, src, self.mb_like, "f")
            if grad:
                h = h.detach().requires_grad_(src is not None or x_needs_grad)
                with torch.enable_grad():
                    out = self._run(item, h)
                self.kept[item] = (h, out)
            else:
                out = self._run(item, h)
            dst = _consumer(item, pipe.pp, pipe.v)
            if dst is None:
                ys[item.mb] = out.detach()
            else:
                tr.send(dst, out.detach(), "f")
        tr.flush()
        y = torch.cat(ys) if ys[0] is not None else None
        return tr.share_output(y, self.y_like)

    def backward(self, gy, x_needs_grad: bool):
        pipe, tr = self.pipe, self.transport
        gys = gy.reshape((pipe.m, -1) + tuple(gy.shape[1:]))
        sums: Dict[int, torch.Tensor] = {}
        gx: List[Optional[torch.Tensor]] = [None] * pipe.m
        for item in reversed(self.items):
            h, out = self.kept.pop(item)
            dst = _consumer(item, pipe.pp, pipe.v)
            g = gys[item.mb] if dst is None else tr.recv(item, dst, out, "b")
            params = [p for p in self.params[(item.stage, item.v)] if p.requires_grad]
            wrt = ([h] if h.requires_grad else []) + params
            got = [None] * len(wrt)
            if wrt:
                with context.pipeline_stage():
                    got = torch.autograd.grad(out, wrt, g.to(out.dtype), allow_unused=True)
            if h.requires_grad:
                gh, got = got[0], got[1:]
                gh = torch.zeros_like(h) if gh is None else gh
                src = _producer(item, pipe.pp)
                if src is None:
                    gx[item.mb] = gh
                else:
                    tr.send(src, gh, "b")
            for p, gp in zip(params, got):
                if gp is not None:
                    sums[id(p)] = gp if id(p) not in sums else sums[id(p)] + gp
        tr.flush()
        out_gx = None
        if x_needs_grad:
            local = torch.cat(gx).to(self.x_like[1]) if gx[0] is not None else None
            out_gx = tr.share_input_grad(local, self.x_like)
        return out_gx, [sums.get(id(p)) for p in self.all_params()]


class _Pipelined(torch.autograd.Function):
    """A pipelined call with a backward: the stages' parameters are inputs,
    so that ``torch.autograd.grad`` of the step reaches them."""

    @staticmethod
    def forward(ctx, x, call, *params):
        ctx.call = call
        ctx.x_needs_grad = ctx.needs_input_grad[0]
        return call.forward(x, grad=True, x_needs_grad=ctx.x_needs_grad)

    @staticmethod
    def backward(ctx, gy):
        call, ctx.call = ctx.call, None
        gx, grads = call.backward(gy, ctx.x_needs_grad)
        return (gx, None, *grads)


class Pipeline:
    """The schedule of one model's encoder stack: ``pp`` stages, ``m``
    microbatches (0: pp), ``interleave`` chunks a stage. With a ``group``
    (and ``ranks``, the global rank of each stage), this process runs stage
    ``stage`` of a real pipe group; without one, every stage virtually.

    A model whose blocks carry a :class:`Pipeline` (``module._pipeline``,
    :mod:`.integrate`) routes its encoder through :meth:`__call__`. A deep
    copy of a model drops it (the copy runs its own blocks in order)."""

    def __init__(self, num_layers: int, pp: int, m: int = 0, interleave: int = 1,
                 stage: Optional[int] = None, group=None,
                 ranks: Optional[Sequence[int]] = None):
        self.num_layers, self.pp = int(num_layers), int(pp)
        self.m = int(m or pp)
        self.v = int(interleave or 1)
        check_schedule(self.num_layers, self.pp, self.m, self.v)
        self.stage, self.group = stage, group
        self.ranks = list(ranks) if ranks is not None else None
        self.calls = 0

    def __deepcopy__(self, memo):
        return None

    @property
    def virtual(self) -> bool:
        return self.group is None

    def owned(self) -> List[int]:
        """The layers this process holds: all on virtual stages."""
        if self.virtual:
            return list(range(self.num_layers))
        return stage_layers(self.num_layers, self.pp, self.v, self.stage)

    def transport(self):
        self.calls += 1
        if self.virtual:
            return VirtualTransport(self.pp)
        return GroupTransport(self.stage, self.ranks, self.group, self.calls)

    def __call__(self, blocks, x, block_size: int = 0, deterministic: bool = True,
                 generator: Optional[torch.Generator] = None, remat: bool = False):
        """The stack ``blocks`` (indexable by global layer: the model's
        ``encoder_blocks``) over ``x``, pipelined; dropout from one draw of
        ``generator`` when it is given and the blocks drop."""
        key = None
        if not deterministic and generator is not None and _drops(blocks, self.owned()):
            key = layer_key(generator)
        call = _Call(self, blocks, x, block_size, deterministic, key, remat,
                     self.transport())
        params = call.all_params()
        if torch.is_grad_enabled() and (x.requires_grad
                                        or any(p.requires_grad for p in params)):
            return _Pipelined.apply(x, call, *params)
        with torch.no_grad():
            return call.forward(x, grad=False)


def _drops(blocks, layers) -> bool:
    """Whether the blocks draw dropout masks (a rate above 0)."""
    block = blocks[layers[0]]
    return any(getattr(m, "rate", 0.0) > 0.0 for m in block.modules())
