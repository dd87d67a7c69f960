"""Parameter, optimizer-state and teacher sharding over the ``data`` axis
(after ``vit_ssl_tpu/parallel/fsdp.py``), written out as ZeRO-3.

JAX shards each large leaf along its largest divisible dimension and lets
XLA gather it where it is used. Here :class:`ShardedState` keeps, on each
data rank, only its chunk of every large parameter (the student's or the
model's, and DINO's teacher) and of its optimizer buffers (AdamW's moments);
a large leaf is one :func:`fsdp_dim_for` names a dimension for (JAX's
``fsdp_spec_for``: at least ``min_size`` 2^15 elements, the largest
dimension the data axis divides). At rest the full parameters hold no
memory (their storage is resized to 0); :meth:`ShardedState.materialized`
all-gathers them for a step, an evaluation or a checkpoint and frees them
after:

- a step: the parameters gathered (one flat ``all_gather_into_tensor``),
  forward and backward on them; the gradients of the sharded parameters
  reduce-scattered (one flat ``reduce_scatter_tensor``, summed) into their
  chunks, the others all-reduced (one flat bucket); the optimizer updates
  the chunks and their buffers (:class:`..data_parallel.DataParallelOptimizer`);
  the teacher's EMA runs chunk to chunk (:func:`local_tensors`); the full
  parameters freed;
- a checkpoint holds full tensors (parameters and buffers gathered, rank 0
  writes), so a run resumes at another world size; :meth:`load_state_dict`
  takes such a tree at any world size.

The hand-written kernels take raw pointers; they only ever see the full
parameters gathered here, never a chunk (each kernel's wrapper also
refuses a ``DTensor`` by name). At dp = 1 in a process group the chunks are
whole and the collectives run over one rank, so that one card runs this
path. ``parallel.fsdp`` with tp > 1 or ep > 1 stays refused by the config
check (``config/schemas.py``).
"""

from __future__ import annotations

import contextlib
import logging
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# leaves smaller than this stay replicated (bytes are negligible; the
# gather's latency is not)
DEFAULT_MIN_SIZE = 2 ** 15


def fsdp_dim_for(shape, n: int, min_size: int = DEFAULT_MIN_SIZE) -> Optional[int]:
    """The dimension to shard a leaf of ``shape`` along over ``n`` ranks, or
    None (replicated): JAX's ``fsdp_spec_for`` rule, the largest dimension
    ``n`` divides (the last of equal ones), leaves under ``min_size``
    elements replicated; at ``n`` = 1 a large leaf is one whole chunk."""
    size = 1
    for s in shape:
        size *= int(s)
    if not shape or size < min_size:
        return None
    candidates = [(int(s), i) for i, s in enumerate(shape) if int(s) % n == 0]
    if not candidates:
        return None
    return max(candidates)[1]


def local_tensors(module: torch.nn.Module) -> List[torch.Tensor]:
    """The tensors that hold ``module``'s parameters between steps: their
    chunks under :class:`ShardedState`, the parameters themselves
    otherwise (in ``parameters()`` order)."""
    sharded = getattr(module, "_fsdp", None)
    params = list(module.parameters())
    return params if sharded is None else [sharded.local(p) for p in params]


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


class ShardedState:
    """The large leaves of a train state sharded over ``group`` (the data
    axis): the parameters of ``modules`` and the optimizer buffers of
    ``opt_state`` (one tensor a trained parameter, ``trained`` in the
    optimizer's order)."""

    def __init__(self, modules: Sequence[torch.nn.Module], opt_state, trained,
                 group, min_size: int = DEFAULT_MIN_SIZE):
        self.group = group
        self.n = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.modules = list(modules)
        self.params: List[torch.nn.Parameter] = []
        seen = set()
        for m in self.modules:
            for p in m.parameters():
                if id(p) not in seen:
                    seen.add(id(p))
                    self.params.append(p)
        self.dims: Dict[int, int] = {}
        self.shards: Dict[int, torch.Tensor] = {}
        with torch.no_grad():
            for p in self.params:
                dim = fsdp_dim_for(p.shape, self.n, min_size)
                if dim is None:
                    continue
                if p.storage_offset() or not p.is_contiguous() or \
                        p.untyped_storage().nbytes() != p.numel() * p.element_size():
                    raise ValueError("fsdp shards parameters that own their storage "
                                     f"whole; one of shape {tuple(p.shape)} does not")
                self.dims[id(p)] = dim
                self.shards[id(p)] = self._chunk(p, dim).clone(
                    memory_format=torch.contiguous_format)
            self.sharded = [p for p in self.params if id(p) in self.dims]
            for name, bufs in opt_state.buffers.items():
                opt_state.buffers[name] = [
                    self._chunk(b, self.dims[id(p)]).clone(
                        memory_format=torch.contiguous_format)
                    if id(p) in self.dims else b for p, b in zip(trained, bufs)]
        for m in self.modules:
            m._fsdp = self
        self._depth = 0
        self.release()
        logger.info("fsdp over %d data ranks: %s", self.n, self.bytes_at_rest())

    # -- chunks ---------------------------------------------------------------
    def _chunk(self, x, dim: int, rank: Optional[int] = None):
        size = x.shape[dim] // self.n
        return x.narrow(dim, (self.rank if rank is None else rank) * size, size)

    def local(self, p) -> torch.Tensor:
        """``p``'s chunk when it is sharded, else ``p``."""
        return self.shards.get(id(p), p)

    def bytes_at_rest(self) -> Dict[str, int]:
        """Per rank, of the parameters of ``modules``: the full bytes of the
        sharded ones, the bytes of their chunks this rank keeps, the bytes of
        the replicated ones."""
        full = sum(p.numel() * p.element_size() for p in self.sharded)
        return {"sharded_full_bytes": full,
                "sharded_local_bytes": sum(s.numel() * s.element_size()
                                           for s in self.shards.values()),
                "replicated_bytes": sum(p.numel() * p.element_size()
                                        for p in self.params if id(p) not in self.dims)}

    # -- gather and release ------------------------------------------------------
    @torch.no_grad()
    def _gather_into(self, targets: Sequence[torch.Tensor], chunks: Sequence[torch.Tensor],
                     dims: Sequence[int]) -> None:
        """Every rank's ``chunks`` (one flat all-gather) into the full
        ``targets``, each along its dim."""
        if not targets:
            return
        flat = _flat(chunks)
        out = torch.empty(self.n * flat.numel(), device=flat.device, dtype=flat.dtype)
        dist.all_gather_into_tensor(out, flat, group=self.group)
        out = out.view(self.n, -1)
        offset = 0
        for t, c, dim in zip(targets, chunks, dims):
            for r in range(self.n):
                self._chunk(t, dim, r).copy_(
                    out[r, offset:offset + c.numel()].view(c.shape))
            offset += c.numel()

    def gather(self) -> None:
        """The full parameters back in place (their storage allocated again
        and every rank's chunk gathered into it)."""
        self._depth += 1
        if self._depth > 1:
            return
        for p in self.sharded:
            p.untyped_storage().resize_(p.numel() * p.element_size())
        self._gather_into(self.sharded, [self.shards[id(p)] for p in self.sharded],
                          [self.dims[id(p)] for p in self.sharded])

    def release(self) -> None:
        """The full parameters' memory freed (the chunks hold the state)."""
        self._depth = max(0, self._depth - 1)
        if self._depth:
            return
        for p in self.sharded:
            p.untyped_storage().resize_(0)

    @contextlib.contextmanager
    def materialized(self):
        """The full parameters inside (gathered on entry, freed on exit);
        nests."""
        self.gather()
        try:
            yield
        finally:
            self.release()

    def unsharded(self, module: torch.nn.Module, keep: bool = True):
        """``module`` itself, whole inside :meth:`materialized` (None for
        ranks without ``keep``), as :meth:`..tensor_parallel.TensorParallelState.unsharded`
        gives a tensor-parallel module."""
        return module if keep else None

    def around(self, step):
        """``step`` run with the full parameters."""
        def wrapped(*args, **kwargs):
            with self.materialized():
                return step(*args, **kwargs)

        wrapped.__wrapped__ = step
        return wrapped

    # -- gradients -----------------------------------------------------------------
    @torch.no_grad()
    def reduce(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor]):
        """(tensors to update, their gradients): for a sharded parameter its
        chunk and the sum over the data ranks of its gradient's chunk (one
        flat reduce-scatter); for the others the parameter and its gradient
        summed (one flat all-reduce)."""
        from .data_parallel import all_reduce_flat

        sharded = [i for i, p in enumerate(params) if id(p) in self.dims]
        rest = [i for i, p in enumerate(params) if id(p) not in self.dims]
        out: List[Optional[torch.Tensor]] = [None] * len(params)
        if sharded:
            pieces = [self._chunk(grads[i], self.dims[id(params[i])], r).reshape(-1)
                      for r in range(self.n) for i in sharded]
            flat = torch.cat(pieces)
            local = torch.empty(flat.numel() // self.n, device=flat.device,
                                dtype=flat.dtype)
            dist.reduce_scatter_tensor(local, flat, group=self.group)
            offset = 0
            for i in sharded:
                shard = self.shards[id(params[i])]
                out[i] = local[offset:offset + shard.numel()].view(shard.shape)
                offset += shard.numel()
        for i, g in zip(rest, all_reduce_flat([grads[i] for i in rest], self.group)):
            out[i] = g
        return [self.local(p) for p in params], out

    # -- checkpoints ------------------------------------------------------------------
    def _full_buffers(self, buffers: Dict[str, list], trained) -> Dict[str, list]:
        """The optimizer buffers with every sharded one gathered whole."""
        out = {}
        for name, bufs in buffers.items():
            full = list(bufs)
            idx = [i for i, p in enumerate(trained) if id(p) in self.dims]
            targets = [torch.empty(trained[i].shape, device=bufs[i].device,
                                   dtype=bufs[i].dtype) for i in idx]
            self._gather_into(targets, [bufs[i] for i in idx],
                              [self.dims[id(trained[i])] for i in idx])
            for i, t in zip(idx, targets):
                full[i] = t
            out[name] = full
        return out

    def host_state_dict(self, state, trained, keep: bool = True):
        """``state.state_dict()`` with full tensors, copied to host memory
        (every rank gathers; only ``keep`` ranks copy: the others get
        None)."""
        from ..train.trainers.base import to_host

        with self.materialized():
            tree = state.state_dict()
            tree["opt_state"] = {"count": tree["opt_state"]["count"],
                                 **self._full_buffers(state.opt_state.buffers, trained)}
            return to_host(tree) if keep else None

    @torch.no_grad()
    def load_state_dict(self, state, tree, trained) -> None:
        """A full-tensor :meth:`host_state_dict` (of any world size) into the
        sharded state: the buffers' chunks, and the parameters' chunks taken
        from the full tensors loaded in place."""
        tree = dict(tree)
        opt = dict(tree["opt_state"])
        for name in opt:
            if name == "count":
                continue
            opt[name] = [self._chunk(b, self.dims[id(p)]).contiguous()
                         if id(p) in self.dims else b for p, b in zip(trained, opt[name])]
        tree["opt_state"] = opt
        self._depth += 1
        try:
            if self._depth == 1:
                for p in self.sharded:
                    p.untyped_storage().resize_(p.numel() * p.element_size())
            state.load_state_dict(tree)
            for p in self.sharded:
                self.shards[id(p)].copy_(self._chunk(p, self.dims[id(p)]))
        finally:
            self.release()
