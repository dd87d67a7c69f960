"""Tensor parallelism (``parallel.tp``, the ``model`` axis) and expert
parallelism (``parallel.ep``, the ``expert`` axis), Megatron-style on plain
local tensors.

JAX places each parameter by the rule table (``vit_ssl_tpu/parallel/
sharding_rules.py``) and lets GSPMD insert the collectives. Here each rank
keeps its contiguous shard of every parameter the table shards
(:mod:`.sharding_rules`), and each sharded layer runs a **per-rank body**
on its shard between two collectives (:func:`run`):

- ``copy_to``: the replicated input, identity forward, all-reduce of its
  cotangent backward (each rank's body sees only its slice's share);
- ``reduce_from``: the bodies' partial outputs all-reduced forward,
  identity backward (a row-parallel product; its bias added once, after);
- ``gather_from(dim)``: the bodies' outputs all-gathered along ``dim``
  forward, the rank's own slice of the cotangent backward (every rank
  computes the same loss from the gathered tensor, so a reduce-scatter
  would count it tp times).

Everything outside the bodies (LayerNorms, residuals, the router, the
losses) runs whole and the same on every rank of one data index, so a
replicated parameter takes the same gradient on each; the data-axis
all-reduce (:mod:`.data_parallel`) is unchanged. The kernels (B1, B3, B2,
B4) see each rank's shard as contiguous local tensors: the local head count
and width, the local hidden width.

A body is one function for three drivers: the unsharded module (one rank
of one, the full parameters), real ranks (the local shards and the
collectives above over the axis's process group), and virtual ranks in
one process (:func:`virtual_shards`: the full parameters, each rank's
slice cut in turn, the collectives a sum or a concatenation), as the ring
does for ``parallel.sp`` (:mod:`.ring_attention`). The card checks the
bodies at tp and ep > 1 on virtual ranks (``chip_smoke.py``), since one
card holds one rank.

:class:`TensorParallelState` shards a train state's modules in place
(after :func:`..mesh.broadcast_module`), cuts the optimizer's buffers to
the local shards (JAX's ``shard_tree_tp``), gathers whole tensors in the
reference ``.pth`` layout for a checkpoint (:meth:`~TensorParallelState.host_state_dict`)
and slices them again on a load, so a run resumes at another tp or ep.
"""

from __future__ import annotations

import contextlib
import copy
import logging
from typing import Dict, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .mesh import EXPERT_AXIS, MODEL_AXIS
from .sharding_rules import Spec, sharded_dims, spec_table

logger = logging.getLogger(__name__)

AXES = (MODEL_AXIS, EXPERT_AXIS)


# ---------------------------------------------------------------------------
# the collectives


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        n = dist.get_world_size(group)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        ctx.args = (dim, dist.get_rank(group), x.shape[dim])
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        dim, rank, size = ctx.args
        return grad.narrow(dim, rank * size, size), None, None


def copy_to(x, group):
    """Identity forward; the cotangent all-reduced over ``group`` backward."""
    return _CopyTo.apply(x, group)


def reduce_from(x, group):
    """``x`` all-reduced (summed) over ``group``; identity backward."""
    return _ReduceFrom.apply(x, group)


def gather_from(x, dim: int, group):
    """The group's ``x`` concatenated along ``dim`` in rank order; backward
    the rank's own slice of the cotangent."""
    return _GatherFrom.apply(x, dim % x.dim(), group)


# ---------------------------------------------------------------------------
# one axis as a layer sees it, and the drivers of a per-rank body


class Axis:
    """A sharded axis of a layer: its ``name``, ``size``, this rank's index
    ``rank`` and the process ``group`` its collectives run over; a None
    group means virtual ranks (every rank's body in this process)."""

    def __init__(self, name: str, size: int, rank: int = 0, group=None):
        self.name, self.size, self.rank, self.group = name, int(size), int(rank), group

    @property
    def virtual(self) -> bool:
        return self.group is None


def axis_of(module: nn.Module, name: str = MODEL_AXIS) -> Optional[Axis]:
    """The axis ``name`` over which ``module``'s parameters are sharded, or
    None (whole)."""
    return getattr(module, "_tp_axes", {}).get(name)


def shard(t: torch.Tensor, dim: Optional[int], rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous slice of ``t`` along ``dim`` of ``size``
    equal slices (``t`` itself for a None ``dim``)."""
    if dim is None:
        return t
    n = t.shape[dim] // size
    return t.narrow(dim, rank * n, n).contiguous()


def run(axis: Optional[Axis], body, inputs: Sequence[torch.Tensor],
        params: Sequence[torch.Tensor], dims: Sequence[Optional[int]],
        combine: str = "sum"):
    """``body(*inputs, *params, rank, size)`` over ``axis``: the bodies'
    outputs summed (``combine="sum"``, a row-parallel product) or
    concatenated along the last dim (``"cat"``). ``inputs`` are replicated
    tensors that every rank's body reads whole; ``params`` are the
    module's parameters, sharded along ``dims`` (None: whole).

    Without an axis: one body on the full parameters. Real ranks: the
    local shards, ``copy_to`` on each input, ``reduce_from`` or
    ``gather_from`` on the output. Virtual ranks: each rank's slice of the
    full parameters in turn, the outputs summed in rank order or
    concatenated."""
    if axis is None:
        return body(*inputs, *params, 0, 1)
    if axis.virtual:
        outs = [body(*inputs, *(shard(p, d, r, axis.size) for p, d in zip(params, dims)),
                     r, axis.size) for r in range(axis.size)]
        if combine == "cat":
            return torch.cat(outs, -1)
        total = outs[0]
        for out in outs[1:]:
            total = total + out
        return total
    out = body(*(copy_to(x, axis.group) for x in inputs), *params, axis.rank, axis.size)
    if combine == "cat":
        return gather_from(out, -1, axis.group)
    return reduce_from(out, axis.group)


def linear_body(x, weight, bias, rank: int, size: int):
    """A column-parallel ``nn.Linear``'s body: ``x`` through this rank's
    output rows, in ``x``'s dtype."""
    return F.linear(x, weight.to(x.dtype), bias.to(x.dtype))


def whole(axis: Optional[Axis], p: torch.Tensor) -> torch.Tensor:
    """The whole of a vector parameter that a layer uses unsharded but
    stores sharded (JAX's rule shards the classification head's LayerNorm
    bias): all-gathered on real ranks, as it is otherwise."""
    if axis is None or axis.virtual:
        return p
    return gather_from(p, 0, axis.group)


# ---------------------------------------------------------------------------
# sharding modules


def plan(module: nn.Module, sizes: Mapping[str, int]) -> Dict[str, Spec]:
    """The fitted spec of each of ``module``'s parameters that shards over
    the model or expert axis of ``sizes`` (by ``named_parameters`` name)."""
    sizes = {a: int(s) for a, s in sizes.items() if a in AXES}
    heads = {prefix: int(m.num_heads) for prefix, m in module.named_modules()
             if hasattr(m, "w_query") and hasattr(m, "num_heads")}
    shapes = {name: tuple(p.shape) for name, p in module.named_parameters()}
    specs = {name: spec for name, spec in spec_table(shapes, sizes, heads).items()
             if any(spec)}
    if any("encoder_scan" in name.split(".") for name in specs):
        raise ValueError("model.scan_layers cannot be combined with parallel.tp: the "
                         "tensor-parallel rules are written for the unrolled blocks")
    return specs


def _mark(module: nn.Module, specs: Mapping[str, Spec], axes: Mapping[str, Axis]) -> None:
    """Each parameter's owning module takes the axes its spec names."""
    for name, spec in specs.items():
        owner = module.get_submodule(name.rsplit(".", 1)[0]) if "." in name else module
        marks = dict(getattr(owner, "_tp_axes", {}))
        marks.update({axis: axes[axis] for _, axis in sharded_dims(spec)})
        owner._tp_axes = marks


def _unmark(module: nn.Module) -> None:
    for m in module.modules():
        if "_tp_axes" in vars(m):
            del m._tp_axes


@contextlib.contextmanager
def virtual_shards(module: nn.Module, sizes: Mapping[str, int]):
    """Inside, ``module``'s layers run their per-rank bodies over virtual
    ranks of ``sizes`` (e.g. ``{"model": 2}``) in this process: the full
    parameters, each rank's slice in turn, the collectives sums and
    concatenations. Yields the plan (:func:`plan`)."""
    specs = plan(module, sizes)
    _mark(module, specs, {a: Axis(a, s) for a, s in sizes.items() if a in AXES})
    try:
        yield specs
    finally:
        _unmark(module)


def local_slice(t: torch.Tensor, spec: Spec, coords: Mapping[str, int],
                sizes: Mapping[str, int]) -> torch.Tensor:
    """This rank's contiguous shard of the whole tensor ``t`` under ``spec``."""
    for dim, axis in sharded_dims(spec):
        t = shard(t, dim, coords[axis], sizes[axis])
    return t.contiguous()


def gather_whole(t: torch.Tensor, spec: Spec, groups: Mapping[str, object]) -> torch.Tensor:
    """The whole tensor of the shards ``t`` of every rank (no autograd)."""
    for dim, axis in sharded_dims(spec):
        group = groups[axis]
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        t = torch.cat(parts, dim)
    return t


@torch.no_grad()
def shard_module(module: nn.Module, mesh) -> Dict[str, Spec]:
    """Shard ``module`` in place over ``mesh``'s model and expert axes (real
    ranks): each sharded parameter keeps this rank's contiguous slice (the
    same ``Parameter`` object), its owning layer runs its per-rank body
    over the axis's group. Returns the plan."""
    sizes = dict(mesh.shape)
    specs = plan(module, sizes)
    params = dict(module.named_parameters())
    for name, spec in specs.items():
        params[name].data = local_slice(params[name].data, spec, mesh.coords, sizes)
    axes = {a: Axis(a, sizes[a], mesh.coords[a], mesh.groups[a])
            for a in AXES if a in sizes}
    _mark(module, specs, axes)
    return specs


class TensorParallelState:
    """The train state's ``modules`` (attribute name → module: ``student``,
    ``teacher``, ``model``) sharded over the mesh's model and expert axes,
    and the optimizer's buffers (one a ``trained`` parameter) cut to their
    parameters' shards."""

    def __init__(self, modules: Mapping[str, nn.Module], opt_state, trained, mesh):
        self.sizes = dict(mesh.shape)
        self.coords = dict(mesh.coords)
        self.groups = {a: mesh.groups[a] for a in AXES if a in self.sizes}
        self.modules = dict(modules)
        self.specs = {attr: shard_module(m, mesh) for attr, m in self.modules.items()}
        self._by_id = {id(p): self.specs[attr][name] for attr, m in self.modules.items()
                       for name, p in m.named_parameters() if name in self.specs[attr]}
        with torch.no_grad():
            for name, bufs in opt_state.buffers.items():
                opt_state.buffers[name] = self._buffers(bufs, trained, self._local)
        logger.info("tensor/expert parallel over %s: %d parameters sharded",
                    {a: self.sizes[a] for a in self.groups},
                    sum(len(s) for s in self.specs.values()))

    def _local(self, t, spec):
        return local_slice(t, spec, self.coords, self.sizes)

    def _whole(self, t, spec):
        return gather_whole(t, spec, self.groups)

    def _buffers(self, bufs, trained, fn):
        """The optimizer buffers (one a ``trained`` parameter) through
        ``fn(buffer, spec)`` where their parameter is sharded."""
        return [b if id(p) not in self._by_id else fn(b, self._by_id[id(p)])
                for p, b in zip(trained, bufs)]

    def _tree(self, tree: dict, trained, fn) -> dict:
        """A state tree with every sharded tensor through ``fn(t, spec)``."""
        tree = dict(tree)
        for attr, specs in self.specs.items():
            tree[attr] = {k: fn(v, specs[k]) if k in specs else v
                          for k, v in tree[attr].items()}
        tree["opt_state"] = {k: v if k == "count" else self._buffers(v, trained, fn)
                             for k, v in tree["opt_state"].items()}
        return tree

    def host_state_dict(self, state, trained, keep: bool = True):
        """``state.state_dict()`` with whole tensors (the reference layout),
        copied to host memory; every rank gathers, only ``keep`` ranks copy
        (the others get None)."""
        from ..train.trainers.base import to_host

        tree = self._tree(state.state_dict(), trained, self._whole)
        return to_host(tree) if keep else None

    @torch.no_grad()
    def load_state_dict(self, state, tree, trained) -> None:
        """A whole-tensor tree (:meth:`host_state_dict`'s, of any tp or ep)
        into the sharded state: each sharded tensor's local slice."""
        state.load_state_dict(self._tree(tree, trained, self._local))

    @torch.no_grad()
    def unsharded(self, module: nn.Module, keep: bool = True):
        """An unsharded copy of one of the sharded modules, built from the
        gathered parameters: every rank gathers, only ``keep`` ranks build
        it (the others get None)."""
        attr, = (a for a, m in self.modules.items() if m is module)
        params = dict(module.named_parameters())
        full = {name: self._whole(params[name].data, spec)
                for name, spec in self.specs[attr].items()}
        if not keep:
            return None
        marks = {m: m._tp_axes for m in module.modules() if "_tp_axes" in vars(m)}
        _unmark(module)  # the marks hold process groups, which do not copy
        try:
            clone = copy.deepcopy(module)
        finally:
            for m, axes in marks.items():
                m._tp_axes = axes
        for name, p in clone.named_parameters():
            if name in full:
                p.data = full[name]
        return clone


__all__ = [
    "Axis", "TensorParallelState", "axis_of", "copy_to", "gather_from", "gather_whole",
    "linear_body", "local_slice", "plan", "reduce_from", "run", "shard", "shard_module",
    "virtual_shards", "whole",
]
