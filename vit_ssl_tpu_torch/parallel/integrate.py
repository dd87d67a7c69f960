"""Pipeline-parallel models and train states (``parallel.pp``; after
``vit_ssl_tpu/parallel/integrate.py``).

Every model's forward is ``embed → encoder blocks → finish`` (the ViT and
DINO's backbone: ``embed``, ``encode``, the head; SimMIM: ``embed_masked``,
``encode``, ``predict``). A model whose block owner (the ViT, the SimMIM
ViT, DINO's backbone: :func:`blocks_owner`) carries a
:class:`~.pipeline.Pipeline` as ``_pipeline`` runs ``encode`` through it;
the embedding and the head run whole on every rank of the pipe group, as
in JAX, so the steps' code does not change. DINO's packed locals go through
the stages too, with their block size (B1's block-diagonal mask inside each
stage): JAX runs them unpipelined on every pipe device, which a port rank
cannot, since it holds only its own stage's blocks. The teacher's globals
run the same schedule without a graph. Remat checkpoints each block inside
the stages (``ops/encoder_block.py::remat_block``).

:func:`virtual_pipeline` runs every stage in this process on the full
model (the card's check, and the tests'). :class:`PipelineState` splits a
train state over the pipe axis of a mesh (the trainer's, before it builds
its steps, as JAX's ``base.py`` wraps its model):

- each rank keeps the embedding, the head or decoder and its own blocks
  (the others' places in ``encoder_blocks`` hold an :class:`AbsentBlock`,
  so the state-dict names keep their global layer index); its optimizer
  holds those only (the trainable mask and the buffers narrowed alike);
- a replicated parameter takes the same gradient on every pipe rank,
  equal to one process's: the stages' backward broadcasts the first
  stage's input cotangent, so the embedding's gradient is whole on every
  rank, and the head computes the same gradient everywhere from the same
  output. DINO's center and statistics reduce over the data ranks only;
- checkpoints hold whole tensors in the reference ``.pth`` layout, each
  block broadcast from its stage (:meth:`PipelineState.host_state_dict`);
  a load keeps this rank's blocks (:meth:`PipelineState.load_state_dict`),
  so a run resumes at any pp, in one process too;
- rank 0 evaluates an unsharded copy (:meth:`PipelineState.unsharded`);
- tensor and expert parallelism shard each stage's modules as they shard a
  whole model (the model group's ranks share a stage), and fsdp shards
  them over the data group (:class:`.fsdp.ShardedState`): ``inner``.

The trainable mask and the blocks: a block this rank does not hold is
trained where this rank's first block is (the masks freeze or train every
encoder block alike).
"""

from __future__ import annotations

import contextlib
import copy
import logging
import re
from typing import Dict, List, Mapping, Optional

import torch
import torch.distributed as dist
from torch import nn

from . import context
from .mesh import PIPE_AXIS, SEQ_AXIS
from .pipeline import Pipeline, pipeline_bubble_fraction, stage_layers

logger = logging.getLogger(__name__)

__all__ = ["AbsentBlock", "PipelineState", "blocks_owner", "pipeline_settings",
           "refuse_layout", "virtual_pipeline"]


def blocks_owner(module: nn.Module) -> nn.Module:
    """The module that holds ``encoder_blocks`` (DINO's backbone, or the
    model itself)."""
    return getattr(module, "backbone", module)


def _prefix(module: nn.Module) -> str:
    return "backbone.encoder_blocks." if blocks_owner(module) is not module \
        else "encoder_blocks."


def pipeline_settings(config):
    """(pp, microbatches, interleave) of ``parallel.*``."""
    par = config.get("parallel", {}) or {}
    return (max(1, int(par.get("pp", 1) or 1)), int(par.get("pp_microbatches", 0) or 0),
            int(par.get("pp_interleave", 1) or 1))


def refuse_layout(num_blocks: int, pp: int, m: int, interleave: int) -> None:
    """JAX's ``PipelinedModel`` refusals, with its messages."""
    if num_blocks % (pp * interleave):
        raise ValueError(
            f"parallel.pp={pp} × parallel.pp_interleave={interleave} must divide "
            f"model.num_blocks={num_blocks} (each device owns pp_interleave equal "
            "chunks of encoder blocks)")
    if interleave > 1 and (m or pp) < pp:
        raise ValueError(f"parallel.pp_interleave={interleave} needs pp_microbatches "
                         f">= pp ({pp})")


def _log_layout(num_blocks: int, pp: int, m: int, interleave: int) -> None:
    logger.info(
        "Pipeline parallelism: %d stages x %d blocks/stage%s, microbatches=%s, "
        "bubble fraction=%.3f", pp, num_blocks // pp,
        f" (interleave {interleave}: {interleave} virtual chunks of "
        f"{num_blocks // (pp * interleave)} blocks per device)" if interleave > 1 else "",
        m or pp, pipeline_bubble_fraction(pp, m, interleave))


class AbsentBlock(nn.Module):
    """The place of a block that another pipeline stage holds."""

    def __init__(self, layer: int, stage: int):
        super().__init__()
        self.layer, self.stage = layer, stage

    def forward(self, *args, **kwargs):
        raise RuntimeError(
            f"encoder block {self.layer} lives on pipeline stage {self.stage}: this "
            "call runs outside the pipeline (evaluate an unsharded copy, "
            "PipelineState.unsharded)")


@contextlib.contextmanager
def virtual_pipeline(module: nn.Module, pp: int, m: int = 0, interleave: int = 1):
    """Inside, ``module`` runs its encoder over ``pp`` virtual stages in this
    process (``m`` microbatches, ``interleave`` chunks a stage), every block
    its own. Yields the :class:`~.pipeline.Pipeline`."""
    owner = blocks_owner(module)
    refuse_layout(len(owner.encoder_blocks), pp, m, interleave)
    pipe = Pipeline(len(owner.encoder_blocks), pp, m, interleave)
    owner._pipeline = pipe
    try:
        yield pipe
    finally:
        owner.__dict__.pop("_pipeline", None)


def _deepcopy_unmarked(module: nn.Module) -> nn.Module:
    """A deep copy of ``module`` without the markers that hold process
    groups (fsdp's; a pipeline copies to None itself)."""
    memo = {id(m.__dict__["_fsdp"]): None for m in module.modules() if "_fsdp" in vars(m)}
    return copy.deepcopy(module, memo)


class PipelineState:
    """The train state's ``modules`` (attribute name → module: ``student``,
    ``teacher``, ``model``) split over the mesh's pipe axis: the blocks of
    other stages dropped, the optimizer's mask and buffers narrowed to what
    this rank keeps. ``mesh`` is the published one (its pipe axis this
    rank's stage and group). ``inner`` (set after) is the tensor-parallel
    or fsdp state of the kept modules, or None."""

    def __init__(self, modules: Mapping[str, nn.Module], state, optimizer, mesh, config):
        pp, m, v = pipeline_settings(config)
        self.modules = dict(modules)
        self.train_attr = "student" if "student" in self.modules else "model"
        first = next(iter(self.modules.values()))
        self.num_layers = len(blocks_owner(first).encoder_blocks)
        refuse_layout(self.num_layers, pp, m, v)
        self.stage, self.group = context.pipe_rank(), context.pipe_group()
        self.ranks = [mesh.rank_at(**{PIPE_AXIS: s}) for s in range(pp)]
        self.device = next(first.parameters()).device
        self.owned = stage_layers(self.num_layers, pp, v, self.stage)
        self.stage_of = {i: s for s in range(pp)
                         for i in stage_layers(self.num_layers, pp, v, s)}
        self.prefix = {attr: _prefix(mod) for attr, mod in self.modules.items()}
        self.full_keys = {attr: list(mod.state_dict()) for attr, mod in self.modules.items()}
        # the whole training module's parameter names, in its order
        self.train_names = [n for n, _ in self.modules[self.train_attr].named_parameters()]
        self.inner = None
        params_before = list(state.params)
        trained_before = optimizer.select(params_before)
        for mod in self.modules.values():
            owner = blocks_owner(mod)
            for i in range(self.num_layers):
                if i not in self.owned:
                    owner.encoder_blocks[i] = AbsentBlock(i, self.stage_of[i])
            owner._pipeline = Pipeline(self.num_layers, pp, m, v, self.stage, self.group,
                                       self.ranks)
        kept = {id(p) for p in state.params}
        with torch.no_grad():
            for name, bufs in state.opt_state.buffers.items():
                state.opt_state.buffers[name] = [b for p, b in zip(trained_before, bufs)
                                                 if id(p) in kept]
        base = optimizer
        while getattr(base, "inner", None) is not None:
            base = base.inner
        if base.trainable is not None:
            base.trainable = [t for p, t in zip(params_before, base.trainable)
                              if id(p) in kept]
        _log_layout(self.num_layers, pp, m, v)
        if int(mesh.shape.get(SEQ_AXIS, 1)) > 1:
            logger.warning(
                "parallel.pp combined with parallel.sp: ring attention cannot run "
                "inside pipeline stages; the 'seq' axis devices replicate the stage "
                "compute. Use pp with dp/tp instead.")
        logger.info("pipeline stage %d of %d holds encoder blocks %s", self.stage, pp,
                    self.owned)

    # -- names ------------------------------------------------------------------
    def _layer(self, attr: str, name: str) -> Optional[int]:
        prefix = self.prefix[attr]
        if not name.startswith(prefix):
            return None
        return int(name[len(prefix):].split(".", 1)[0])

    def _mine(self, attr: str, name: str) -> bool:
        layer = self._layer(attr, name)
        return layer is None or layer in self.owned

    def _template(self, attr: str, name: str) -> str:
        """The name of ``name``'s tensor in this rank's first block."""
        prefix = self.prefix[attr]
        return re.sub(rf"^{re.escape(prefix)}\d+\.", f"{prefix}{self.owned[0]}.", name)

    def _names(self, trained) -> List[str]:
        by_id = {id(p): n for n, p in self.modules[self.train_attr].named_parameters()}
        return [by_id[id(p)] for p in trained]

    def _full_trained(self, local_names: List[str]) -> List[str]:
        """The trained parameters' names of the whole model, in its order."""
        local = set(local_names)
        attr = self.train_attr
        return [n for n in self.train_names
                if (n if self._mine(attr, n) else self._template(attr, n)) in local]

    def trained_names(self, trained) -> List[str]:
        """The whole model's trained parameters' names, in its order, from
        this rank's ``trained`` (as the optimizer selects them)."""
        return self._full_trained(self._names(trained))

    # -- the exchange -------------------------------------------------------------
    @torch.no_grad()
    def _broadcast(self, tensors: List[torch.Tensor], stage: int) -> None:
        """``tensors`` from ``stage``'s rank to every rank of the pipe group,
        in place (one flat broadcast a dtype, on this rank's device)."""
        mine = stage == self.stage
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for dtype, group in by_dtype.items():
            if mine:
                flat = torch.cat([t.reshape(-1) for t in group]).to(self.device)
            else:
                flat = torch.empty(sum(t.numel() for t in group), dtype=dtype,
                                   device=self.device)
            dist.broadcast(flat, self.ranks[stage], self.group)
            if not mine:
                offset = 0
                for t in group:
                    t.copy_(flat[offset:offset + t.numel()].view(t.shape))
                    offset += t.numel()

    def _complete(self, attr: str, named: Mapping[str, torch.Tensor],
                  full: List[str]) -> Dict[str, torch.Tensor]:
        """``named`` (this rank's blocks and the rest) with every other
        stage's blocks, in the order of ``full``: each block broadcast from
        its stage, every rank taking part."""
        got: Dict[str, torch.Tensor] = {}
        for layer in range(self.num_layers):
            keys = [n for n in full if self._layer(attr, n) == layer]
            if not keys:
                continue
            stage = self.stage_of[layer]
            if stage == self.stage:
                tensors = [named[k] for k in keys]
            else:
                tensors = [torch.empty_like(named[self._template(attr, k)]) for k in keys]
            self._broadcast(tensors, stage)
            got.update(zip(keys, tensors))
        return {n: got[n] if n in got else named[n] for n in full}

    # -- the trainer's interface ----------------------------------------------------
    def host_state_dict(self, state, trained, keep: bool = True):
        """``state.state_dict()`` with every stage's blocks, whole tensors (the
        reference layout), in host memory; every rank takes part, only
        ``keep`` ranks get it (the others None)."""
        from ..train.trainers.base import to_host

        tree = (self.inner.host_state_dict(state, trained, True) if self.inner is not None
                else to_host(state.state_dict()))
        for attr in self.modules:
            tree[attr] = self._complete(attr, tree[attr], self.full_keys[attr])
        local = self._names(trained)
        full = self._full_trained(local)
        opt = dict(tree["opt_state"])
        for name, bufs in opt.items():
            if name != "count":
                done = self._complete(self.train_attr, dict(zip(local, bufs)), full)
                opt[name] = [done[n] for n in full]
        tree["opt_state"] = opt
        return tree if keep else None

    @torch.no_grad()
    def load_state_dict(self, state, tree, trained) -> None:
        """A whole-model tree (of any pp, or of one process) into this rank's
        part of the state."""
        tree = dict(tree)
        for attr in self.modules:
            tree[attr] = {k: v for k, v in tree[attr].items() if self._mine(attr, k)}
        local = self._names(trained)
        full = self._full_trained(local)
        opt = dict(tree["opt_state"])
        for name, bufs in opt.items():
            if name != "count":
                by_name = dict(zip(full, bufs))
                opt[name] = [by_name[n] for n in local]
        tree["opt_state"] = opt
        if self.inner is not None:
            self.inner.load_state_dict(state, tree, trained)
        else:
            state.load_state_dict(tree)

    @torch.no_grad()
    def unsharded(self, module: nn.Module, keep: bool = True):
        """An unpipelined copy of one of the modules, every block in place
        (and unsharded by ``inner``): every rank takes part, only ``keep``
        ranks build it (the others get None)."""
        attr, = (a for a, m in self.modules.items() if m is module)
        base = module if self.inner is None else self.inner.unsharded(module, keep=True)
        whole = self._complete(attr, dict(base.state_dict()), self.full_keys[attr])
        if not keep:
            return None
        clone = _deepcopy_unmarked(base) if base is module else base
        owner = blocks_owner(clone)
        owner.__dict__.pop("_pipeline", None)
        for i in range(self.num_layers):
            if i not in self.owned:
                owner.encoder_blocks[i] = copy.deepcopy(owner.encoder_blocks[self.owned[0]])
        clone.load_state_dict(whole, strict=True)
        return clone
