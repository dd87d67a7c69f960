"""Data parallelism: the gradient all-reduce, written out (XLA inserts it in
the JAX package).

:class:`DataParallelOptimizer` wraps one of the port's optimizers
(``train/state.py``). Its ``update`` sums the step's gradients over the
``data`` axis (one flat buffer a dtype, one ``all_reduce``) before the
inner update, so it runs once a step: under ``grad_accum`` on the
accumulated total, after the last microbatch. The steps already divide by
the global batch's weight sum (:func:`..context.dp_sum`), so the sum is the
gradient of the global batch's loss. Under ``parallel.fsdp`` it
reduce-scatters into the chunks instead and updates those
(:class:`..fsdp.ShardedState`).

The explicit all-reduce rather than ``DistributedDataParallel``: the steps
own their backward (``torch.autograd.grad`` of the trained parameters),
remat, ``_GradSum`` and the scanned ``functional_call``, which sit badly
with DDP's ``no_sync`` and its autograd hooks; one reduction after them is
simpler and as cheap at these sizes.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


@torch.no_grad()
def all_reduce_flat(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """``tensors`` summed over ``group``: one flat buffer a dtype, one
    all-reduce each; returns views of the buffers in the input order."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        offset = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[offset:offset + n].view(tensors[i].shape)
            offset += n
    return out


class DataParallelOptimizer:
    """An optimizer whose updates take the gradients summed over the data
    group (and, with ``sharded``, update the chunks of the sharded
    parameters). Everything else is the inner optimizer's."""

    def __init__(self, inner, group, sharded=None):
        self.inner = inner
        self.group = group
        self.sharded = sharded

    def __getattr__(self, name):
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)

    def _local(self, params):
        if self.sharded is None:
            return list(params)
        return [self.sharded.local(p) for p in params]

    def init(self, params):
        """The inner optimizer's buffers, shaped as the chunks it updates."""
        return self.inner.init(self._local(params))

    def update(self, params, grads, state) -> float:
        if self.sharded is not None:
            params, grads = self.sharded.reduce(list(params), list(grads))
        else:
            grads = all_reduce_flat(list(grads), self.group)
        return self.inner.update(params, grads, state)
