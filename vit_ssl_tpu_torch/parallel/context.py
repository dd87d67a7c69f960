"""The published mesh (after ``vit_ssl_tpu/parallel/context.py``).

The models are built from the model config alone; the trainer publishes the
active :class:`~.mesh.Mesh` here before it builds its steps (JAX
``train/trainers/base.py:93``), and the few places that act on an axis read
it at call time:

- ``MultiHeadAttention`` takes the ring over the ``seq`` axis;
- the modules that :mod:`.tensor_parallel` shards over the ``model`` and
  ``expert`` axes carry their groups themselves; :func:`tp_size` and
  :func:`ep_size` give the axes' sizes;
- the trainer splits the encoder blocks over the ``pipe`` axis
  (:mod:`.pipeline`): :func:`pp_size`, :func:`pipe_rank` (this rank's
  stage) and :func:`pipe_group`;
- the steps, DINO's center and its statistics sum over the ``data`` axis
  (:func:`dp_sum`), so every mean is the global batch's, weight-exact;
- the per-image draws (device augmentation, SimMIM's mask) are the data
  rank's rows of the global batch's draws (:func:`rand_rows`), so a dp-way
  run draws what one process draws;
- the dropout streams fold the data rank in (:func:`data_rank`): each data
  rank draws its own dropout masks and patch-dropout scores, and the
  model, pipe, seq and expert ranks of one data index draw the same ones;
- the loaders shard by the data rank (``data/builder.py``).

:func:`suspended` hides the mesh while one process works alone (rank 0's
evaluation of a run): nothing then reduces, rings or shards.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS, Mesh

_MESH: Optional[Mesh] = None
_SUSPENDED = False
_IN_STAGE = False


def set_parallel_context(mesh: Optional[Mesh]) -> None:
    global _MESH
    _MESH = mesh


def current_mesh() -> Optional[Mesh]:
    return _MESH


@contextlib.contextmanager
def suspended():
    """No mesh inside: one process computes alone (no ring, no reduction,
    unsharded loaders)."""
    global _MESH, _SUSPENDED
    mesh, _MESH = _MESH, None
    was, _SUSPENDED = _SUSPENDED, True
    try:
        yield
    finally:
        _MESH, _SUSPENDED = mesh, was


def is_suspended() -> bool:
    return _SUSPENDED


@contextlib.contextmanager
def pipeline_stage():
    """Inside, the code runs one pipeline stage's blocks (its forward, or
    the backward through them): attention does not ring over the seq axis
    there, as in JAX, where the ring does not run inside the stages'
    ``shard_map``."""
    global _IN_STAGE
    was, _IN_STAGE = _IN_STAGE, True
    try:
        yield
    finally:
        _IN_STAGE = was


def in_pipeline_stage() -> bool:
    return _IN_STAGE


def axis_size(name: str) -> int:
    if _MESH is None:
        return 1
    return int(_MESH.shape.get(name, 1))


def axis_rank(name: str) -> int:
    if _MESH is None:
        return 0
    return int(_MESH.coords.get(name, 0))


def axis_group(name: str):
    """The process group of axis ``name``; None without a mesh, a process
    group, or the axis."""
    if _MESH is None:
        return None
    return _MESH.groups.get(name)


def dp_size() -> int:
    return axis_size(DATA_AXIS)


def sp_size() -> int:
    return axis_size(SEQ_AXIS)


def tp_size() -> int:
    return axis_size(MODEL_AXIS)


def ep_size() -> int:
    return axis_size(EXPERT_AXIS)


def pp_size() -> int:
    return axis_size(PIPE_AXIS)


def pipe_rank() -> int:
    """This rank's pipeline stage."""
    return axis_rank(PIPE_AXIS)


def pipe_group():
    return axis_group(PIPE_AXIS)


def data_rank() -> int:
    return axis_rank(DATA_AXIS)


def is_rank_zero() -> bool:
    """True on global rank 0, or without a process group."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def barrier() -> None:
    """All ranks meet (a no-op without a process group)."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def dp_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data axis: a new tensor (``x`` itself without a
    data group). On the card an NCCL all-reduce on the current stream: the
    host does not wait for it."""
    group = axis_group(DATA_AXIS)
    if group is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=group)
    return x


def dp_gather_rows(x: torch.Tensor, steps: int) -> torch.Tensor:
    """The data ranks' per-row values of an epoch, (…, steps · b) each, as
    one process sees them: (…, steps · b · dp), each global batch's rows in
    the order the loader interleaved them (``x`` itself without a data
    group)."""
    group = axis_group(DATA_AXIS)
    if group is None:
        return x
    n = dist.get_world_size(group)
    out = torch.empty(n * x.numel(), device=x.device, dtype=x.dtype)
    dist.all_gather_into_tensor(out, x.contiguous().view(-1), group=group)
    lead = tuple(x.shape[:-1])
    out = out.view((n,) + lead + (steps, -1))
    rank_last = tuple(range(1, len(lead) + 3)) + (0,)
    return out.permute(rank_last).reshape(lead + (-1,))


def rand_rows(generator: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    """``torch.rand(shape)`` for this data rank's rows of the global batch:
    the global batch's draws (``shape[0]`` × dp rows) from ``generator``,
    of which rank r keeps rows r, r + dp, …, as the loader interleaves its
    slice of each global batch. One process draws the same numbers for the
    same images."""
    n = dp_size()
    shape = tuple(int(s) for s in shape)
    draws = torch.rand((shape[0] * n,) + shape[1:], generator=generator,
                       device=generator.device)
    return draws if n == 1 else draws[data_rank()::n]
