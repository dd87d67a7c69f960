"""The process mesh (after ``vit_ssl_tpu/parallel/mesh.py``).

JAX lays its devices out as a ``jax.sharding.Mesh`` and lets XLA insert the
collectives. Here each process drives one device (``torch.distributed``:
NCCL on the card, gloo on the CPU), the world is laid out as a
``torch.distributed.device_mesh.DeviceMesh`` with JAX's axis names, and the
collectives are written out by the code that needs them (the gradient
all-reduce, the weight sums, the ring).

:func:`axis_sizes` is JAX's ``mesh_from_config`` rule: dp (``data``) is
implicit, whatever the world leaves after tp·pp·sp·ep; axes of size 1 are
left out (``data`` always stays), in the order data, model, pipe, seq,
expert; a layout the world does not divide is refused with JAX's message.
Rank r's coordinates follow that order row-major, as JAX reshapes its
device list, so the ranks of one data index are consecutive.

``replicate`` is a broadcast from rank 0 (:func:`broadcast_module`);
``shard_batch`` has no counterpart: every process loads its own slice of
each global batch (``data/loader.py``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"  # tensor parallelism (not ported: ROADMAP.md queue A item 10)
PIPE_AXIS = "pipe"    # pipeline parallelism (not ported: item 10)
SEQ_AXIS = "seq"      # sequence parallelism, ring attention
EXPERT_AXIS = "expert"  # expert parallelism (not ported: item 10)
_CONFIG_KEYS = {MODEL_AXIS: "tp", PIPE_AXIS: "pp", SEQ_AXIS: "sp", EXPERT_AXIS: "ep"}


def world() -> Tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def axis_sizes(config, world_size: int) -> Dict[str, int]:
    """The mesh's axes and sizes from ``parallel.{num_devices,tp,pp,sp,ep}``
    over ``world_size`` processes, in mesh order, size-1 axes but ``data``
    left out. ``parallel.num_devices`` (-1: all) must not ask for fewer
    processes than were started: each process drives one device."""
    parallel = config.get("parallel", {}) or {}
    sizes = {axis: max(1, int(parallel.get(key, 1) or 1))
             for axis, key in _CONFIG_KEYS.items()}
    n = int(parallel.get("num_devices", -1))
    if n is not None and 0 <= n < world_size:
        raise ValueError(
            f"parallel.num_devices={n} but {world_size} processes were started; "
            "each process drives one device: launch num_devices processes or set "
            "parallel.num_devices=-1")
    n = world_size
    denom = 1
    for size in sizes.values():
        denom *= size
    if n % denom != 0:
        raise ValueError(
            f"parallel config needs tp·pp·sp·ep = {denom} to divide the "
            f"{n} visible devices (tp={sizes[MODEL_AXIS]}, pp={sizes[PIPE_AXIS]}, "
            f"sp={sizes[SEQ_AXIS]}, ep={sizes[EXPERT_AXIS]}); "
            "adjust parallel.num_devices or the axis sizes")
    out = {DATA_AXIS: n // denom}
    out.update({axis: size for axis, size in sizes.items() if size > 1})
    return out


def coordinates(sizes: Dict[str, int], rank: int) -> Dict[str, int]:
    """Rank ``rank``'s index along each axis (row-major over ``sizes``)."""
    coords = {}
    for axis in reversed(list(sizes)):
        coords[axis] = rank % sizes[axis]
        rank //= sizes[axis]
    return {axis: coords[axis] for axis in sizes}


class Mesh:
    """The axes and sizes (``shape``, as JAX's ``Mesh.shape``), this rank's
    coordinates, and a process group per axis from the ``DeviceMesh`` over
    the world: None without a process group; with one, also at world size 1
    (the collectives then run over one rank, so that a single card runs the
    distributed path). ``host_group`` is a gloo group over the whole world
    for small host-side agreements (the preemption flag) without a device
    synchronisation."""

    def __init__(self, sizes: Dict[str, int], rank: int = 0, device_type: str = "cpu"):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)
        self.rank = rank
        self.coords = coordinates(self.shape, rank)
        self.device_mesh = None
        self.groups: Dict[str, Optional[dist.ProcessGroup]] = {a: None for a in sizes}
        self.host_group = None
        self.size = 1
        for s in sizes.values():
            self.size *= s
        if dist.is_available() and dist.is_initialized():
            from torch.distributed.device_mesh import init_device_mesh

            self.device_mesh = init_device_mesh(
                device_type, tuple(sizes.values()), mesh_dim_names=self.axis_names)
            self.groups = {a: self.device_mesh.get_group(a) for a in self.axis_names}
            self.host_group = (dist.new_group(backend="gloo")
                               if dist.get_backend() != "gloo" else dist.group.WORLD)

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


def mesh_from_config(config, device_type: Optional[str] = None) -> Mesh:
    """The mesh of ``config`` over the started processes (one when no
    process group exists). Every rank must call it: the groups are made
    collectively."""
    rank, size = world()
    if device_type is None:
        device_type = "cuda" if (dist.is_initialized()
                                 and dist.get_backend() == "nccl") else "cpu"
    return Mesh(axis_sizes(config, size), rank, device_type)


@torch.no_grad()
def broadcast_module(module: torch.nn.Module) -> None:
    """JAX's ``replicate``: every parameter and buffer of ``module`` takes
    rank 0's values (a no-op without a process group)."""
    if not dist.is_initialized():
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0)
