"""The parallel axes of the port (after ``vit_ssl_tpu/parallel/``): the
process mesh (:mod:`.mesh`), the published context (:mod:`.context`), data
parallelism (:mod:`.data_parallel`), ZeRO-3 sharding (:mod:`.fsdp`) and
ring attention over the ``seq`` axis (:mod:`.ring_attention`). tp, pp and
ep are not ported yet (``ROADMAP.md`` queue A item 10)."""

from .context import (
    current_mesh,
    dp_size,
    set_parallel_context,
    sp_size,
)
from .mesh import DATA_AXIS, SEQ_AXIS, Mesh, axis_sizes, mesh_from_config

__all__ = [
    "DATA_AXIS", "SEQ_AXIS", "Mesh", "axis_sizes", "current_mesh", "dp_size",
    "mesh_from_config", "set_parallel_context", "sp_size",
]
