"""The parallel axes of the port (after ``vit_ssl_tpu/parallel/``): the
process mesh (:mod:`.mesh`), the published context (:mod:`.context`), data
parallelism (:mod:`.data_parallel`), ZeRO-3 sharding (:mod:`.fsdp`), ring
attention over the ``seq`` axis (:mod:`.ring_attention`), and tensor and
expert parallelism over the ``model`` and ``expert`` axes
(:mod:`.sharding_rules`, :mod:`.tensor_parallel`), and pipeline
parallelism over the ``pipe`` axis (:mod:`.pipeline`, :mod:`.integrate`)."""

from .context import (
    current_mesh,
    dp_size,
    ep_size,
    pp_size,
    set_parallel_context,
    sp_size,
    tp_size,
)
from .mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    Mesh,
    axis_sizes,
    mesh_from_config,
)

__all__ = [
    "DATA_AXIS", "EXPERT_AXIS", "MODEL_AXIS", "PIPE_AXIS", "SEQ_AXIS", "Mesh", "axis_sizes",
    "current_mesh", "dp_size", "ep_size", "mesh_from_config", "pp_size", "set_parallel_context",
    "sp_size", "tp_size",
]
