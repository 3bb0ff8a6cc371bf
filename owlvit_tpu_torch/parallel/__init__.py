"""Multi-device training on torch.distributed (counterpart of
owlvit_tpu/parallel): the ("data", "model") mesh and the sharding rules."""

from .mesh import create_mesh  # noqa: F401
from .sharding import (  # noqa: F401
    batch_spec,
    local_gather,
    local_scatter,
    param_specs,
    shard_aligned_batches,
    shard_aligned_order,
    shard_batch,
    shard_params,
)
