from affganwriting_torch.parallel.mesh import (
    make_mesh,
    batch_sharding,
    replicated,
    shard_batch,
    shard_params,
    param_shardings,
)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated",
    "shard_batch",
    "shard_params",
    "param_shardings",
]
