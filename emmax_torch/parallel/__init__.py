"""Multi-GPU parallelism: the JAX package's mesh and sharding rules on a
torch ``DeviceMesh``, with the collectives made explicit."""

from emmax_torch.parallel.distributed import barrier, initialize_distributed
from emmax_torch.parallel.mesh import make_mesh
from emmax_torch.parallel.sharding import (batch_sharding, gather_params,
                                           param_partition_specs,
                                           shard_batch, shard_params)

__all__ = ["make_mesh", "param_partition_specs", "shard_params",
           "gather_params", "batch_sharding", "shard_batch",
           "initialize_distributed", "barrier"]
