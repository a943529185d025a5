"""Parallelism of the port (counterpart of ``stif_tpu.parallel``)."""

from stif_tpu_torch.parallel.mesh import (Mesh, default_mesh, device_mesh,
                                          make_mesh)
from stif_tpu_torch.parallel.sharding import (apply_tensor_parallel,
                                              batch_sharding,
                                              param_shardings, replicated,
                                              shard_queries)

__all__ = [
    "Mesh",
    "make_mesh",
    "default_mesh",
    "device_mesh",
    "batch_sharding",
    "replicated",
    "param_shardings",
    "apply_tensor_parallel",
    "shard_queries",
]
