"""Domain decomposition: element sharding with a summed assembly and the
owned-node halo exchange, D parts over W ranks, one device each (port of
``safeincave_tpu/parallel``)."""
from .sharding import (PartMesh, make_device_mesh, shard_equation, shard_tm,
                       ShardedMomentumKernel, ShardedHeatKernel)
from .halo import HaloPlan, HaloMomentumSolver
from .dist import Comm, init_parts, launch, shutdown

__all__ = ["PartMesh", "make_device_mesh", "shard_equation", "shard_tm",
           "ShardedMomentumKernel", "ShardedHeatKernel", "HaloPlan",
           "HaloMomentumSolver", "Comm", "init_parts", "launch", "shutdown"]
