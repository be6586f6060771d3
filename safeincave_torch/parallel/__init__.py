"""Domain decomposition: element sharding with a summed assembly and the
owned-node halo exchange, D parts on one device (port of
``safeincave_tpu/parallel``)."""
from .sharding import (make_device_mesh, shard_equation, shard_tm,
                       ShardedMomentumKernel, ShardedHeatKernel)
from .halo import HaloPlan, HaloMomentumSolver

__all__ = ["make_device_mesh", "shard_equation", "shard_tm",
           "ShardedMomentumKernel", "ShardedHeatKernel", "HaloPlan",
           "HaloMomentumSolver"]
