from . import momentum_bc as MomentumBC
from . import heat_bc as HeatBC

__all__ = ["MomentumBC", "HeatBC"]
