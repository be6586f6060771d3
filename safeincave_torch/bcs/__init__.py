from . import momentum_bc as MomentumBC

__all__ = ["MomentumBC"]
