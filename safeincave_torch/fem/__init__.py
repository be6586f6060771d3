"""Matrix-free tetrahedral FEM core (CG1 displacements, DG0 materials)."""
from .kernels import MomentumKernel
from .solvers import cg_solve, bicgstab_solve, ir_solve
from .momentum import LinearMomentumBase, LinearMomentum, SolverSettings

__all__ = ["MomentumKernel", "cg_solve", "bicgstab_solve", "ir_solve",
           "LinearMomentumBase", "LinearMomentum", "SolverSettings"]
