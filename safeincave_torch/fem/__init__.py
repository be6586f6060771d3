"""Matrix-free tetrahedral FEM core (CG1 displacements, DG0 materials)."""
from .kernels import HeatKernel, MomentumKernel
from .solvers import cg_solve, bicgstab_solve, ir_solve
from .momentum import LinearMomentumBase, LinearMomentum, SolverSettings
from .heat import HeatDiffusion

__all__ = ["MomentumKernel", "HeatKernel", "cg_solve", "bicgstab_solve",
           "ir_solve", "LinearMomentumBase", "LinearMomentum",
           "SolverSettings", "HeatDiffusion"]
