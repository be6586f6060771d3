"""safeincave_torch - PyTorch/CUDA port of safeincave_tpu.

The port goes slice by slice; this slice is the cavern mechanics main path
(band-reordered tet mesh, Spring + Viscoelastic + DislocationCreep +
ViscoplasticDesai, Dirichlet supports and Neumann pressure, the elastic
response and the multi-step fixed-point stepping).  Module names follow
``safeincave_tpu`` so each counterpart is easy to find.  The package imports
torch, numpy and scipy, never jax.
"""
from ._device import default_device
from . import utils as Utils  # noqa: N812  (reference-compatible alias)
from .utils import GPa, MPa, kPa, minute, hour, day, year
from .materials import (Material, NonElasticElement, Spring, Viscoelastic,
                        DislocationCreep, ViscoplasticDesai)
from .mesh import Grid, GridHandlerGMSH, GridBox
from .fem import LinearMomentumBase, LinearMomentum, SolverSettings
from .bcs import MomentumBC

__all__ = [
    "default_device", "Utils", "GPa", "MPa", "kPa", "minute", "hour", "day",
    "year", "Material", "NonElasticElement", "Spring", "Viscoelastic",
    "DislocationCreep", "ViscoplasticDesai", "Grid", "GridHandlerGMSH",
    "GridBox", "LinearMomentumBase", "LinearMomentum", "SolverSettings",
    "MomentumBC",
]
