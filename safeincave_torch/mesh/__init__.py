"""Mesh layer: gmsh reader and writer, built-in box meshes, grids (with the
node/element smoother) and band reordering."""
from .msh_io import read_msh, write_msh
from .grid import Grid, GridHandlerGMSH
from .boxgen import box_mesh, GridBox
from .reorder import band_order, reordered_grid

__all__ = ["read_msh", "write_msh", "Grid", "GridHandlerGMSH", "box_mesh",
           "GridBox", "band_order", "reordered_grid"]
