"""Mesh layer: gmsh reader and writer, built-in box and cavern meshes, grids
(with the node/element smoother), reordering (band, Morton, RCB) and the
native preprocessing library."""
from .msh_io import read_msh, write_msh
from .grid import Grid, GridHandlerGMSH
from .boxgen import box_mesh, GridBox, GridBoxRegions
from .reorder import band_order, reordered_grid
from . import native

__all__ = ["read_msh", "write_msh", "Grid", "GridHandlerGMSH", "box_mesh",
           "GridBox", "GridBoxRegions", "band_order", "reordered_grid",
           "native"]
