"""XDMF/HDF5 time-series output (port of ``safeincave_tpu/output/xdmf.py``).

The same directory layout, HDF5 datasets and XDMF text as the JAX package:
one ``{out}/{field}/{field}.h5`` + ``{field}.xdmf`` per registered field,
the mesh written once, one dataset per kept save, the source ``.msh``
copied to ``{out}/mesh/``.  Fields are looked up as attributes of the
equation at save time and fetched to the host with
``.detach().cpu().numpy()``; the output fields (``u``, ``sig``,
``eps_tot``, ``p_elems``, ``q_elems``, ...) cover the whole mesh at its
true element count on every rank of a sharded equation.  ``h5py`` is
imported when the files are opened (:meth:`SaveFields.initialize`), so the
solver never needs it.
"""
from __future__ import annotations

import os
import shutil

import numpy as np

from ..utils import is_main_process, to_numpy


def _field_layout(arr, n_nodes, n_elems):
    """(center, attr_type, flat_shape) for an output array."""
    if arr.shape[0] == n_nodes:
        center = "Node"
    elif arr.shape[0] == n_elems:
        center = "Cell"
    else:
        raise ValueError(f"field first dim {arr.shape[0]} matches neither "
                         f"nodes ({n_nodes}) nor cells ({n_elems})")
    if arr.ndim == 1:
        return center, "Scalar", (arr.shape[0],)
    if arr.ndim == 2 and arr.shape[1] == 3:
        return center, "Vector", arr.shape
    if arr.ndim == 3 and arr.shape[1:] == (3, 3):
        return center, "Tensor", (arr.shape[0], 9)
    if arr.ndim == 2 and arr.shape[1] == 6:
        return center, "Tensor6", (arr.shape[0], 6)
    raise ValueError(f"unsupported field shape {arr.shape}")


class SaveFields:
    """Register fields of an equation and write XDMF time series.

    The simulators drive it through ``initialize``, ``save_fields(t)``,
    ``calls_until_next_keep``, ``skip_calls(k)`` and ``save_mesh``; any
    object with those methods (and ``fields``) can stand in for it.  In a
    multi-card run every rank drives it (the element fields are gathered
    from every rank) and rank 0 writes."""

    def __init__(self, eq, save_every: int = 1):
        """``save_every=N`` keeps only every N-th save call (plus the
        first)."""
        self.eq = eq
        self.grid = eq.grid
        self.fields: list[tuple[str, str]] = []
        self.output_folder = "output"
        self.save_every = save_every
        self._call_count = 0
        self._handles = {}
        self._times = {}
        self._writes = is_main_process()

    def set_output_folder(self, folder: str):
        self.output_folder = folder

    def add_output_field(self, field_name: str, label: str):
        self.fields.append((field_name, label))

    # ------------------------------------------------------------------ #
    def initialize(self):
        if not self._writes:
            return
        import h5py
        for field_name, _ in self.fields:
            fdir = os.path.join(self.output_folder, field_name)
            os.makedirs(fdir, exist_ok=True)
            h5path = os.path.join(fdir, f"{field_name}.h5")
            h5 = h5py.File(h5path, "w")
            h5.create_dataset("Mesh/geometry", data=np.asarray(self.grid.points))
            h5.create_dataset("Mesh/topology",
                              data=np.asarray(self.grid.conn, dtype=np.int64))
            self._handles[field_name] = h5
            self._times[field_name] = []

    def _get_field(self, field_name):
        return to_numpy(getattr(self.eq, field_name))

    def calls_until_next_keep(self) -> int:
        """How many ``save_fields`` calls until one actually writes (>= 1):
        the fused multi-step driver sizes its chunks so that every write
        happens at the step it would in the per-step flow."""
        j = (1 - self._call_count) % self.save_every
        return j if j else self.save_every

    def skip_calls(self, k: int):
        """Account ``k`` save calls whose steps ran inside a fused chunk;
        only calls that would not have written may be skipped."""
        if k >= self.calls_until_next_keep():
            raise ValueError("fused chunk crossed a save boundary")
        self._call_count += k

    def save_fields(self, t: float):
        keep = (self._call_count % self.save_every == 0)
        self._call_count += 1
        if not keep:
            return
        for field_name, label in self.fields:
            arr = self._get_field(field_name)
            if not self._writes:
                continue
            h5 = self._handles[field_name]
            step = len(self._times[field_name])
            center, attr_type, flat_shape = _field_layout(
                arr, self.grid.n_nodes, self.grid.n_elems)
            h5.create_dataset(f"Function/{field_name}/{step}",
                              data=arr.reshape(flat_shape))
            self._times[field_name].append(float(t))
            h5.flush()

    def save_mesh(self):
        """Finalize: write the XDMF text and copy the source mesh."""
        for field_name, label in self.fields:
            arr = self._get_field(field_name)
            if self._writes:
                self._write_xdmf(field_name, arr)
                self._handles[field_name].close()
        if not self._writes:
            return
        mesh_dir = os.path.join(self.output_folder, "mesh")
        os.makedirs(mesh_dir, exist_ok=True)
        src_folder = getattr(self.grid, "grid_folder", None)
        src_name = getattr(self.grid, "geometry_name", None)
        if src_folder and src_name:
            src = os.path.join(src_folder, f"{src_name}.msh")
            if os.path.isfile(src):
                shutil.copy(src, mesh_dir)

    # ------------------------------------------------------------------ #
    def _write_xdmf(self, field_name: str, sample: np.ndarray):
        n_nodes = self.grid.n_nodes
        n_elems = self.grid.n_elems
        center, attr_type, flat_shape = _field_layout(sample, n_nodes, n_elems)
        dims = " ".join(str(d) for d in flat_shape)
        h5name = f"{field_name}.h5"
        times = self._times[field_name]

        grids = []
        for step, t in enumerate(times):
            grids.append(f"""
      <Grid Name="step_{step}" GridType="Uniform">
        <xi:include xpointer="xpointer(//Grid[@Name='mesh']/*[self::Topology or self::Geometry])"/>
        <Time Value="{t}"/>
        <Attribute Name="{field_name}" AttributeType="{attr_type}" Center="{center}">
          <DataItem Dimensions="{dims}" Format="HDF" DataType="Float" Precision="8">{h5name}:/Function/{field_name}/{step}</DataItem>
        </Attribute>
      </Grid>""")

        xml = f"""<?xml version="1.0"?>
<!DOCTYPE Xdmf SYSTEM "Xdmf.dtd" []>
<Xdmf Version="3.0" xmlns:xi="http://www.w3.org/2001/XInclude">
  <Domain>
    <Grid Name="mesh" GridType="Uniform">
      <Topology TopologyType="Tetrahedron" NumberOfElements="{n_elems}">
        <DataItem Dimensions="{n_elems} 4" Format="HDF" DataType="Int">{h5name}:/Mesh/topology</DataItem>
      </Topology>
      <Geometry GeometryType="XYZ">
        <DataItem Dimensions="{n_nodes} 3" Format="HDF" DataType="Float" Precision="8">{h5name}:/Mesh/geometry</DataItem>
      </Geometry>
    </Grid>
    <Grid Name="{field_name}_series" GridType="Collection" CollectionType="Temporal">{"".join(grids)}
    </Grid>
  </Domain>
</Xdmf>
"""
        path = os.path.join(self.output_folder, field_name,
                            f"{field_name}.xdmf")
        with open(path, "w") as f:
            f.write(xml)
