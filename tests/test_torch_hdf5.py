"""The port's own HDF5 writer and reader (safeincave_torch/output/hdf5.py)
against h5py and the JAX package's files.

h5py appears here only, as the reference implementation: the port never
imports it.
"""
import os
import shutil
import subprocess
import sys
import types

import h5py
import numpy as np
import pytest

from safeincave_torch.output.hdf5 import H5Reader, H5Writer, HDF5FeatureError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = ("<f4", "<f8", "<i1", "<i2", "<i4", "<i8", "<u1", "<u2", "<u4",
          "<u8")
SHAPES = ((), (0,), (1,), (7,), (3, 4), (2, 3, 4), (5, 1, 2, 3))


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for dt in DTYPES:
        for shape in SHAPES:
            a = rng.standard_normal(shape) * 1e3
            if dt[1] == "f":
                a = a * 10.0 ** rng.integers(-30, 30, size=shape)
            out[f"types/{dt[1:]}/{'x'.join(map(str, shape)) or 'scalar'}"] = \
                np.asarray(a).astype(dt)
    return out


def _same(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


@pytest.mark.parametrize("dtype", DTYPES)
def test_round_trip_every_dtype_and_shape(tmp_path, dtype):
    """Each dtype at ranks 0-4 (empty included) comes back bit for bit,
    through the port's reader and through h5py."""
    arrays = {k: v for k, v in _arrays().items()
              if k.split("/")[1] == dtype[1:]}
    path = str(tmp_path / "t.h5")
    with H5Writer(path) as w:
        for name, a in arrays.items():
            w.create_dataset(name, data=a)
    with H5Reader(path) as r:
        for name, a in arrays.items():
            assert _same(r.read(name), a), name
    with h5py.File(path, "r") as h:
        for name, a in arrays.items():
            assert _same(h[name][()], a), name


def test_unsupported_dtype_and_names_raise(tmp_path):
    with H5Writer(str(tmp_path / "t.h5")) as w:
        with pytest.raises(TypeError, match="complex128"):
            w.create_dataset("z", data=np.zeros(3, dtype=complex))
        w.create_dataset("a/b", data=np.zeros(2))
        with pytest.raises(ValueError, match="cannot create"):
            w.create_dataset("a/b", data=np.zeros(2))
        with pytest.raises(ValueError, match="not a group"):
            w.create_dataset("a/b/c", data=np.zeros(2))


def test_thousand_datasets_in_one_group(tmp_path):
    """1,000 datasets named as SaveFields names its steps ("10" sorts before
    "2"): a B-tree of two levels; both readers list and read every one."""
    path = str(tmp_path / "big.h5")
    with H5Writer(path) as w:
        for i in range(1000):
            w.create_dataset(f"Function/u/{i}", data=np.full(3, float(i)))
            w.flush()
    names = [str(i) for i in range(1000)]
    with H5Reader(path) as r:
        assert r.keys("Function/u") == sorted(names)
        assert all(r.read(f"Function/u/{i}")[0] == i for i in range(1000))
    with h5py.File(path, "r") as h:
        assert sorted(h["Function/u"].keys()) == sorted(names)
        assert all(h[f"Function/u/{i}"][2] == i for i in range(1000))
    # the two index blocks per group keep the file within a constant factor
    # of what h5py writes for the same datasets
    ref = str(tmp_path / "ref.h5")
    with h5py.File(ref, "w") as h:
        for i in range(1000):
            h.create_dataset(f"Function/u/{i}", data=np.full(3, float(i)))
    assert os.path.getsize(path) < 2 * os.path.getsize(ref)


def test_copy_after_each_flush_is_a_file(tmp_path):
    """A copy of the file taken after every flush opens in h5py and holds
    every step saved so far, as SaveFields flushes after each save."""
    path = str(tmp_path / "u.h5")
    rng = np.random.default_rng(1)
    steps = [rng.standard_normal((6, 3)) for _ in range(20)]
    w = H5Writer(path)
    w.create_dataset("Mesh/geometry", data=rng.standard_normal((6, 3)))
    w.create_dataset("Mesh/topology", data=np.arange(8).reshape(2, 4))
    for k, arr in enumerate(steps):
        w.create_dataset(f"Function/u/{k}", data=arr)
        w.flush()
        snap = str(tmp_path / f"snap_{k}.h5")
        shutil.copy(path, snap)
        with h5py.File(snap, "r") as h:
            assert len(h["Function/u"]) == k + 1
            for j in range(k + 1):
                assert _same(h[f"Function/u/{j}"][()], steps[j])
            assert h["Mesh/topology"].dtype == np.int64
        with H5Reader(snap) as r:
            assert len(r.keys("Function/u")) == k + 1
    w.close()


def test_reads_h5py_files_and_names_unsupported_features(tmp_path):
    """Every dtype h5py writes by default reads back bit for bit; a chunked
    dataset, a compressed one, a later superblock and new-style groups
    raise naming the feature."""
    arrays = _arrays(2)
    path = str(tmp_path / "h.h5")
    with h5py.File(path, "w") as h:
        for name, a in arrays.items():
            h.create_dataset(name, data=a)
        h.create_dataset("chunked", data=np.zeros((64, 64)), chunks=(8, 8))
        h.create_dataset("gzip", data=np.zeros(100), compression="gzip")
        h.create_dataset("text", data=np.bytes_("abc"))
        h.create_dataset("big_endian", data=np.arange(4, dtype=">f8"))
    with H5Reader(path) as r:
        for name, a in arrays.items():
            assert _same(r.read(name), a), name
        with pytest.raises(HDF5FeatureError, match="chunked dataset layout"):
            r.read("chunked")
        with pytest.raises(HDF5FeatureError, match="filter pipeline"):
            r.read("gzip")
        with pytest.raises(HDF5FeatureError, match="string datatype"):
            r.read("text")
        with pytest.raises(HDF5FeatureError, match="big-endian"):
            r.read("big_endian")
    latest = str(tmp_path / "latest.h5")
    with h5py.File(latest, "w", libver="latest") as h:
        h["a"] = np.ones(3)
    with pytest.raises(HDF5FeatureError, match="superblock version"):
        H5Reader(latest)


def _tiny_equation(pkg_name):
    """A stand-in equation for SaveFields: a 2-tet grid and fields of every
    layout SaveFields writes (nodal scalar and vector, cell scalar, 3x3
    tensor, Voigt)."""
    rng = np.random.default_rng(3)
    pts = rng.standard_normal((5, 3))
    conn = np.array([[0, 1, 2, 3], [1, 2, 3, 4]])
    grid = types.SimpleNamespace(points=pts, conn=conn, n_nodes=5,
                                 n_elems=2, grid_folder=None,
                                 geometry_name=None)
    eq = types.SimpleNamespace(grid=grid, n_elems=2)
    fields = {"T": (5,), "u": (5, 3), "q": (2,), "sig": (2, 3, 3),
              "eps_v": (2, 6)}
    return eq, fields, rng


def test_savefields_files_equal_the_jax_package(tmp_path):
    """The same saves through the JAX package's SaveFields (h5py) and the
    port's: every dataset the same bits through both readers, the XDMF
    text equal, and the port reads the JAX files."""
    import safeincave_tpu.output.xdmf as jx
    import safeincave_torch.output.xdmf as tx
    import safeincave_torch.postproc as tpp
    import safeincave_tpu.postproc as jpp
    outs = {}
    for name, mod in (("jax", jx), ("port", tx)):
        eq, fields, rng = _tiny_equation(name)
        out = mod.SaveFields(eq)
        out.set_output_folder(str(tmp_path / name))
        for f in fields:
            out.add_output_field(f, f)
        out.initialize()
        for k in range(12):
            for f, shape in fields.items():
                setattr(eq, f, rng.standard_normal(shape))
            out.save_fields(3600.0 * k)
        out.save_mesh()
        outs[name] = out
    for f in fields:
        h5 = f"{f}/{f}.h5"
        with h5py.File(tmp_path / "jax" / h5, "r") as hj, \
                h5py.File(tmp_path / "port" / h5, "r") as hp, \
                H5Reader(str(tmp_path / "jax" / h5)) as rj:
            paths = ["Mesh/geometry", "Mesh/topology"] + [
                f"Function/{f}/{k}" for k in range(12)]
            assert sorted(hp[f"Function/{f}"].keys()) == \
                sorted(hj[f"Function/{f}"].keys())
            for p in paths:
                assert _same(hp[p][()], hj[p][()]), (f, p)
                assert _same(rj.read(p), hj[p][()]), (f, p)
        xj = open(tmp_path / "jax" / f / f"{f}.xdmf").read()
        xp = open(tmp_path / "port" / f / f"{f}.xdmf").read()
        assert xj == xp
        tj = jpp.read_timeseries(str(tmp_path / "jax"), f)
        tp = tpp.read_timeseries(str(tmp_path / "port"), f)
        for a, b in zip(tj, tp):
            assert _same(np.asarray(a), np.asarray(b))
        # the port reads the JAX package's files through its generic
        # XDMF reader too
        pj = tpp.read_xdmf(str(tmp_path / "jax" / f / f"{f}.xdmf"))
        pp_ = jpp.read_xdmf(str(tmp_path / "jax" / f / f"{f}.xdmf"))
        assert _same(pj[0], np.asarray(pp_[0]))
        assert _same(pj[3][f]["values"], np.asarray(pp_[3][f]["values"]))


def test_reads_the_dolfinx_fixture(tmp_path):
    """The dolfinx XDMFFile layout of tests/test_postproc_xdmf.py, written
    by h5py, reads to the same bits as the JAX package reads it."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    try:
        from test_postproc_xdmf import _dolfinx_fixture
    finally:
        sys.path.pop(0)
    import safeincave_tpu.postproc as jpp
    import safeincave_torch.postproc as tpp
    xdmf = _dolfinx_fixture(tmp_path)[0]
    got, want = tpp.read_xdmf(str(xdmf)), jpp.read_xdmf(str(xdmf))
    for a, b in zip(got[:3], want[:3]):
        assert _same(np.asarray(a), np.asarray(b))
    assert set(got[3]) == set(want[3]) == {"u", "q"}
    for k in got[3]:
        assert got[3][k]["center"] == want[3][k]["center"]
        assert _same(got[3][k]["values"], np.asarray(want[3][k]["values"]))


SIM_WITHOUT_H5PY = r"""
import sys
sys.modules["h5py"] = None
import numpy as np
import safeincave_torch as sc
eq = sc.LinearMomentum(sc.GridBox(nx=2, ny=2, nz=2), theta=0.5,
                       device="cpu")
eq.set_solver(sc.SolverSettings(method="cg", rtol=1e-12, max_it=500))
n = eq.n_elems
one = np.ones(n)
mat = sc.Material(n, device="cpu")
mat.set_density(2000.0 * one)
mat.add_to_elastic(sc.Spring(102e9 * one, 0.3 * one))
mat.add_to_non_elastic(sc.DislocationCreep(1.9e-20 * one, 51600 * one,
                                           3.0 * one, device="cpu"))
eq.set_material(mat)
eq.set_T0(298.0 * one)
eq.set_T(298.0 * one)
eq.build_body_force([0.0, 0.0, 0.0])
bc = sc.MomentumBC.BcHandler(eq)
tv = [0.0, 1e9]
for nm, comp in (("WEST", 0), ("SOUTH", 1), ("BOTTOM", 2)):
    bc.add_boundary_condition(sc.MomentumBC.DirichletBC(nm, comp, [0., 0.],
                                                        tv))
bc.add_boundary_condition(sc.MomentumBC.NeumannBC("TOP", 2, 0.0, 0.0,
                                                  [10e6, 10e6], tv, g=0.0))
eq.set_boundary_conditions(bc)
out = sc.SaveFields(eq)
out.set_output_folder(sys.argv[1])
out.add_output_field("u", "u")
out.add_output_field("q_elems", "q")
tc = sc.TimeController(dt=1.0, initial_time=0.0, final_time=3.0,
                       time_unit="hour")
sc.Simulator_M(eq, tc, [out]).run()
t, u, _, _ = sc.PostProcessingTools.read_timeseries(sys.argv[1], "u")
assert list(t) == [0.0, 3600.0, 7200.0, 10800.0], t
assert np.array_equal(u[-1], eq.u.numpy())
_, _, _, fields = sc.PostProcessingTools.read_xdmf(sys.argv[1] + "/q_elems/q_elems.xdmf")
assert np.array_equal(fields["q_elems"]["values"][-1], eq.q_elems.numpy())
assert "h5py" not in sys.modules or sys.modules["h5py"] is None
print("ok")
"""


def test_simulator_writes_and_reads_without_h5py(tmp_path):
    """With h5py made unimportable, Simulator_M writes its outputs through
    SaveFields on the CPU and the port's postproc reads them back to the
    in-memory fields' bits."""
    out = subprocess.run([sys.executable, "-c", SIM_WITHOUT_H5PY,
                          str(tmp_path / "out")], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "ok"
    with h5py.File(tmp_path / "out" / "u" / "u.h5", "r") as h:
        assert len(h["Function/u"]) == 4
