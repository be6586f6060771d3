"""Shared checks of the example tests (tests/test_torch_examples*.py): a
twin of safeincave_torch/examples run on the CPU against the JAX example,
run live or read from its golden (tests/golden/torch_port_examples_*.npz).
"""
import os

import numpy as np
import pytest

import torch_port_configs as cfg

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "torch_port_examples_{}.npz")

# the folder each example's plot_results.py reads, under the run's cwd
PLOT_ROOTS = {"thermal_cube": "output/thermal_cube",
              "triaxial": "output/case_0", "cube_regions": "output/case_0",
              "tm_cube": "output/tm_cube", "cavern": "output",
              "thermal_cavern": "output/case_0",
              "interlayer": "output/nobian_interlayer",
              "yearly": "output/nobian_yearly",
              "tm_cavern": "output/case_1"}


def jax_xdmf_text(field, times, saved, n_nodes, n_elems, folder):
    """The XDMF text the JAX package's SaveFields writes for ``field``
    saved at ``times`` with the last save ``saved`` (as stored: 3x3
    tensors flat) on a mesh of ``n_nodes`` / ``n_elems``: its own
    ``_write_xdmf`` run on a stand-in writer."""
    import types
    from safeincave_tpu.output.xdmf import SaveFields
    out = SaveFields.__new__(SaveFields)
    out.grid = types.SimpleNamespace(n_nodes=n_nodes, n_elems=n_elems)
    out.output_folder = folder
    out._times = {field: [float(t) for t in times]}
    sample = np.asarray(saved)
    if sample.ndim == 2 and sample.shape[1] == 9:
        sample = sample.reshape(-1, 3, 3)
    os.makedirs(os.path.join(folder, field), exist_ok=True)
    out._write_xdmf(field, sample)
    with open(os.path.join(folder, field, f"{field}.xdmf")) as f:
        return f.read()


def golden_record(name, sched):
    """The golden's record of ``name`` at ``sched`` ("cpu"; the "card"
    keys when the CPU tests and the card run the same arguments)."""
    with np.load(GOLDEN.format(name)) as z:
        keys = [k for k in z.files if k.startswith("cpu.")] or \
            [k for k in z.files if k.startswith("card.")]
        return {k.split(".", 1)[1]: z[k] for k in keys}


def run_twin(name, tmp_path, **extra):
    """The twin at the CPU tests' arguments in ``tmp_path/port``; returns
    (main's result, the outputs' record, the output root)."""
    import safeincave_torch.postproc as pp
    script, kwargs, _ = cfg.EXAMPLE_RUNS[name]
    run = str(tmp_path / "port")
    result = cfg.run_example("safeincave_torch", script, run,
                             {**kwargs, **extra}, device="cpu")
    out = os.path.join(run, "output")
    return result, cfg.example_record(out, pp.read_timeseries), out


def run_jax(name, tmp_path, **extra):
    """The JAX example at the same arguments in ``tmp_path/jax``; returns
    (the outputs' record, the output root)."""
    import safeincave_tpu.postproc as pp
    script, kwargs, _ = cfg.EXAMPLE_RUNS[name]
    run = str(tmp_path / "jax")
    cfg.run_example("safeincave_tpu", script, run, {**kwargs, **extra})
    out = os.path.join(run, "output")
    return cfg.example_record(out, pp.read_timeseries), out


def hold(rec, ref, tol=1e-8):
    """Final saved fields within ``tol`` max|ref|, save times equal, the
    fixed-point counts of each transcript equal."""
    assert set(rec) == set(ref), sorted(set(rec) ^ set(ref))
    for k, want in ref.items():
        got = rec[k]
        if k.endswith(".times") or k.endswith("log"):
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)
            assert err <= tol, (k, err)


def xdmf_texts(out_root):
    """{relative path: text} of every .xdmf under ``out_root``."""
    texts = {}
    for base, _, files in os.walk(out_root):
        for f in files:
            if f.endswith(".xdmf"):
                path = os.path.join(base, f)
                with open(path) as fh:
                    texts[os.path.relpath(path, out_root)] = fh.read()
    return texts


def hold_xdmf(out_root, ref_root=None, rec=None, tmp=None):
    """The twin's XDMF texts equal the JAX package's: those of a live JAX
    run under ``ref_root``, or the text the JAX SaveFields writes for the
    golden's save times and field layout (``rec``)."""
    import safeincave_torch.postproc as pp
    got = xdmf_texts(out_root)
    assert got
    if ref_root is not None:
        assert got == xdmf_texts(ref_root)
        return
    for rel, text in got.items():
        folder = os.path.dirname(os.path.dirname(os.path.join(out_root,
                                                              rel)))
        field = os.path.basename(rel)[:-len(".xdmf")]
        key = os.path.dirname(os.path.dirname(rel)).replace(os.sep, ".")
        key = f"{key}.{field}" if key else field
        _, _, pts, topo = pp.read_timeseries(folder, field)
        want = jax_xdmf_text(field, rec[f"{key}.times"], rec[key],
                                 len(pts), len(topo),
                                 os.path.join(str(tmp), "xdmf", key))
        assert text == want, rel


def plot(name, tmp_path):
    """The twin's plot_results.py on the twin's outputs: results.png."""
    script = cfg.EXAMPLE_RUNS[name][0].replace("main.py", "plot_results.py")
    mod = cfg.load_example("safeincave_torch", script)
    root = os.path.join(str(tmp_path / "port"), PLOT_ROOTS[name])
    import matplotlib
    matplotlib.use("Agg")
    mod["main"](root)
    assert os.path.isfile(os.path.join(root, "results.png"))


@pytest.fixture
def one_torch_thread():
    """One torch thread per test process while a twin runs: the examples'
    meshes are small, and several workers each running torch's full
    thread pool on the same cores slow every test many times over."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
