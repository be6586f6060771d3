"""bench_torch.py, the port's counterpart of bench.py, on the CPU (one torch
thread): what it imports, its set-ups against bench.py's (mechanics, with
and without bench.py's solver flags, and TM-cyclic) array for array, its
command-line flags, its benchmark equation against
tests/golden/torch_port_cavern600.npz, its headline's output contract in
repeats from one saved state, and the byte counts of its rooflines against
bench.py's formulas.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [ROOT, HERE]

import bench_torch  # noqa: E402
import safeincave_torch as st  # noqa: E402
import torch_port_configs as cfg  # noqa: E402
from torch_examples_check import one_torch_thread  # noqa: E402,F401
from torch_tm_cyclic_check import rel  # noqa: E402

CPU = torch.device("cpu")


def test_imports_neither_jax_nor_the_jax_package():
    code = ("import json, sys; sys.path.insert(0, {root!r}); "
            "import bench_torch; "
            "print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))")
    out = subprocess.run([sys.executable, "-c", code.format(root=ROOT)],
                         capture_output=True, text=True, check=True,
                         cwd=ROOT, timeout=300)
    roots = set(json.loads(out.stdout))
    assert "safeincave_torch" in roots
    assert not roots & {"jax", "jaxlib", "safeincave_tpu", "bench", "tests",
                        "torch_port_configs"}, roots


def test_default_device_is_the_card(monkeypatch):
    """Without a CUDA device the benchmark raises and names the CPU way;
    it never falls back on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        bench_torch.build()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        bench_torch.main(["--sections", "headline"])


def test_build_equals_bench_py_build():
    """bench_torch.build on the CPU sets up bench.py's JAX ``build()``:
    the material, the Dirichlet and Neumann tables with their schedules,
    the solver settings, the temperatures and the body force, array for
    array."""
    import bench
    ref = cfg.setup_arrays(bench.build())
    got = cfg.setup_arrays(bench_torch.build(device="cpu"))
    only = set(got) ^ set(ref)
    assert all(cfg.private(k) for k in only), sorted(only)
    common = sorted((set(got) & set(ref)) - cfg.CACHES)
    for table in ("bc._dirichlet_meta.", "bc._neumann_meta.",
                  "mat.elems_ne.2.", "solver.precond"):
        assert any(k.startswith(table) for k in common), table
    for k in common:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_build_holds_the_cavern600_golden(one_torch_thread):
    """With the preconditioner, the f32 sweep and the matvec backend
    pinned as the golden pins them (2level, off, cumsum): elastic u at
    1e-8 relative, then 3 steps through the headline's retrying chunk: u
    and sig_v at 1e-6 max|ref|, equal converged flags and fixed-point
    counts."""
    eq = bench_torch.build(device="cpu")
    eq.set_solver(dataclasses.replace(eq.solver, precond="2level",
                                      fp32_phase=False))
    assert eq.kernel.band is None and eq.kernel.dia is None \
        and eq.kernel.blockell is None
    with np.load(os.path.join(HERE, "golden",
                              "torch_port_cavern600.npz")) as z:
        ref = {k: z[k] for k in z.files}
    bench_torch.elastic_start(eq)
    assert rel(eq.u.numpy(), ref["u_elastic"]) <= 1e-8
    rows, retries = bench_torch.run_chunk(eq, [k * 3600.0 for k in (1, 2, 3)])
    assert retries == 0
    np.testing.assert_array_equal(rows[:, [0, 5]], ref["rows"][:, [0, 5]])
    for name in ("u", "sig_v"):
        err = rel(getattr(eq, name).numpy(), ref[name])
        assert err <= 1e-6, (name, err)


@pytest.mark.parametrize("flag", ["lag_tangent", "adaptive_rtol"])
def test_build_flags_equal_bench_py_env(flag, monkeypatch):
    """``--lag-tangent`` and ``--adaptive-rtol`` set up what bench.py's
    BENCH_LAG_TANGENT=1 and BENCH_ADAPTIVE_RTOL=1 do."""
    import bench
    monkeypatch.setenv(f"BENCH_{flag.upper()}", "1")
    ref = cfg.setup_arrays(bench.build())
    got = cfg.setup_arrays(bench_torch.build(device="cpu", **{flag: True}))
    assert bool(ref[f"solver.{flag}"]) and bool(got[f"solver.{flag}"])
    cfg.assert_same_setup(got, ref)


@pytest.mark.parametrize("backend", ["band", "blockell", "dia"])
def test_backend_flag(backend):
    """``--backend`` enables the named stiffness backend, and raises where
    it cannot be enabled: the band-ordered cavern600 numbering is not
    offset-structured, so block-DIA refuses it."""
    if backend == "dia":
        with pytest.raises(ValueError, match="offset"):
            bench_torch.build(device="cpu", backend=backend)
        with pytest.raises(ValueError, match="offset"):
            bench_torch.main(["--device", "cpu", "--sections", "matvec",
                              "--backend", backend])
        return
    eq = bench_torch.build(device="cpu", backend=backend)
    assert getattr(eq.kernel, backend) is not None


def test_main_passes_the_solver_flags(monkeypatch):
    """``main`` builds the benchmark equation with the command line's
    flags (the section itself is replaced: only the wiring is checked)."""
    built = []

    def spy(*a, **kw):
        built.append(real(*a, **kw))
        return built[-1]

    real = bench_torch.build
    monkeypatch.setattr(bench_torch, "build", spy)
    monkeypatch.setattr(bench_torch, "elastic_start", lambda eq: 0.0)
    monkeypatch.setattr(bench_torch, "bench_hostsync",
                        lambda eq, n_steps: {"launches": {}})
    summary = bench_torch.main(["--device", "cpu", "--sections", "hostsync",
                                "--lag-tangent", "--adaptive-rtol",
                                "--backend", "blockell"])
    (eq,) = built
    assert eq.solver.lag_tangent and eq.solver.adaptive_rtol
    assert eq.kernel.blockell is not None
    assert summary["sections"] == {"hostsync": {"launches": {}}}


@pytest.mark.parametrize("config", bench_torch.TM_CYCLIC,
                         ids=[c[2] for c in bench_torch.TM_CYCLIC])
def test_tm_cyclic_builders_equal_the_twin(config):
    """Each TM-cyclic builder of bench_torch sets up what bench.py's
    ``build_tm_cyclic`` (the JAX twin) does: the material, both boundary
    handlers' tables, the solver settings and the temperatures, array for
    array, built without solving."""
    import bench
    grid_name, fallback, label, _ = config
    got = cfg.setup_arrays(*bench_torch.build_tm_cyclic(
        grid_name, fallback, label, device="cpu"))
    ref = cfg.setup_arrays(*bench.build_tm_cyclic(grid_name, fallback,
                                                  label))
    common = cfg.assert_same_setup(got, ref)
    for table in ("heat_bc.", "bc._neumann_meta.", "mat.elems_th.",
                  "heat_T"):
        assert any(k.startswith(table) for k in common), table


def test_headline_prints_one_json_line(capsys, one_torch_thread):
    """``main`` with the headline alone: one stdout line, bench.py's keys,
    and every repeat from the saved state did the same work."""
    summary = bench_torch.main(["--device", "cpu", "--sections", "headline",
                                "--steps", "2", "--repeats", "2"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1, lines
    line = json.loads(lines[0])
    assert sorted(line) == ["metric", "unit", "value", "vs_baseline",
                            "vs_baseline_measured"]
    assert line["metric"] == "newton_step_wallclock_cavern600"
    assert line["unit"] == "s/step" and line["value"] > 0
    h = summary["sections"]["headline"]
    assert h["repeats"] == 2 and len(h["counts"]) == 2
    assert h["counts"][0] == h["counts"][1]
    assert h["window"] == [3, 4] and h["fp_per_step"] >= 1
    assert h["min_s"] <= h["median_s"] <= h["max_s"]


@pytest.mark.parametrize("fbytes", [4, 8])
def test_byte_counts_equal_bench_py(fbytes):
    """The matvec and DIA sections' bytes are bench.py's formulas
    (bench.py:282-283 and :520-521), on the JAX package's own DIA plan of
    the same small box."""
    import safeincave_tpu as sc
    from safeincave_tpu.fem.dia import BlockDIA
    from safeincave_tpu.fem.kernels import MomentumKernel
    box = dict(Lx=600.0, Ly=600.0, Lz=800.0, nx=4, ny=4, nz=4)
    kern = MomentumKernel(sc.GridBox(**box))
    E, N = kern.n_elems, kern.n_nodes
    p = BlockDIA(kern).plan
    assert bench_torch.matvec_bytes(E, N, fbytes) == \
        (12 + 12 + 1 + 36 + 12) * fbytes * E + 2 * 3 * fbytes * N
    port = bench_torch.BlockDIA(bench_torch.MomentumKernel(
        st.GridBox(**box), CPU)).plan
    assert bench_torch.dia_bytes(port, N, fbytes) == (
        (p.Dn * 9 * N + 6 * N) * fbytes, (p.n_pairs * 9 + 6 * N) * fbytes)


def test_scale_section_runs_on_a_small_box():
    """The scale section end to end at nx=4 on the CPU (the plain DIA
    twin): every timing finite, the streaming ceiling set."""
    roof = bench_torch.Roofline(CPU)
    out = bench_torch.bench_matvec_scale(CPU, roof, nx=4)
    assert out["launches"] == {"dia_matvec_f32": 0, "dia_matvec_f64": 0}
    assert all(np.isfinite(v) and v > 0 for v in out["ms"].values())
    assert roof.ceiling > 0
