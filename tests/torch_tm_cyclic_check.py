"""Shared checks of the TM-cyclic test files (tests/test_torch_tm_cyclic*.py):
bench.py's three coupled thermo-mechanical cyclic configurations
(``torch_port_configs.TM_CYCLIC``), one file per mesh so that the heavy
meshes run on different workers.

- the JAX twin (``torch_port_configs.tm_cyclic``) set up as bench.py's own
  ``build_tm_cyclic`` sets it up, which runs in a child process: importing
  bench.py sets ``JAX_COMPILATION_CACHE_DIR``, which its band switch reads
  (``BENCH_NO_BAND=1`` there keeps the cumsum operator);
- the port on the CPU against the JAX golden
  (tests/golden/torch_port_tmcyc_<mesh>.npz): the elastic u at 1e-8
  relative, then the first step's fixed-point and heat CG counts and
  convergence flag equal, u, T and sig_v at 1e-8 max|ref|.  Krylov counts
  are not held: the port's mixed-precision solves drift by a few percent.
"""
import os
import subprocess
import sys

import numpy as np

import torch_port_configs as cfg

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden", "torch_port_{}.npz")

BENCH_DUMP = """
import sys
import numpy as np
sys.path[:0] = [{root!r}, {here!r}]
import bench
import torch_port_configs as cfg
eq, heat = bench.build_tm_cyclic({grid!r}, {fallback!r}, "twin",
                                 reorder="band")
np.savez({out!r}, **cfg.setup_arrays(eq, heat))
"""

# what the twin pins that bench.py leaves to "auto": bench's value, the
# twin's
PINNED = {"solver.precond": ("auto", "2level"),
          "solver.fp32_phase": ("auto", "False")}


def bench_builder_matches(path, tmp_path):
    """The JAX twin of ``path`` sets up the same material, boundary tables,
    solver settings and initial state as bench.py's builder, bit for bit,
    but the two settings it pins."""
    import safeincave_tpu as sc
    grid, fallback, _ = cfg.TM_CYCLIC[path]
    out = str(tmp_path / "bench.npz")
    env = {**os.environ, "BENCH_NO_BAND": "1", "JAX_PLATFORMS": "cpu"}
    subprocess.run([sys.executable, "-c", BENCH_DUMP.format(
        root=cfg.ROOT, here=HERE, grid=grid, fallback=fallback, out=out)],
        check=True, env=env, cwd=str(tmp_path), timeout=600)
    with np.load(out) as z:
        ref = {k: z[k] for k in z.files}
    got = cfg.setup_arrays(*cfg.tm_cyclic_path(sc, path,
                                               auto_backend=False))
    assert sorted(got) == sorted(ref), sorted(set(got) ^ set(ref))
    for key, (bench_val, twin_val) in PINNED.items():
        assert str(ref.pop(key)) == bench_val and \
            str(got.pop(key)) == twin_val, key
    assert any(k.startswith("mat.elems_ne.") for k in ref)
    for k, want in ref.items():
        np.testing.assert_array_equal(got[k], want, err_msg=k)


def rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def port_against_golden(path, steps):
    """The port on the CPU (2level, the cumsum operator, the f32 sweep
    off, as the golden pins them): elastic u, then ``steps`` (0 or 1)
    steps against the golden's first."""
    import safeincave_torch as st
    with np.load(GOLDEN.format(path)) as z:
        ref = {k: z[k] for k in z.files}
    eq, heat = cfg.tm_cyclic_path(st, path, device="cpu",
                                  auto_backend=False)
    cfg.tm_cyclic_init(eq, heat)
    assert rel(cfg.as_np(eq.u), ref["u_elastic"]) <= 1e-8
    if not steps:
        return
    rows = cfg.tm_cyclic_run(eq, heat, 1)
    # heat CG iterations, fixed-point iterations, converged
    np.testing.assert_array_equal(rows[0, [0, 2, 5]],
                                  ref["rows"][0, [0, 2, 5]])
    for name, field in cfg.tm_cyclic_fields(eq, heat).items():
        err = rel(field, ref[f"{name}_1"])
        assert err <= 1e-8, (name, err)
