"""Write the port's goldens from the JAX package on CPU.

- ``tests/golden/torch_port_cavern600.npz``: the cavern benchmark
  configuration on grids/cavern_proxy_600 (band reordered), with the
  2level preconditioner and the fp32 phase off;
- ``tests/golden/torch_port_box17.npz``: bench.py's box configuration
  (``GridBox(600, 600, 800, nx=17)``, natural order) with the same material
  and loads, ``enable_dia_matvec()``, the 2level preconditioner and the
  fp32 phase forced on (on the CPU, "auto" would turn it off).

Each holds ``u`` after the elastic phase, then ``u``, ``sig_v`` and the
per-step stats rows after 3 steps of ``solve_time_steps`` at dt = 3600 s,
tol 1e-8.  The machine that runs ``chip_smoke.py`` on the GPU has no JAX, so
it reads these fields.

Run from the repository root (``box17`` or ``cavern600`` writes one):

    JAX_PLATFORMS=cpu python tests/generate_torch_port_golden.py [name]
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import safeincave_tpu as sc  # noqa: E402
import torch_port_configs as cfg  # noqa: E402

N_STEPS = 3


def _cavern600():
    return cfg.wire_bench(sc, cfg.cavern600_grid(sc))


def _box17():
    eq = cfg.wire_bench(sc, cfg.box17_grid(sc), fp32_phase=True)
    eq.enable_dia_matvec()
    return eq


CASES = {"cavern600": _cavern600, "box17": _box17}


def write(name):
    out = os.path.join(HERE, "golden", f"torch_port_{name}.npz")
    eq = CASES[name]()
    cfg.elastic_init(eq)
    u_elastic = np.asarray(eq.u)
    elastic_krylov = eq.solver_stats[0]
    dt = cfg.HOUR
    rows = eq.solve_time_steps([(k + 1) * dt for k in range(N_STEPS)],
                               [dt] * N_STEPS, tol=1e-8, maxiter=40)
    np.savez_compressed(out, u_elastic=u_elastic,
                        elastic_krylov=elastic_krylov,
                        u=np.asarray(eq.u), sig_v=np.asarray(eq.sig_v),
                        rows=np.asarray(rows))
    print(f"wrote {out}: elastic krylov {elastic_krylov}, rows\n{rows}")


if __name__ == "__main__":
    for name in sys.argv[1:] or list(CASES):
        write(name)
