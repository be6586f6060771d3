"""Smoke run of the PyTorch/CUDA port (safeincave_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is non-zero:

1. device  - the card (nvidia-smi name, power limit) and torch/CUDA versions.
2. build   - nvcc builds the band kernel from safeincave_torch/csrc/.
3. kernel  - on cavern_proxy_600 with a random energy-symmetric tangent: the
             CUDA band matvec against its plain PyTorch twin (2e-5 max|ref|),
             bitwise repeatability, energy symmetry, and the time of each over
             200 launches (CUDA events).
4. main    - the cavern benchmark configuration through the port's API:
             band-reordered mesh, 4-mechanism material, supports and a 24 h
             sinusoidal pressure, precond "auto" (dense on CUDA) and the band
             kernel auto-selected; elastic response, a 3-step chunk, then
             2 chunks x 10 steps of solve_time_steps at dt = 3600 s.  Every
             step must converge and the kernel must have been launched.
5. parity  - against tests/golden/torch_port_cavern600.npz (the JAX package
             on CPU, 2level preconditioner): elastic u at 1e-8 relative, u and
             sig_v after 3 steps at 1e-6 max|ref| (another preconditioner and
             f32 summation order under a 1e-8 fixed-point tolerance), and
             equal converged flags.

The last lines are the kernel JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``.  There is no CPU fallback: without a CUDA
device the script exits non-zero before printing any result.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_cavern600.npz")
HOUR = 3600.0


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, n=200, warmup=10):
    """Mean ms per call of fn over n calls, timed with CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def rel_err(got, want):
    import numpy as np
    return float(np.abs(got - want).max() / np.abs(want).max())


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's smoke run "
                         "needs a GPU")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import safeincave_torch as st
    import torch_port_configs as cfg
    from safeincave_torch import _build
    from safeincave_torch.fem.bandkernel import BandMatvec, band_matvec_plain
    from safeincave_torch.fem.kernels import MomentumKernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device ------------------------------------------------------------ #
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    say("device", f"{card} | torch {torch.__version__} CUDA "
                  f"{torch.version.cuda} | {torch.cuda.device_count()} "
                  f"device(s)")

    # 2. build ------------------------------------------------------------- #
    t0 = time.perf_counter()
    _build.load("band_matvec")
    say("build", f"band_matvec.cu built and loaded in "
                 f"{time.perf_counter() - t0:.2f} s (nvcc "
                 f"{_build.build_seconds.get('band_matvec', 0.0):.2f} s)")

    # 3. kernel vs plain at the main path's shapes ------------------------- #
    path = st.Utils.find_grid("cavern_regular_600_3D",
                              fallback="cavern_proxy_600")
    grid = st.GridHandlerGMSH("geom", path, reorder="band")
    E, N = grid.n_elems, grid.n_nodes
    band = BandMatvec(MomentumKernel(grid, dev))
    rng = np.random.default_rng(0)
    M = rng.normal(size=(E, 6, 6))
    CT = 0.5 * (M + np.transpose(M, (0, 2, 1))) + 8.0 * np.eye(6)
    w = np.diag([1.0, 1, 1, 2, 2, 2])
    CT = 0.5 * (CT + np.linalg.inv(w) @ np.transpose(CT, (0, 2, 1)) @ w)
    ctv = band.pack_ct(torch.as_tensor(np.transpose(CT, (1, 2, 0)),
                                       dtype=torch.float32, device=dev))
    u = torch.as_tensor(rng.normal(size=(N, 3)), dtype=torch.float32,
                        device=dev)
    v = torch.as_tensor(rng.normal(size=(N, 3)), dtype=torch.float32,
                        device=dev)
    got = band.matvec(ctv, u)
    again = band.matvec(ctv, u)
    Av = band.matvec(ctv, v)
    torch.cuda.synchronize()
    ref = band_matvec_plain(ctv, band.gN, band.conn, band.plan, u)
    max_abs_err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    if not max_abs_err <= 2e-5 * scale:
        raise AssertionError(f"band kernel vs plain: max|err| {max_abs_err} "
                             f"> 2e-5 * {scale}")
    if not torch.equal(got, again):
        raise AssertionError("band kernel is not bitwise repeatable")
    a = float((v.double() * got.double()).sum())
    b = float((u.double() * Av.double()).sum())
    if not abs(a - b) < 1e-3 * max(abs(a), 1.0):
        raise AssertionError(f"energy symmetry: v.Au={a} u.Av={b}")
    ms = cuda_ms(lambda: band.matvec(ctv, u))
    plain_ms = cuda_ms(lambda: band_matvec_plain(ctv, band.gN, band.conn,
                                                 band.plan, u))
    say("kernel", f"cavern600 E={E} N={N}: max|err| {max_abs_err:.3e} "
                  f"(max|ref| {scale:.3e}), bitwise repeatable, energy "
                  f"symmetry {abs(a - b) / abs(a):.1e}; kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms per matvec (200 launches)")

    # 4. main path --------------------------------------------------------- #
    golden = np.load(GOLDEN)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eq = cfg.wire_bench(st, grid, precond="auto")
    if eq.kernel.band is None:
        raise AssertionError("band kernel not auto-selected on CUDA")
    eq.kernel.band.launches = 0
    cfg.elastic_init(eq)
    torch.cuda.synchronize()
    elastic_s = time.perf_counter() - t0
    P, _ = eq._get_precond()
    if not (len(P) == 1 and tuple(P[0].shape) == (3 * N, 3 * N)):
        raise AssertionError("precond 'auto' did not resolve to dense")
    u_elastic = eq.u.cpu().numpy()
    elastic_krylov = eq.solver_stats[0]
    rows3 = eq.solve_time_steps([(k + 1) * HOUR for k in range(3)],
                                [HOUR] * 3, tol=1e-8, maxiter=40)
    u3, sig3 = eq.u.cpu().numpy(), eq.sig_v.cpu().numpy()
    chunks = []
    for c in range(2):
        t_first = (4 + 10 * c) * HOUR
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = eq.solve_time_steps([t_first + k * HOUR for k in range(10)],
                                   [HOUR] * 10, tol=1e-8, maxiter=40)
        torch.cuda.synchronize()
        chunks.append((rows, time.perf_counter() - t0))
    launches = eq.kernel.band.launches
    all_rows = np.concatenate([rows3] + [r for r, _ in chunks])
    if not (all_rows[:, 5] == 1).all():
        raise AssertionError(f"non-converged steps: {all_rows[:, [0, 1, 5]]}")
    if launches <= 0:
        raise AssertionError("the main path never launched the band kernel")
    rows2, secs2 = chunks[1]
    ms_step = 1e3 * secs2 / len(rows2)
    say("main", f"elastic {elastic_s:.2f} s incl. dense preconditioner "
                f"({elastic_krylov} Krylov); 23 steps converged; chunk 2: "
                f"{ms_step:.1f} ms/step, {rows2[:, 0].mean():.2f} "
                f"fixed-point it/step, {rows2[:, 2].mean():.1f} Krylov "
                f"it/step; band launches {launches}; peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # 5. parity ------------------------------------------------------------ #
    e_el = rel_err(u_elastic, golden["u_elastic"])
    e_u = rel_err(u3, golden["u"])
    e_s = rel_err(sig3, golden["sig_v"])
    if not (e_el <= 1e-8 and e_u <= 1e-6 and e_s <= 1e-6):
        raise AssertionError(f"parity: elastic u {e_el:.2e}, u {e_u:.2e}, "
                             f"sig_v {e_s:.2e}")
    if not np.array_equal(rows3[:, 5], golden["rows"][:, 5]):
        raise AssertionError("converged flags differ from the golden")
    say("parity", f"vs JAX golden: elastic u {e_el:.2e} (<=1e-8), 3-step u "
                  f"{e_u:.2e}, sig_v {e_s:.2e} (<=1e-6 max|ref|); fixed-point "
                  f"it/step {rows3[:, 0].tolist()} vs golden "
                  f"{golden['rows'][:, 0].tolist()}")

    print(json.dumps({"kernels": [{
        "name": "band_matvec_f32", "route": "cuda",
        "source": "safeincave_torch/csrc/band_matvec.cu",
        "replaces": "safeincave_tpu/fem/bandkernel.py:74",
        "launches": launches, "max_abs_err": max_abs_err, "ms": ms,
        "plain_ms": plain_ms}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
