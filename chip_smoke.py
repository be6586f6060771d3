"""Smoke run of the PyTorch/CUDA port (safeincave_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is non-zero:

1. device  - the card (nvidia-smi name, power limit) and torch/CUDA versions.
2. build   - nvcc builds the band and block-DIA kernels from
             safeincave_torch/csrc/, one process each, in parallel.
3. kernel  - each kernel against its plain PyTorch twin on a random
             energy-symmetric tangent: the band matvec at cavern_proxy_600
             (2e-5 max|ref|), the f32 DIA matvec at the box path's nx=17 and
             at bench.py's matvec-scale nx=44 (1e-5 max|ref|); bitwise
             repeatability, energy symmetry, and the time of each over 200
             launches (CUDA events).  Also the f32 DIA assembly time.
4. main    - the cavern benchmark configuration through the port's API:
             band-reordered mesh, 4-mechanism material, supports and a 24 h
             sinusoidal pressure, precond "auto" (dense on CUDA), the band
             kernel auto-selected, fp32 phase off; elastic response, a 3-step
             chunk, then 2 chunks x 10 steps of solve_time_steps at
             dt = 3600 s.  Every step must converge and the band kernel must
             have been launched.
5. parity  - against tests/golden/torch_port_cavern600.npz (the JAX package
             on CPU, 2level preconditioner): elastic u at 1e-8 relative, u and
             sig_v after 3 steps at 1e-6 max|ref| (another preconditioner and
             f32 summation order under a 1e-8 fixed-point tolerance), and
             equal converged flags.
6. box     - bench.py's box configuration, GridBox(600, 600, 800, nx=17) in
             natural order, the same material and loads, precond and
             fp32_phase "auto": block-DIA with the structured assembly, the
             dense preconditioner and the f32 sweep must be selected; elastic
             response, a 3-step chunk and a 10-step chunk at dt = 3600 s.
             Every step must converge and the DIA kernel must have been
             launched.
7. box parity - against tests/golden/torch_port_box17.npz (JAX on CPU,
             enable_dia_matvec, 2level, fp32_phase=True): elastic u at 1e-8
             relative, u and sig_v after 3 steps at 1e-6 max|ref|, equal
             converged flags.

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
GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_{}.npz")
HOUR = 3600.0
KERNELS = ("band_matvec", "dia_matvec")


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


def random_ct(E, rng):
    """Random energy-symmetric tangent (E, 6, 6): A is then symmetric."""
    import numpy as np
    M = rng.normal(size=(E, 6, 6))
    CT = 0.5 * (M + np.transpose(M, (0, 2, 1))) + 8.0 * np.eye(6)
    w = np.diag([1.0, 1, 1, 2, 2, 2])
    return 0.5 * (CT + np.linalg.inv(w) @ np.transpose(CT, (0, 2, 1)) @ w)


def hold(name, kernel, plain, u, v, tol):
    """A kernel against its plain twin on the same inputs: max|err| within
    ``tol`` max|ref|, bitwise repeatable, u.Av == v.Au.  Returns (max_abs_err,
    max|ref|, symmetry, kernel ms, plain ms)."""
    import torch
    got = kernel(u)
    again = kernel(u)
    Av = kernel(v)
    torch.cuda.synchronize()
    ref = plain(u)
    max_abs_err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    if not max_abs_err <= tol * scale:
        raise AssertionError(f"{name} vs plain: max|err| {max_abs_err} > "
                             f"{tol} * {scale}")
    if not torch.equal(got, again):
        raise AssertionError(f"{name} is not bitwise repeatable")
    a = float((v.double() * got.double()).sum())
    b = float((u.double() * Av.double()).sum())
    if not abs(a - b) < 1e-3 * max(abs(a), 1.0):
        raise AssertionError(f"{name} energy symmetry: v.Au={a} u.Av={b}")
    return (max_abs_err, scale, abs(a - b) / abs(a), cuda_ms(lambda:
            kernel(u)), cuda_ms(lambda: plain(u)))


def run_chunks(eq, t_first, sizes):
    """solve_time_steps over consecutive chunks from ``t_first`` at 1 h;
    returns [(rows, seconds)]."""
    import torch
    out, t = [], t_first
    for n in sizes:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = eq.solve_time_steps([t + k * HOUR for k in range(n)],
                                   [HOUR] * n, tol=1e-8, maxiter=40)
        torch.cuda.synchronize()
        out.append((rows, time.perf_counter() - t0))
        t += n * HOUR
    return out


def parity(tag, golden, u_elastic, rows3, u3, sig3):
    """Fields against a JAX golden: elastic u at 1e-8, u and sig_v after 3
    steps at 1e-6 max|ref|, equal converged flags."""
    import numpy as np
    e_el = rel_err(u_elastic, golden["u_elastic"])
    e_u = rel_err(u3, golden["u"])
    e_s = rel_err(sig3, golden["sig_v"])
    if not (e_el <= 1e-8 and e_u <= 1e-6 and e_s <= 1e-6):
        raise AssertionError(f"{tag} parity: elastic u {e_el:.2e}, u "
                             f"{e_u:.2e}, sig_v {e_s:.2e}")
    if not np.array_equal(rows3[:, 5], golden["rows"][:, 5]):
        raise AssertionError(f"{tag}: converged flags differ from the golden")
    say(tag, f"vs JAX golden: elastic u {e_el:.2e} (<=1e-8), 3-step u "
             f"{e_u:.2e}, sig_v {e_s:.2e} (<=1e-6 max|ref|); fixed-point "
             f"it/step {rows3[:, 0].tolist()} vs golden "
             f"{golden['rows'][:, 0].tolist()}")


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
    from safeincave_torch.fem.dia import BlockDIA, dia_matvec_plain
    from safeincave_torch.fem.kernels import MomentumKernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    f32 = torch.float32

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
    _build.build(KERNELS)
    for name in KERNELS:
        _build.load(name)
    say("build", f"{', '.join(KERNELS)} built in parallel and loaded in "
                 f"{time.perf_counter() - t0:.2f} s (nvcc: " + ", ".join(
                     f"{n} {_build.build_seconds.get(n, 0.0):.2f} s"
                     for n in KERNELS) + ")")

    # 3. kernels vs plain at the main paths' shapes ------------------------ #
    rng = np.random.default_rng(0)
    grid = cfg.cavern600_grid(st)
    E, N = grid.n_elems, grid.n_nodes
    band = BandMatvec(MomentumKernel(grid, dev))
    ctv = band.pack_ct(torch.as_tensor(
        np.transpose(random_ct(E, rng), (1, 2, 0)), dtype=f32, device=dev))
    u, v = (torch.as_tensor(rng.normal(size=(N, 3)), dtype=f32, device=dev)
            for _ in range(2))
    band_err, scale, sym, band_ms, band_plain_ms = hold(
        "band kernel", lambda x: band.matvec(ctv, x),
        lambda x: band_matvec_plain(ctv, band.gN, band.conn, band.plan, x),
        u, v, 2e-5)
    say("kernel", f"band, cavern600 E={E} N={N}: max|err| {band_err:.3e} "
                  f"(max|ref| {scale:.3e}), bitwise repeatable, energy "
                  f"symmetry {sym:.1e}; kernel {band_ms:.4f} ms, plain "
                  f"{band_plain_ms:.4f} ms per matvec (200 launches)")

    dia_rows = []
    for nx in (17, 44):
        box = st.GridBox(Lx=600.0, Ly=600.0, Lz=800.0, nx=nx, ny=nx, nz=nx)
        dia = BlockDIA(MomentumKernel(box, dev))
        if not dia.structured:
            raise AssertionError(f"nx={nx}: box not recognised as structured")
        CT = torch.as_tensor(np.transpose(random_ct(box.n_elems, rng),
                                          (1, 2, 0)), dtype=f32, device=dev)
        vals = dia.assemble(CT)
        u, v = (torch.as_tensor(rng.normal(size=(box.n_nodes, 3)),
                                dtype=f32, device=dev) for _ in range(2))
        err, scale, sym, ms, plain_ms = hold(
            f"DIA kernel nx={nx}", lambda x: dia.matvec(vals, x),
            lambda x: dia_matvec_plain(vals, x, dia.offsets, box.n_nodes),
            u, v, 1e-5)
        asm_ms = cuda_ms(lambda: dia.assemble(CT), n=20, warmup=2)
        dia_rows.append(dict(nx=nx, E=box.n_elems, N=box.n_nodes, err=err,
                             ms=ms, plain_ms=plain_ms))
        say("kernel", f"DIA f32, box nx={nx} E={box.n_elems} "
                      f"N={box.n_nodes} Dn={dia.plan.Dn} planes "
                      f"{vals.numel() * 4 / 1e6:.1f} MB: max|err| {err:.3e} "
                      f"(max|ref| {scale:.3e}), bitwise repeatable, energy "
                      f"symmetry {sym:.1e}; kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms per matvec (200 launches); f32 "
                      f"assembly {asm_ms:.3f} ms (20 calls)")
        del box, dia, CT, vals

    # 4. cavern600 main path ------------------------------------------------ #
    golden = np.load(GOLDEN.format("cavern600"))
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
    chunks = run_chunks(eq, 4 * HOUR, (10, 10))
    launches = eq.kernel.band.launches
    all_rows = np.concatenate([rows3] + [r for r, _ in chunks])
    if not (all_rows[:, 5] == 1).all():
        raise AssertionError(f"non-converged steps: {all_rows[:, [0, 1, 5]]}")
    if launches <= 0:
        raise AssertionError("the main path never launched the band kernel")
    rows2, secs2 = chunks[1]
    say("main", f"elastic {elastic_s:.2f} s incl. dense preconditioner "
                f"({elastic_krylov} Krylov); 23 steps converged; chunk 2: "
                f"{1e3 * secs2 / len(rows2):.1f} ms/step, "
                f"{rows2[:, 0].mean():.2f} fixed-point it/step, "
                f"{rows2[:, 2].mean():.1f} Krylov it/step; band launches "
                f"{launches}; peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # 5. cavern600 parity --------------------------------------------------- #
    parity("parity", golden, u_elastic, rows3, u3, sig3)
    del eq, P

    # 6. box path: block-DIA, dense preconditioner, f32 sweep -------------- #
    golden = np.load(GOLDEN.format("box17"))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    box = cfg.box17_grid(st)
    eq = cfg.wire_bench(st, box, precond="auto", fp32_phase="auto")
    dia = eq.kernel.dia
    if dia is None or not dia.structured:
        raise AssertionError("block-DIA with the structured assembly not "
                             "auto-selected on CUDA")
    if not eq.solver.fp32_enabled(eq.device):
        raise AssertionError("fp32_phase 'auto' did not enable the f32 sweep")
    dia.launches = 0
    cfg.elastic_init(eq)
    torch.cuda.synchronize()
    elastic_s = time.perf_counter() - t0
    P, _ = eq._get_precond()
    nb = box.n_nodes
    if not (len(P) == 1 and tuple(P[0].shape) == (3 * nb, 3 * nb)):
        raise AssertionError("precond 'auto' did not resolve to dense")
    u_elastic = eq.u.cpu().numpy()
    elastic_krylov = eq.solver_stats[0]
    eq.fp32_accepted = 0
    ((rows3, _),) = run_chunks(eq, HOUR, (3,))
    u3, sig3 = eq.u.cpu().numpy(), eq.sig_v.cpu().numpy()
    ((rows10, secs10),) = run_chunks(eq, 4 * HOUR, (10,))
    launches_box = dia.launches
    all_rows = np.concatenate([rows3, rows10])
    if not (all_rows[:, 5] == 1).all():
        raise AssertionError(f"box: non-converged steps: "
                             f"{all_rows[:, [0, 1, 5]]}")
    if launches_box <= 0:
        raise AssertionError("the box path never launched the DIA kernel")
    say("box", f"GridBox nx=17 E={box.n_elems} N={nb} DOFs={3 * nb}: "
               f"elastic {elastic_s:.2f} s incl. dense preconditioner "
               f"({elastic_krylov} Krylov); 13 steps converged; 10-step "
               f"chunk: {1e3 * secs10 / len(rows10):.1f} ms/step, "
               f"{rows10[:, 0].mean():.2f} fixed-point it/step, "
               f"{rows10[:, 2].mean():.1f} Krylov it/step; f32 sweeps "
               f"accepted {eq.fp32_accepted}/13 steps; DIA launches "
               f"{launches_box}; peak device memory "
               f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # 7. box parity -------------------------------------------------------- #
    parity("box parity", golden, u_elastic, rows3, u3, sig3)

    print(json.dumps({"kernels": [dict(
        name="band_matvec_f32", route="cuda",
        source="safeincave_torch/csrc/band_matvec.cu",
        replaces="safeincave_tpu/fem/bandkernel.py:74", launches=launches,
        max_abs_err=band_err, ms=band_ms, plain_ms=band_plain_ms)] + [dict(
            name=f"dia_matvec_f32 (box nx={r['nx']}, E={r['E']}, "
                 f"N={r['N']})", route="cuda",
            source="safeincave_torch/csrc/dia_matvec.cu",
            replaces="safeincave_tpu/fem/dia.py:301", launches=launches_box,
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"])
            for r in dia_rows]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
