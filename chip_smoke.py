"""Smoke run of the PyTorch/CUDA port (safeincave_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is non-zero:

1. device  - the card (nvidia-smi name, power limit) and torch/CUDA versions.
2. build   - nvcc builds the band and block-DIA kernels from
             safeincave_torch/csrc/, one process each, in parallel.
3. kernel  - each kernel against its plain PyTorch twin on a random
             energy-symmetric tangent, at every shape it is measured at:
             the band matvec at cavern_proxy_600 (the main path) and at the
             band-ordered GridBox nx=44 (bench.py's scale size), 2e-5
             max|ref|; the f32 DIA matvec at the box path's nx=17 and at
             nx=44, 1e-5 max|ref|, and the f64 DIA matvec at nx=17, 1e-12.
             Bitwise repeatability and energy symmetry.  Per kernel and
             shape: ``ms`` (the wrapper call, CUDA events over 200 calls),
             ``device_ms`` (the kernels' own time per call, torch.profiler,
             the L2 cache flushed by a 128 MB read before each call, as
             the Krylov loop's preconditioner gemv leaves it;
             ``device_ms_warm`` back to back), ``bound_ms`` (the bytes the
             function needs over 3.35 TB/s; its operations are far fewer)
             and ``pct_of_bound``, ``plain_ms``, and ``library_ms``: a
             cuSPARSE CSR SpMV (``torch.sparse_csr_tensor @ u``) of the
             same operator, assembled once outside the timed window and
             held against the plain twin too.  ``launches`` and
             ``launches_per_step`` come from phases 4 and 6.  Also the f32
             DIA assembly time.  The phase runs in a child process (the
             ``--tree`` mode below): once started, torch.profiler leaves a
             cost on every later launch of its process.
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
8. sim     - examples/mechanics/4_cavern's workflow through the port's
             ``Simulator_M`` on the band-ordered cavern600 mesh
             (``torch_port_configs.cavern_example``: Spring + creep,
             gravity, rollers, overburden and cavern pressure; precond
             "auto" -> dense, band kernel, fp32 phase off).  Stage 1,
             equilibrium 24 h at 2 h with u and p_elems saved every step
             (the per-step flow); stage 2, operation 48 h at 1 h with u,
             p_elems and q_elems saved every 6 steps (fused chunks),
             StepMetrics to a file and a checkpoint every 12 steps.  The
             outputs are ``SaveFields`` when h5py imports, else an in-memory
             sink of the same protocol (``MemorySink``); either way the
             saves must land at the expected times.  Every step converged,
             the band kernel launched in each stage, final fields within
             1e-6 max|ref| of tests/golden/torch_port_sim_cavern600.npz,
             equal converged flags, fixed-point counts within +-1; the
             smoother repeats bitwise; the last checkpoint, loaded into a
             fresh equation, runs 2 more steps to the straight run's state
             bit for bit.  Prints ms/step per stage, the driver's share of
             stage 2 (time outside ``solve_time_steps``), band launches per
             step and one checkpoint's save time.
9. json    - the JSON driver: ``safeincave_torch.app.sim_cli.main`` in a
             child process on the card (``--json-child``), on
             ``torch_port_configs.box_case`` over ``box_mesh(600, 600, 800,
             nx=17)`` written with the port's ``write_msh`` (natural order:
             block-DIA auto-selected, dense preconditioner, f32 sweep on).
             The child swaps in ``MemorySink`` for ``SaveFields`` when h5py
             is missing and prints its DIA launch count on its last line.
             Exit 0, DIA launched, operation-stage u and p_elems within
             1e-6 max|ref| of tests/golden/torch_port_json_box17.npz.
10. tm     - bench.py's thermo-mechanical configuration
             (``torch_port_configs.wire_tm``: Spring, Kelvin-Voigt,
             dislocation and pressure-solution creep, ``Thermoelastic``; a
             Dirichlet ramp on TOP and a Robin wall on "Cavern" for the heat
             equation, mixed-precision CG at rtol 1e-12) through
             ``Simulator_TM`` on the band-ordered cavern600 mesh: 24 steps
             at 1 h in fused chunks, u and T saved every 6 steps, a
             checkpoint with the heat keys at step 12.  Every step
             converged, the band kernel launched, final u, sig_v and T
             within 1e-6 max|ref| of
             tests/golden/torch_port_tm_cavern600.npz, fixed-point counts
             within +-1, the heat step repeats bitwise, and the checkpoint
             loaded into fresh equations runs steps 13-24 to the straight
             run's u, sig_v, T and states bit for bit.  Six steps of
             ``Simulator_T`` on the same heat equation, T within 1e-8 of
             tests/golden/torch_port_t_cavern600.npz.  Prints ms/step, the
             heat step's share, heat CG and Krylov iterations and band
             launches per step.
11. tm_box - bare ``solve_tm_time_steps`` on GridBox(600, 600, 800, nx=17)
             in natural order with the same material, Dirichlet TOP and
             Robin BOTTOM, precond and fp32_phase "auto" (block-DIA, dense
             preconditioner, the f32 sweep carrying the thermal strain): 8
             steps (a chunk of 3, then 5) converged, the DIA kernel launched, u, sig_v and T within
             1e-6 max|ref| of tests/golden/torch_port_tm_box17.npz.  Prints
             the same per-step numbers and the sweeps the gate accepted.

The last lines are the kernel JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``.  There is no CPU fallback: without a CUDA
device the script exits non-zero before printing any result.

    python3 chip_smoke.py --tree DIR

runs phase 3 alone on the ``safeincave_torch`` package of another checkout
(DIR holds its ``safeincave_torch/`` and ``tests/``), to time two designs of
the kernels in turns within one call; it prints the kernel JSON and the
card, and no ``ok`` line.

    python3 chip_smoke.py --phase tm|tm_box

builds the kernels and runs phase 10 or 11 alone (no ``ok`` line).
"""
import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_{}.npz")
HOUR = 3600.0
KERNELS = ("band_matvec", "dia_matvec")
# H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12               # float32 outside the tensor cores
BAND = dict(name="band_matvec_f32", route="cuda",
            source="safeincave_torch/csrc/band_matvec.cu",
            replaces="safeincave_tpu/fem/bandkernel.py:74")
DIA = dict(name="dia_matvec_f32", route="cuda",
           source="safeincave_torch/csrc/dia_matvec.cu",
           replaces="safeincave_tpu/fem/dia.py:301")


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


def short_name(kernel):
    """A profiler kernel key without return type, namespaces, template
    arguments and parameters: 'csrmv_v3_kernel'."""
    name = kernel.replace("(anonymous namespace)::", "").split("(")[0]
    return name.split("<")[0].split("::")[-1].strip().split(" ")[-1]


def graph_ms(fn, before=None, n=100):
    """ms per call of fn, each after ``before``, replayed from a CUDA graph
    of n calls, less the same graph of ``before`` alone: device time
    without the host's launch path."""
    import torch

    def replay_ms(body):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body()                          # warm-up outside the capture
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                body()
        return cuda_ms(graph.replay, n=3, warmup=1) / n

    if before is None:
        return replay_ms(fn)

    def both():
        before()
        fn()
    return replay_ms(both) - replay_ms(before)


class DeviceTimer:
    """The device time of the kernels one call launches, per call, from
    torch.profiler: each kernel's self CUDA time per launch (every kernel
    here launches once per call), summed over the kernels in the window but
    the L2 flush's.  The profiler now and then hands back no CUDA event at
    all: it is asked three times, and then the time comes from
    :func:`graph_ms`."""

    def __init__(self):
        import torch
        # reading 128 MB (> the 50 MB L2) leaves the cache full of clean
        # lines, as the preconditioner's gemv leaves it in the Krylov loop;
        # a written buffer would leave dirty lines whose write-back the next
        # kernel would pay for
        buf = torch.ones(2 ** 25, device="cuda")
        self.flush = buf.sum
        us = self._kernel_us(self.flush, 10)
        self.flush_keys = set(us)
        # the flush's own read rate: what a streaming read reaches here
        flush_ms = sum(t / k for t, k in us.values()) / 1e3 if us else \
            graph_ms(self.flush)
        self.read_tbps = buf.numel() * 4 / (flush_ms * 1e-3) / 1e12

    @staticmethod
    def _kernel_us(fn, n, before=None):
        """{kernel name: (device us, launches)} over n calls of fn, each
        after ``before``; {} when the profiler recorded no CUDA event."""
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        for _ in range(3):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    if before is not None:
                        before()
                    fn()
                torch.cuda.synchronize()
            out = {}
            for ev in prof.key_averages():
                if ev.device_type != DeviceType.CUDA:
                    continue
                us = getattr(ev, "self_device_time_total", None)
                if us is None:
                    us = ev.self_cuda_time_total
                t, k = out.get(ev.key, (0.0, 0))
                out[ev.key] = (t + us, k + ev.count)
            if out:
                return out
        return {}

    def ms(self, fn, n=100, cold=True):
        """(ms per call, {kernel name: ms per launch}, source); ``cold``
        flushes the L2 cache before each call."""
        fn()
        before = self.flush if cold else None
        us = self._kernel_us(fn, n, before) if self.flush_keys else {}
        per = {}
        for k, (t, count) in us.items():
            if k not in self.flush_keys:
                name = short_name(k)
                per[name] = per.get(name, 0.0) + t / count / 1e3
        if sum(per.values()) > 0:
            return sum(per.values()), per, "torch.profiler"
        return graph_ms(fn, before, n), {}, "cuda graph"


def rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def random_ct(E, rng):
    """Random energy-symmetric tangent (E, 6, 6): A is then symmetric."""
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


def to_csr(row, col, val, n):
    """f32 CSR with int32 indices (cuSPARSE's SpMV operand) of the COO
    entries; duplicates are summed."""
    import warnings
    import torch
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # "CSR is in beta"
        A = torch.sparse_coo_tensor(torch.stack([row, col]), val, (n, n),
                                    check_invariants=False)
        A = A.coalesce().to_sparse_csr()
        return torch.sparse_csr_tensor(
            A.crow_indices().int(), A.col_indices().int(),
            A.values().to(torch.float32), (n, n), check_invariants=False)


def csr_from_element_rows(rows, conn, n_nodes):
    """The assembled operator of element block rows (16E, 9) (fem/blockell
    ``element_block_rows``: row (4a + b) E + e, column 3i + j)."""
    import torch
    E, dev = conn.shape[0], rows.device
    r = torch.arange(16 * E, device=dev)
    ab, e = r // E, r % E
    ni, nj = conn[e, ab // 4], conn[e, ab % 4]
    k = torch.arange(9, device=dev)
    return to_csr((3 * ni[:, None] + k // 3).reshape(-1),
                  (3 * nj[:, None] + k % 3).reshape(-1), rows.reshape(-1),
                  3 * n_nodes)


def csr_from_planes(vals, dia):
    """The assembled operator of block-DIA planes: the 9 entries of every
    node pair that exists (the true nonzeros; other slots are padding)."""
    import torch
    N, dev = dia.n_nodes, vals.device
    slot = torch.as_tensor(np.unique(dia.plan.row_slot).astype(np.int64),
                           device=dev)
    d, i = slot // N, slot % N
    j = i + torch.as_tensor(dia.plan.offsets, device=dev)[d]
    k = torch.arange(9, device=dev)
    return to_csr((3 * i[:, None] + k // 3).reshape(-1),
                  (3 * j[:, None] + k % 3).reshape(-1),
                  vals[9 * d[:, None] + k, i[:, None]].reshape(-1), 3 * N)


def wrapper_call(op, data):
    """The call a solver makes: ``op.operator(data)`` once per linear solve
    (its checks), then one call per matvec; ``op.matvec(data, u)`` for a
    tree whose wrappers have no ``operator``."""
    if hasattr(op, "operator"):
        return op.operator(data)
    return lambda x: op.matvec(data, x)


def fmt(per):
    """'name ms, ...' of a {kernel name: ms} dict."""
    return ", ".join(f"{k} {ms:.4f}" for k, ms in per.items())


def measure(timer, what, shape, kernel, plain, A, u, v, tol, nbytes, flops):
    """One kernel at one shape: held against its plain twin and timed, the
    cuSPARSE SpMV of the same operator held and timed beside it."""
    err, scale, sym, ms, plain_ms = hold(f"{what['name']} {shape}", kernel,
                                         plain, u, v, tol)
    x = u.reshape(-1)
    lib_err = (A @ x - plain(u).reshape(-1)).abs().max().item()
    if not lib_err <= tol * scale:
        raise AssertionError(f"cuSPARSE operator at {shape} differs from "
                             f"the plain twin: {lib_err} > {tol} * {scale}")
    device_ms, per, source = timer.ms(lambda: kernel(u))
    warm_ms, _, _ = timer.ms(lambda: kernel(u), cold=False)
    try:
        lib_device_ms, lib_per, _ = timer.ms(lambda: A @ x)
    except RuntimeError:        # a graph capture that cuSPARSE refused
        lib_device_ms, lib_per = None, {}
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    row = dict(what, shape=shape, max_abs_err=err, max_ref=scale,
               energy_symmetry=sym, ms=ms, device_ms=device_ms,
               device_ms_warm=warm_ms, device_ms_from=source,
               bound_ms=1e3 * max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bound_bytes=nbytes, plain_ms=plain_ms,
               library_ms=cuda_ms(lambda: A @ x),
               library_device_ms=lib_device_ms, device_kernels=per,
               library_kernels=lib_per)
    row["pct_of_bound"] = 100.0 * row["bound_ms"] / device_ms
    say("kernel", f"{what['name']} {shape}: max|err| {err:.3e} (max|ref| "
                  f"{scale:.3e}), bitwise repeatable, energy symmetry "
                  f"{sym:.1e}; wrapper {ms:.4f} ms, device {device_ms:.4f} "
                  f"ms cold / {warm_ms:.4f} warm ({source}: {fmt(per)}), "
                  f"bound {row['bound_ms']:.4f} ms ({nbytes / 1e6:.2f} MB), "
                  f"{row['pct_of_bound']:.1f}% of bound; plain "
                  f"{plain_ms:.4f} ms; cuSPARSE {row['library_ms']:.4f} ms, "
                  f"device {lib_device_ms} ms ({fmt(lib_per)})")
    return row


def kernel_phase(st, cfg, dev):
    """Phase 3: every kernel at every shape; returns the kernel rows."""
    import torch
    from safeincave_torch.fem.bandkernel import BandMatvec, band_matvec_plain
    from safeincave_torch.fem.blockell import element_block_rows
    from safeincave_torch.fem.dia import BlockDIA, dia_matvec_plain
    from safeincave_torch.fem.kernels import MomentumKernel
    from safeincave_torch.mesh.reorder import reordered_grid
    f32, f64 = torch.float32, torch.float64
    rng = np.random.default_rng(0)
    timer = DeviceTimer()
    say("kernel", f"a streaming read (torch sum over 128 MB, the L2 flush) "
                  f"runs at {timer.read_tbps:.2f} TB/s here, "
                  f"{100 * timer.read_tbps * 1e12 / HBM_BYTES_PER_S:.1f}% of "
                  f"the 3.35 TB/s bound")
    rows = []

    def box(nx):
        return st.GridBox(Lx=600.0, Ly=600.0, Lz=800.0, nx=nx, ny=nx, nz=nx)

    def ct(E, dtype):
        return torch.as_tensor(np.transpose(random_ct(E, rng), (1, 2, 0)),
                               dtype=dtype, device=dev)

    def vecs(N, dtype):
        return [torch.as_tensor(rng.normal(size=(N, 3)), dtype=dtype,
                                device=dev) for _ in range(2)]

    for shape, grid in (("cavern600", cfg.cavern600_grid(st)),
                        ("box nx=44 band order",
                         reordered_grid(box(44), "band")[0])):
        E, N = grid.n_elems, grid.n_nodes
        kern = MomentumKernel(grid, dev)
        band = BandMatvec(kern)
        CT = ct(E, f32)
        ctv = band.pack_ct(CT)
        gN, vol = kern.geom(f64)
        A = csr_from_element_rows(element_block_rows(CT.double(), gN, vol),
                                  kern.conn, N)
        rows.append(measure(
            timer, BAND, f"{shape} (E={E}, N={N})", wrapper_call(band, ctv),
            lambda x: band_matvec_plain(ctv, band.gN, band.conn, band.plan,
                                        x),
            A, *vecs(N, f32), 2e-5, (48 * 4 + 4 * 4) * E + 2 * 12 * N,
            228 * E))
        del kern, band, CT, ctv, A

    for nx in (17, 44):
        g = box(nx)
        N = g.n_nodes
        dia = BlockDIA(MomentumKernel(g, dev))
        if not dia.structured:
            raise AssertionError(f"nx={nx}: box not recognised as structured")
        CT = ct(g.n_elems, f32)
        vals = dia.assemble(CT)
        nz = 9 * dia.plan.n_pairs
        rows.append(measure(
            timer, DIA, f"box nx={nx} (E={g.n_elems}, N={N}, "
            f"Dn={dia.plan.Dn})", wrapper_call(dia, vals),
            lambda x: dia_matvec_plain(vals, x, dia.offsets, N),
            csr_from_planes(vals, dia), *vecs(N, f32), 1e-5,
            4 * nz + 2 * 12 * N, 2 * nz))
        asm_ms = cuda_ms(lambda: dia.assemble(CT), n=20, warmup=2)
        say("kernel", f"f32 DIA assembly, nx={nx}: {asm_ms:.3f} ms (20 "
                      f"calls)")
        if nx == 17:
            vals64 = dia.assemble(CT.double())
            err, scale, sym, ms, plain_ms = hold(
                "f64 DIA kernel", wrapper_call(dia, vals64),
                lambda x: dia_matvec_plain(vals64, x, dia.offsets, N),
                *vecs(N, f64), 1e-12)
            say("kernel", f"dia_matvec_f64 box nx=17: max|err| {err:.3e} "
                          f"(max|ref| {scale:.3e}), bitwise repeatable, "
                          f"energy symmetry {sym:.1e}; wrapper {ms:.4f} ms, "
                          f"plain {plain_ms:.4f} ms")
            del vals64
        del g, dia, CT, vals
    return rows


def kernel_phase_child(tree):
    """Phase 3 in a child process (``--tree``), its kernel lines echoed:
    torch.profiler, once started, leaves a cost on every later launch of
    its process, which the main paths' steps would pay."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--tree", tree], capture_output=True, text=True,
                          timeout=900)
    lines = proc.stdout.splitlines()
    for line in lines:
        if line.startswith("[kernel]"):
            print(line, flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"phase 3 failed:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    return json.loads(next(ln for ln in lines
                           if ln.startswith('{"tree"')))["kernels"]


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


class MemorySink:
    """``SaveFields``' protocol in memory, for a machine without h5py:
    ``saved`` holds (t, {field: host array}) at exactly the calls that
    SaveFields would write."""

    def __init__(self, eq, save_every: int = 1):
        self.eq = eq
        self.save_every = save_every
        self.fields = []
        self.saved = []
        self._calls = 0

    def set_output_folder(self, folder):
        pass

    def add_output_field(self, name, label):
        self.fields.append((name, label))

    def initialize(self):
        pass

    def calls_until_next_keep(self):
        j = (1 - self._calls) % self.save_every
        return j if j else self.save_every

    def skip_calls(self, k):
        if k >= self.calls_until_next_keep():
            raise AssertionError("fused chunk crossed a save boundary")
        self._calls += k

    def save_fields(self, t):
        keep = self._calls % self.save_every == 0
        self._calls += 1
        if keep:
            self.saved.append((float(t), {
                f: getattr(self.eq, f).detach().cpu().numpy()
                for f, _ in self.fields}))

    def save_mesh(self):
        pass


def have_h5py():
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def saved_times(out, st):
    """Times of the saves an output made: SaveFields read back through
    the port's postproc, or a MemorySink's record."""
    if isinstance(out, MemorySink):
        return [t for t, _ in out.saved]
    t, _, _, _ = st.PostProcessingTools.read_timeseries(
        out.output_folder, out.fields[0][0])
    return list(t)


def within(tag, got, ref, tol):
    err = rel_err(got, ref)
    if not err <= tol:
        raise AssertionError(f"{tag}: {err:.3e} > {tol} max|ref|")
    return err


def sim_phase(st, cfg, dev, tmp):
    """Phase 8; returns (band launches, launches per step) over both
    stages."""
    import torch
    golden = np.load(GOLDEN.format("sim_cavern600"))
    sink = "SaveFields (h5py)" if have_h5py() else "MemorySink (no h5py)"
    eq = cfg.cavern_example(st, dev, precond="auto")
    band = eq.kernel.band
    if band is None:
        raise AssertionError("sim: band kernel not auto-selected on CUDA")
    ck = os.path.join(tmp, "sim_checkpoint.npz")
    stages = (("eq", "equilibrium", ("u", "p_elems"), 1, 12, {}),
              ("op", "operation", ("u", "p_elems", "q_elems"), 6, 48,
               dict(checkpoint_every=12, checkpoint_path=ck)))
    total_launches, total_steps, notes = 0, 0, []
    for prefix, stage, fields, every, n_steps, extra in stages:
        out = (st.SaveFields if have_h5py() else MemorySink)(
            eq, save_every=every)
        out.set_output_folder(os.path.join(tmp, "sim", stage))
        for f in fields:
            out.add_output_field(f, f)
        metrics = st.StepMetrics(os.path.join(tmp, f"sim_{stage}.jsonl"))
        screen = io.StringIO()
        torch.cuda.synchronize()
        band.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(screen):
            tc = cfg.run_cavern_stage(st, eq, stage, [out], metrics=metrics,
                                      **extra)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = band.launches
        n_rows = sum(1 for ln in screen.getvalue().splitlines()
                     if ln.split("|")[0].strip().isdigit())
        if n_rows != n_steps:
            raise AssertionError(f"sim {stage}: {n_rows} screen rows")
        rec = cfg.stage_record(eq, metrics)
        rows, ref_rows = rec["rows"], golden[f"{prefix}_rows"]
        if not (len(rows) == n_steps and (rows[:, 2] == 1).all()):
            raise AssertionError(f"sim {stage}: steps {rows.tolist()}")
        if launches <= 0:
            raise AssertionError(f"sim {stage}: band kernel never launched")
        if not np.array_equal(rows[:, 2], ref_rows[:, 2]):
            raise AssertionError(f"sim {stage}: converged flags differ")
        d_it = int(np.abs(rows[:, 0] - ref_rows[:, 0]).max())
        if d_it > 1:
            raise AssertionError(f"sim {stage}: fixed-point counts "
                                 f"{rows[:, 0].tolist()} vs golden "
                                 f"{ref_rows[:, 0].tolist()}")
        errs = {f: within(f"sim {stage} {f}", rec[f], golden[f"{prefix}_{f}"],
                          1e-6) for f in fields}
        want = [k * tc.dt for k in range(0, n_steps + 1, every)]
        if not np.allclose(saved_times(out, st), want, rtol=0, atol=1e-6):
            raise AssertionError(f"sim {stage}: saves at "
                                 f"{saved_times(out, st)}, want {want}")
        walls = [r["wall_s"] for r in metrics.records]
        if prefix == "eq":
            steps_ms = 1e3 * float(np.mean(walls[1:]))
            detail = (f"{steps_ms:.1f} ms/step over steps 2-{n_steps} "
                      f"(per-step flow, StepMetrics wall)")
        else:
            solve_ms = 1e3 * sum(walls) / n_steps
            steps_ms = 1e3 * secs / n_steps
            detail = (f"{steps_ms:.1f} ms/step in the stage, of which "
                      f"{solve_ms:.1f} in solve_time_steps and "
                      f"{steps_ms - solve_ms:.1f} in the driver (fused "
                      f"chunks, saves, smoothing, metrics, checkpoints); "
                      f"{1e3 * float(np.mean(walls[every:])):.1f} ms/step "
                      f"in solve_time_steps after the first chunk (which "
                      f"builds the preconditioner)")
        notes.append(steps_ms)
        say("sim", f"{stage}: {n_steps} steps converged in {secs:.2f} s "
                   f"(preconditioner build included; {n_rows} screen rows, "
                   f"the transcript not echoed); {detail}; {rows[:, 0].mean():.2f} fixed-point it/step, "
                   f"max |it - golden| {d_it}; band launches {launches}, "
                   f"{launches / n_steps:.1f} per step; vs golden "
                   + ", ".join(f"{f} {e:.2e}" for f, e in errs.items())
                   + f" (<=1e-6 max|ref|); {len(want)} saves at the expected "
                   f"times; sink {sink}")
        total_launches += launches
        total_steps += n_steps

    p_elems = eq.p_elems.clone()
    for _ in range(2):
        eq.compute_p_elems()
        if not torch.equal(eq.p_elems, p_elems):
            raise AssertionError("sim: smoothing p_elems is not bitwise "
                                 "repeatable")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st.save_checkpoint(os.path.join(tmp, "timed.npz"), eq, tc)
    ck_ms = 1e3 * (time.perf_counter() - t0)

    # resume: the last checkpoint in a fresh equation vs the straight run
    fresh = cfg.cavern_example(st, dev, precond="auto")
    cfg.cavern_stage_bcs(st, fresh, "operation", tc.t_final)
    for eq_r in (eq, fresh):
        tc_r = st.TimeController(dt=1.0, initial_time=0.0,
                                 final_time=50.0, time_unit="hour")
        if eq_r is fresh:
            st.load_checkpoint(ck, fresh, tc_r)
        else:
            tc_r.t, tc_r.step_counter = tc.t, tc.step_counter
        if tc_r.step_counter != 48:
            raise AssertionError(f"sim: resume from step {tc_r.step_counter}")
        with contextlib.redirect_stdout(io.StringIO()):
            st.Simulator_M(eq_r, tc_r, [],
                           compute_elastic_response=False).run()
    for name in ("u", "sig_v", "eps_tot_v"):
        if not torch.equal(getattr(eq, name), getattr(fresh, name)):
            raise AssertionError(f"sim: resumed {name} differs from the "
                                 f"straight run")
    for a, b in zip(eq.mat.elems_ne, fresh.mat.elems_ne):
        for k, v in a.state.items():
            if not torch.equal(v, b.state[k]):
                raise AssertionError(f"sim: resumed state {k} differs")
    say("sim", f"smoothing repeats bitwise; checkpoint save {ck_ms:.1f} ms; "
               f"step-48 checkpoint + 2 steps in a fresh equation equals "
               f"the straight run bit for bit (u, sig_v, eps_tot_v, states)")
    return total_launches, total_launches / total_steps, notes


class CheckpointSink(MemorySink):
    """An output that saves nothing but writes one checkpoint, heat field
    included, at its ``save_every``-th step; as an output it also makes the
    fused chunks end on that step."""

    def __init__(self, st, path, eq, heat, tc, save_every):
        super().__init__(eq, save_every)
        self.st, self.path, self.heat, self.tc = st, path, heat, tc

    def save_fields(self, t):
        if self._calls == self.save_every:
            self.st.save_checkpoint(self.path, self.eq, self.tc,
                                    heat_eq=self.heat)
        self._calls += 1


@contextlib.contextmanager
def recorded_tm_chunks(st, chunks, kernel):
    """While active, every ``solve_tm_time_steps`` call appends (rows,
    seconds, launches of ``kernel``) to ``chunks``.  The method is wrapped
    on the class: ``Simulator_TM`` takes single steps with an equation
    whose instance overrides it."""
    import torch
    real = st.LinearMomentum.solve_tm_time_steps

    def recording(self, *args, **kw):
        torch.cuda.synchronize()
        n0, t0 = kernel.launches, time.perf_counter()
        rows = real(self, *args, **kw)
        torch.cuda.synchronize()
        chunks.append((rows, time.perf_counter() - t0, kernel.launches - n0))
        return rows
    st.LinearMomentum.solve_tm_time_steps = recording
    try:
        yield
    finally:
        st.LinearMomentum.solve_tm_time_steps = real


def time_heat_steps(heat, seconds):
    """Wrap ``heat.step`` so that each call's host time, between two device
    synchronisations, is appended to ``seconds``."""
    import torch
    real = heat.step

    def step(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*args)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out
    heat.step = step


def tm_summary(chunks, heat_secs):
    """ms/step, the heat step's share and the iteration counts of coupled
    chunks [(rows, seconds)], rows [heat_iters, heat_res, fp_iters, error,
    krylov_total, converged]; ``heat_secs`` holds one time per step.  The
    first chunk is reported apart from the rest: in a process that has not
    run a step yet (``--phase``) it pays the first use of every operation,
    seconds in all."""
    rows = np.concatenate([r for r, _ in chunks])
    n0 = len(chunks[0][0])
    rest = sum(s for _, s in chunks[1:])
    n = len(rows) - n0
    return (f"{1e3 * chunks[0][1] / n0:.1f} ms/step in the first chunk of "
            f"{n0}, {1e3 * rest / n:.1f} ms/step in solve_tm_time_steps "
            f"after it, of which the heat step "
            f"{1e3 * sum(heat_secs[n0:]) / n:.1f} "
            f"({100 * sum(heat_secs[n0:]) / rest:.0f}%); per step "
            f"{rows[:, 0].mean():.1f} heat CG it, {rows[:, 2].mean():.2f} "
            f"fixed-point it, {rows[:, 4].mean():.1f} Krylov it")


def assert_same_state(tag, eq, heat, eq_ref, heat_ref):
    import torch
    for obj, ref, names in ((eq, eq_ref, ("u", "sig_v", "eps_tot_v", "Temp",
                                          "T0")),
                            (heat, heat_ref, ("T", "T_old"))):
        for name in names:
            if not torch.equal(getattr(obj, name), getattr(ref, name)):
                raise AssertionError(f"{tag}: resumed {name} differs from "
                                     f"the straight run")
    for a, b in zip(eq.mat.elems_ne, eq_ref.mat.elems_ne):
        for k, v in a.state.items():
            if not torch.equal(v, b.state[k]):
                raise AssertionError(f"{tag}: resumed state {a.name}.{k} "
                                     f"differs")


def tm_phase(st, cfg, tmp):
    """Phase 10; returns (band launches, launches per step)."""
    import torch
    golden = np.load(GOLDEN.format("tm_cavern600"))
    n_steps, every = 24, 6
    Sink = st.SaveFields if have_h5py() else MemorySink
    eq, heat = cfg.wire_tm(st, cfg.cavern600_grid(st), "Cavern",
                           precond="auto")
    band = eq.kernel.band
    if band is None:
        raise AssertionError("tm: band kernel not auto-selected on CUDA")
    tc = st.TimeController(dt=1.0, initial_time=0.0,
                           final_time=float(n_steps), time_unit="hour")
    outs = []
    for obj, field in ((eq, "u"), (heat, "T")):
        out = Sink(obj, save_every=every)
        out.set_output_folder(os.path.join(tmp, "tm", field))
        out.add_output_field(field, field)
        outs.append(out)
    ck = os.path.join(tmp, "tm_checkpoint.npz")
    outs.append(CheckpointSink(st, ck, eq, heat, tc, 12))
    chunks, heat_secs = [], []
    time_heat_steps(heat, heat_secs)
    torch.cuda.synchronize()
    band.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), \
            recorded_tm_chunks(st, chunks, band):
        sim = st.Simulator_TM(eq, heat, tc, outs)
        sim.run()
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    launches = band.launches
    P, _ = eq._get_precond()
    if not (len(P) == 1 and P[0].shape[0] == 3 * eq.grid.n_nodes):
        raise AssertionError("tm: precond 'auto' did not resolve to dense")
    rows = np.concatenate([r for r, _, _ in chunks])
    screen = cfg.screen_rows(sim.screen.lines)
    if not (len(rows) == len(screen) == n_steps and (rows[:, 5] == 1).all()):
        raise AssertionError(f"tm: {len(screen)} screen rows, steps "
                             f"{rows[:, [2, 3, 5]].tolist()}")
    if [len(r) for r, _, _ in chunks] != [every] * (n_steps // every):
        raise AssertionError(f"tm: chunks of "
                             f"{[len(r) for r, _, _ in chunks]} steps")
    if launches <= 0:
        raise AssertionError("tm: the band kernel never launched")
    d_it = int(np.abs(rows[:, 2] - golden["rows"][:, 0]).max())
    if d_it > 1:
        raise AssertionError(f"tm: fixed-point counts {rows[:, 2].tolist()} "
                             f"vs golden {golden['rows'][:, 0].tolist()}")
    errs = {k: within(f"tm {k}", v.cpu().numpy(), golden[k], 1e-6)
            for k, v in (("u", eq.u), ("sig_v", eq.sig_v), ("T", heat.T))}
    want = [k * HOUR for k in range(0, n_steps + 1, every)]
    for out in outs[:2]:
        if not np.allclose(saved_times(out, st), want, rtol=0, atol=1e-6):
            raise AssertionError(f"tm: {out.fields[0][0]} saved at "
                                 f"{saved_times(out, st)}, want {want}")
    step_launches = sum(n for _, _, n in chunks)
    say("tm", f"Simulator_TM on cavern600 (E={eq.n_elems}, "
              f"N={eq.grid.n_nodes}): {n_steps} steps converged in "
              f"{stage_s:.2f} s (elastic response and dense preconditioner "
              f"included); "
              + tm_summary([c[:2] for c in chunks], heat_secs)
              + f"; max |fixed-point it - golden| {d_it}; band launches "
              f"{launches}, {step_launches / n_steps:.1f} per step inside the "
              f"chunks; vs golden "
              + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
              + f" (<=1e-6 max|ref|); u and T saved at {len(want)} expected "
              f"times; sink {Sink.__name__}")

    # the heat step is deterministic: same inputs, same bits
    a = heat.step(heat.T, heat.T_old, 25 * HOUR, HOUR)
    b = heat.step(heat.T, heat.T_old, 25 * HOUR, HOUR)
    if not (torch.equal(a[0], b[0]) and a[1] == b[1]):
        raise AssertionError("tm: the heat step does not repeat bitwise")

    # resume: the step-12 checkpoint in fresh equations vs the straight run
    eq_r, heat_r = cfg.wire_tm(st, cfg.cavern600_grid(st), "Cavern",
                               precond="auto")
    tc_r = st.TimeController(dt=1.0, initial_time=0.0,
                             final_time=float(n_steps), time_unit="hour")
    with np.load(ck) as z:
        if not {"heat_T", "heat_T_old", "T0", "Temp"} <= set(z.files):
            raise AssertionError(f"tm: checkpoint keys {sorted(z.files)}")
    st.load_checkpoint(ck, eq_r, tc_r, heat_eq=heat_r)
    if tc_r.step_counter != 12 or tc_r.t != 12 * HOUR:
        raise AssertionError(f"tm: resume from step {tc_r.step_counter}")
    for first in (13, 19):
        r = eq_r.solve_tm_time_steps(
            heat_r, [(first + k) * HOUR for k in range(every)],
            [HOUR] * every, tol=sim.tol, maxiter=sim.maxiter)
        if not (r[:, 5] == 1).all():
            raise AssertionError(f"tm: resumed steps {r.tolist()}")
    assert_same_state("tm", eq_r, heat_r, eq, heat)

    # the heat equation alone through Simulator_T
    _, heat_t = cfg.wire_tm(st, cfg.cavern600_grid(st), "Cavern",
                            precond="auto")
    tc_t = st.TimeController(dt=1.0, initial_time=0.0, final_time=6.0,
                             time_unit="hour")
    out = Sink(heat_t, save_every=every)
    out.set_output_folder(os.path.join(tmp, "t", "T"))
    out.add_output_field("T", "T")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        st.Simulator_T(heat_t, tc_t, [out]).run()
    torch.cuda.synchronize()
    t_s = time.perf_counter() - t0
    e_T = within("t T", heat_t.T.cpu().numpy(),
                 np.load(GOLDEN.format("t_cavern600"))["T"], 1e-8)
    say("tm", f"heat step repeats bitwise; step-12 checkpoint (heat_T, "
              f"heat_T_old) + steps 13-24 in fresh equations equals the "
              f"straight run bit for bit (u, sig_v, eps_tot_v, Temp, T0, T, "
              f"T_old, states); Simulator_T, 6 steps: "
              f"{1e3 * t_s / 6:.1f} ms/step, {heat_t.solver_stats[0]} CG it "
              f"in the last, T {e_T:.2e} vs golden (<=1e-8), saves at "
              f"{saved_times(out, st)}")
    return launches, step_launches / n_steps


def tm_box_phase(st, cfg):
    """Phase 11; returns (DIA launches, launches per step)."""
    import torch
    golden = np.load(GOLDEN.format("tm_box17"))
    n_steps = len(golden["rows"])
    box = cfg.box17_grid(st)
    eq, heat = cfg.wire_tm(st, box, "BOTTOM", precond="auto",
                           fp32_phase="auto")
    dia = eq.kernel.dia
    if dia is None or not dia.structured:
        raise AssertionError("tm_box: block-DIA with the structured assembly "
                             "not auto-selected on CUDA")
    if not eq.solver.fp32_enabled(eq.device):
        raise AssertionError("tm_box: fp32_phase 'auto' did not enable the "
                             "f32 sweep")
    cfg.tm_init(eq, heat)
    P, _ = eq._get_precond()
    if not (len(P) == 1 and P[0].shape[0] == 3 * box.n_nodes):
        raise AssertionError("tm_box: precond 'auto' did not resolve to "
                             "dense")
    heat_secs, thermal = [], []
    time_heat_steps(heat, heat_secs)
    sweep = eq._fp32_sweep

    def watched_sweep(*args, **kw):
        thermal.append(float(args[7].abs().max()))
        return sweep(*args, **kw)
    eq._fp32_sweep = watched_sweep
    eq.fp32_accepted = 0
    torch.cuda.synchronize()
    dia.launches = 0
    chunks, first = [], 1
    for n in (3, n_steps - 3):
        t0 = time.perf_counter()
        r = eq.solve_tm_time_steps(
            heat, [(first + k) * HOUR for k in range(n)], [HOUR] * n,
            tol=1e-6, maxiter=20)
        torch.cuda.synchronize()
        chunks.append((r, time.perf_counter() - t0))
        first += n
    rows = np.concatenate([r for r, _ in chunks])
    launches = dia.launches
    if not (rows[:, 5] == 1).all():
        raise AssertionError(f"tm_box: steps {rows[:, [2, 3, 5]].tolist()}")
    if launches <= 0:
        raise AssertionError("tm_box: the DIA kernel never launched")
    if not (len(thermal) == n_steps and min(thermal) > 0):
        raise AssertionError(f"tm_box: the f32 sweep ran on {len(thermal)} "
                             f"steps with max|eps_th| {thermal}")
    d_it = int(np.abs(rows[:, 2] - golden["rows"][:, 2]).max())
    if d_it > 1:
        raise AssertionError(f"tm_box: fixed-point counts "
                             f"{rows[:, 2].tolist()} vs golden "
                             f"{golden['rows'][:, 2].tolist()}")
    errs = {k: within(f"tm_box {k}", v.cpu().numpy(), golden[k], 1e-6)
            for k, v in (("u", eq.u), ("sig_v", eq.sig_v), ("T", heat.T))}
    say("tm_box", f"solve_tm_time_steps on GridBox nx=17 (E={box.n_elems}, "
                  f"N={box.n_nodes}), block-DIA, dense preconditioner, f32 "
                  f"sweep on: {n_steps} steps converged; "
                  + tm_summary(chunks, heat_secs)
                  + f"; max |fixed-point it - golden| {d_it}; the f32 sweep "
                  f"ran with the thermal strain on {len(thermal)} steps "
                  f"(max|eps_th| {max(thermal):.2e}), accepted on "
                  f"{eq.fp32_accepted}/{n_steps}; DIA launches {launches}, "
                  f"{launches / n_steps:.1f} per step; vs golden "
                  + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
                  + " (<=1e-6 max|ref|)")
    return launches, launches / n_steps


def json_child(case_path, result_path):
    """``--json-child``: run sim_cli on the case with the recording
    simulator (and MemorySink without h5py); write the stage records to
    ``result_path`` and print the DIA launch count on the last line."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import safeincave_torch as st
    import safeincave_torch.config as config
    import torch_port_configs as cfg
    from safeincave_torch.app import sim_cli
    records = []
    config.Simulator_M = cfg.recording_simulator(st, records)
    if not have_h5py():
        config.SaveFields = MemorySink
    print(f"sink: {'SaveFields (h5py)' if have_h5py() else 'MemorySink'}",
          flush=True)
    sim = sim_cli.main(["--json", case_path])
    dia = sim.mom_eq.kernel.dia
    if dia is None or not dia.structured:
        raise AssertionError("json: block-DIA with the structured assembly "
                             "not auto-selected on the written box")
    data = {}
    for prefix, rec in zip(("eq", "op"), records):
        data.update({f"{prefix}_{k}": v for k, v in rec.items()})
    np.savez(result_path, **data)
    print(json.dumps({"dia_launches": dia.launches}), flush=True)


def json_phase(st, cfg, tmp):
    """Phase 9; returns (DIA launches, launches per step)."""
    golden = np.load(GOLDEN.format("json_box17"))
    grid_dir = os.path.join(tmp, "box17")
    os.makedirs(grid_dir, exist_ok=True)
    st.mesh.write_msh(os.path.join(grid_dir, "geom.msh"),
                      *st.mesh.box_mesh(600.0, 600.0, 800.0, 17, 17, 17))
    case = os.path.join(tmp, "box17.json")
    st.Utils.save_json(cfg.box_case(grid_dir, os.path.join(tmp, "json_out")),
                       case)
    result = os.path.join(tmp, "json_result.npz")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--json-child", case, result],
                          capture_output=True, text=True, timeout=900)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"json: sim_cli failed:\n{proc.stdout[-3000:]}"
                             f"\n{proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    launches = json.loads(lines[-1])["dia_launches"]
    sink = next(ln for ln in lines if ln.startswith("sink: "))[6:]
    if launches <= 0:
        raise AssertionError("json: the DIA kernel never launched")
    got = np.load(result)
    rows = np.concatenate([got["eq_rows"], got["op_rows"]])
    if not (rows[:, 2] == 1).all():
        raise AssertionError(f"json: non-converged steps {rows.tolist()}")
    errs = {f: within(f"json operation {f}", got[f"op_{f}"],
                      golden[f"op_{f}"], 1e-6) for f in ("u", "p_elems")}
    ref_it = np.concatenate([golden["eq_rows"], golden["op_rows"]])[:, 0]
    say("json", f"sim_cli --json on box17 (write_msh -> read_msh, E=29478, "
                f"N=5832) in a child process: exit 0 in {secs:.1f} s "
                f"(process start, build load and both stages); "
                f"{len(rows)} steps converged, fixed-point it "
                f"{rows[:, 0].astype(int).tolist()} vs golden "
                f"{ref_it.astype(int).tolist()}; "
                f"DIA launches {launches}, {launches / len(rows):.1f} per "
                f"step; operation u {errs['u']:.2e}, p_elems "
                f"{errs['p_elems']:.2e} vs golden (<=1e-6 max|ref|); sink "
                f"{sink}")
    return launches, launches / len(rows)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", help="run phase 3 alone on the "
                    "safeincave_torch package of this checkout")
    ap.add_argument("--json-child", nargs=2, metavar=("CASE", "RESULT"),
                    help="phase 9's child: run sim_cli on CASE, write the "
                    "stage records to RESULT")
    ap.add_argument("--phase", choices=("tm", "tm_box"),
                    help="after the build, run this phase alone (no kernel "
                    "JSON and no ok line)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's smoke run "
                         "needs a GPU")
    if args.json_child:
        json_child(*args.json_child)
        return
    tree = os.path.abspath(args.tree) if args.tree else ROOT
    sys.path.insert(0, tree)
    sys.path.insert(0, os.path.join(tree, "tests"))
    import safeincave_torch as st
    import torch_port_configs as cfg
    from safeincave_torch import _build

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
                  f"device(s) | package {os.path.dirname(st.__file__)}")

    # 2. build ------------------------------------------------------------- #
    t0 = time.perf_counter()
    _build.build(KERNELS)
    for name in KERNELS:
        _build.load(name)
    say("build", f"{', '.join(KERNELS)} built in parallel and loaded in "
                 f"{time.perf_counter() - t0:.2f} s (nvcc: " + ", ".join(
                     f"{n} {_build.build_seconds.get(n, 0.0):.2f} s"
                     for n in KERNELS) + ")")

    # 3. kernels vs plain and cuSPARSE, every shape ------------------------ #
    if args.tree:
        print(json.dumps({"tree": args.tree,
                          "kernels": kernel_phase(st, cfg, dev)}), flush=True)
        print(card, flush=True)
        return
    if args.phase:
        with tempfile.TemporaryDirectory() as tmp:
            print(tm_phase(st, cfg, tmp) if args.phase == "tm"
                  else tm_box_phase(st, cfg), flush=True)
        print(card, flush=True)
        return
    kernel_rows = kernel_phase_child(tree)

    # 4. cavern600 main path ------------------------------------------------ #
    golden = np.load(GOLDEN.format("cavern600"))
    grid = cfg.cavern600_grid(st)
    N = grid.n_nodes
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eq = cfg.wire_bench(st, grid, precond="auto")
    band = eq.kernel.band
    if band is None:
        raise AssertionError("band kernel not auto-selected on CUDA")
    band.launches = 0
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
    ((rows1, _),) = run_chunks(eq, 4 * HOUR, (10,))
    before = band.launches
    ((rows2, secs2),) = run_chunks(eq, 14 * HOUR, (10,))
    launches = band.launches
    band_per_step = (launches - before) / len(rows2)
    all_rows = np.concatenate([rows3, rows1, rows2])
    if not (all_rows[:, 5] == 1).all():
        raise AssertionError(f"non-converged steps: {all_rows[:, [0, 1, 5]]}")
    if launches <= 0:
        raise AssertionError("the main path never launched the band kernel")
    say("main", f"elastic {elastic_s:.2f} s incl. dense preconditioner "
                f"({elastic_krylov} Krylov); 23 steps converged; chunk 2: "
                f"{1e3 * secs2 / len(rows2):.1f} ms/step, "
                f"{rows2[:, 0].mean():.2f} fixed-point it/step, "
                f"{rows2[:, 2].mean():.1f} Krylov it/step; band launches "
                f"{launches}, {band_per_step:.1f} per step in chunk 2; peak "
                f"device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # 5. cavern600 parity --------------------------------------------------- #
    parity("parity", golden, u_elastic, rows3, u3, sig3)
    del eq, P, band

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
    before = dia.launches
    ((rows10, secs10),) = run_chunks(eq, 4 * HOUR, (10,))
    launches_box = dia.launches
    dia_per_step = (launches_box - before) / len(rows10)
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
               f"{rows10[:, 2].mean():.1f} Krylov it/step (summed over the "
               f"step's solves, the f32 sweep's included; "
               f"{rows10[:, 2].sum() / rows10[:, 0].sum():.1f} per "
               f"fixed-point iteration); f32 sweeps "
               f"accepted {eq.fp32_accepted}/13 steps; DIA launches "
               f"{launches_box}, {dia_per_step:.1f} per step in the chunk; "
               f"peak device memory "
               f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # 7. box parity -------------------------------------------------------- #
    parity("box parity", golden, u_elastic, rows3, u3, sig3)
    del eq, P, dia

    with tempfile.TemporaryDirectory() as tmp:
        # 8. the 4_cavern workflow through Simulator_M --------------------- #
        sim_launches, sim_per_step, stage_ms = sim_phase(st, cfg, dev, tmp)
        say("sim", f"ms/step: equilibrium {stage_ms[0]:.1f}, operation "
                   f"{stage_ms[1]:.1f}; phase 4's bare solve_time_steps "
                   f"{1e3 * secs2 / len(rows2):.1f} (the bench material, "
                   f"with Desai)")
        # 9. the JSON driver in a child process ----------------------------- #
        json_launches, json_per_step = json_phase(st, cfg, tmp)
        # 10. the thermo-mechanical driver on cavern600 --------------------- #
        tm_launches, tm_per_step = tm_phase(st, cfg, tmp)

    # 11. the coupled chunk on box17: block-DIA and the f32 sweep ---------- #
    tm_box_launches, tm_box_per_step = tm_box_phase(st, cfg)

    # launches of each path, each counted from 0 just before the path ran
    paths = {BAND["name"]: {"main": (launches, band_per_step),
                            "sim": (sim_launches, sim_per_step),
                            "tm": (tm_launches, tm_per_step)},
             DIA["name"]: {"box": (launches_box, dia_per_step),
                           "json": (json_launches, json_per_step),
                           "tm_box": (tm_box_launches, tm_box_per_step)}}
    for row in kernel_rows:
        by_path = paths[row["name"]]
        row["launches"], row["launches_per_step"] = next(
            iter(by_path.values()))
        row["launches_by_path"] = {k: n for k, (n, _) in by_path.items()}
        row["launches_per_step_by_path"] = {k: r for k, (_, r)
                                            in by_path.items()}
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
