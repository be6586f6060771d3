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

The last lines are the kernel JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``.  There is no CPU fallback: without a CUDA
device the script exits non-zero before printing any result.

    python3 chip_smoke.py --tree DIR

runs phase 3 alone on the ``safeincave_torch`` package of another checkout
(DIR holds its ``safeincave_torch/`` and ``tests/``), to time two designs of
the kernels in turns within one call; it prints the kernel JSON and the
card, and no ``ok`` line.
"""
import argparse
import json
import os
import subprocess
import sys
import time

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
    import numpy as np
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
    import numpy as np
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
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", help="run phase 3 alone on the "
                    "safeincave_torch package of this checkout")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's smoke run "
                         "needs a GPU")
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
               f"{rows10[:, 2].mean():.1f} Krylov it/step; f32 sweeps "
               f"accepted {eq.fp32_accepted}/13 steps; DIA launches "
               f"{launches_box}, {dia_per_step:.1f} per step in the chunk; "
               f"peak device memory "
               f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # 7. box parity -------------------------------------------------------- #
    parity("box parity", golden, u_elastic, rows3, u3, sig3)

    counts = {BAND["name"]: (launches, band_per_step),
              DIA["name"]: (launches_box, dia_per_step)}
    for row in kernel_rows:
        row["launches"], row["launches_per_step"] = counts[row["name"]]
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
