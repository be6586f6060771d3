"""Benchmark of the PyTorch/CUDA port (safeincave_torch): Newton-step
wall-clock on the cavern600 problem, the counterpart of bench.py.

    python3 bench_torch.py                      # on the card, every section
    python3 bench_torch.py --device cpu --sections headline --steps 2 --repeats 2

The workload is bench.py's: the band-ordered cavern600 mesh, Spring +
Kelvin-Voigt + dislocation creep + Desai, roller supports and a 24 h
sinusoidal pressure of 10 +- 4 MPa, theta = 0.5, fixed-point tol 1e-8 / 40
iterations, BiCGStab at rtol 1e-12 (f32 Krylov under f64 defect correction),
dt = 1 h.  Sections, in bench.py's order (``--sections`` picks some):

- ``headline``: the elastic response, a warm-up chunk (steps 1-20), then the
  timed window (steps 21-40) through ``solve_time_steps``, ``--repeats``
  times from one saved state (the port's checkpoint, through a temporary
  file).  Every repeat must do the same fixed-point and Krylov work; the
  median is the headline.  A step the chunk does not converge is retried
  pure-f64 and counts toward the time, as in bench.py.
- ``scale``: the block-DIA operator on the natural-order GridBox nx=44 (91k
  nodes, 511k tets): the card's streaming-copy rate, the f32 and f64 DIA
  matvecs (the CUDA kernel) with bench.py's "streamed" and "effective"
  bytes, the f32 and f64 assembly, and the cumsum matvec for contrast.
- ``tm_cyclic``: bench.py's three coupled TM-cyclic configurations
  (regular1200, interlayer1200, interlayer600), each against its row of
  baseline_measured.json.
- ``matvec``: the cumsum action at cavern600 in f32 and f64 and the band
  kernel in f32, with bench.py's byte count.
- ``tm``: bench.py's coupled TM configuration on cavern600 (the heat
  Dirichlet ramp on ``TOP``, the mesh's name for the face bench.py calls
  ``Top``).
- ``hostsync``: 20 steps of ``solve_time_step`` + ``commit_time_step``, the
  per-step host-controlled loop.

Progress goes to stderr, then a line ``bench_torch summary {...}`` with the
headline, the counts, every kernel's launches and, for the headline and
``hostsync``, the host reads of tensors per step.  Stdout gets one JSON
line: ``{"metric", "value", "unit", "vs_baseline", "vs_baseline_measured"}``.
Matvecs are timed with CUDA events, steps with the host clock between
``torch.cuda.synchronize()`` calls.  Without ``--device cpu`` the run needs a
CUDA device and raises without one; a section that fails ends the run with a
non-zero exit, and on the card each section raises if its hand kernel was
not launched.
"""
import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import safeincave_torch as sc
from safeincave_torch.checkpoint import load_checkpoint, save_checkpoint
from safeincave_torch.fem.dia import BlockDIA
from safeincave_torch import tracing
from safeincave_torch.fem.kernels import MomentumKernel
from safeincave_torch.utils import find_grid

REFERENCE_SECONDS_PER_STEP = 2.0  # documented estimate, see bench.py
# nominal HBM read rate by card name (NVIDIA data sheet); other cards print
# "nominal unknown"
NOMINAL_GBPS = {"NVIDIA H100 80GB HBM3": 3350.0}
SECTIONS = ("headline", "scale", "tm_cyclic", "matvec", "tm", "hostsync")
# bench.py's TM-cyclic configurations: (grid, fallback, label, baseline row)
TM_CYCLIC = (("cavern_regular_1200_3D", "cavern_proxy_1200",
              "regular1200-TM", "regular1200_tm"),
             ("cavern_interlayer_1200", None,
              "interlayer1200-TM", "interlayer1200_tm"),
             ("cavern_interlayer_600_3D", "cavern_interlayer_proxy",
              "interlayer600-TM", "interlayer600_tm"))
DT = 3600.0
MPa = 1e6
# bench.py's Krylov settings, its supports and its loaded faces
SETTINGS = dict(method="bicgstab", rtol=1e-12, max_it=400, coarse_agg=8)
FIXED = [("WEST", 0), ("SOUTH", 1), ("BOTTOM", 2),
         ("West", 0), ("South", 1), ("Bottom", 2)]
LOADED = ["EAST", "NORTH", "TOP", "East", "North", "Top",
          "Cavern", "CAVERN", "Wall", "WALL"]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


@functools.lru_cache(maxsize=None)
def load_measured_baseline():
    """Measured CPU-backend baseline (baseline_measured.json: per-config
    s/step of the JAX package's per-step, pure-f64 path on one CPU core),
    read once at first use."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline_measured.json")
    if os.path.isfile(path):
        with open(path) as f:
            return json.load(f)
    return {}


def measured_ratio(key, per_step_s):
    entry = load_measured_baseline().get(key)
    if not entry:
        return None
    return entry["s_per_step"] / per_step_s


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def call_ms(fn, n, device, calls=3):
    """Least ms per call of ``fn`` over ``calls`` runs of ``n`` calls each,
    after one call outside the window: CUDA events on the card, the host
    clock on the CPU."""
    fn()
    sync(device)
    best = float("inf")
    for _ in range(calls):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            stop.record()
            stop.synchronize()
            ms = start.elapsed_time(stop) / n
        else:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            ms = (time.perf_counter() - t0) * 1e3 / n
        best = min(best, ms)
    return best


def card_line(device):
    """The card's name and power limit as nvidia-smi reports them."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[device.index or 0]


class Roofline:
    """GB/s of a kernel against the card's nominal read rate and against
    the streaming ceiling the scale section measures."""

    def __init__(self, device):
        self.name = (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu")
        self.nominal = NOMINAL_GBPS.get(self.name)
        self.ceiling = None

    def __call__(self, nbytes, ms):
        gbps = nbytes / (ms * 1e-3) / 1e9
        text = f"{gbps:.1f} GB/s = " + (
            f"{100 * gbps / self.nominal:.1f}% of the {self.nominal:.0f} "
            f"GB/s nominal ({self.name})" if self.nominal
            else f"nominal unknown ({self.name})")
        if self.ceiling:
            text += (f" / {100 * gbps / self.ceiling:.1f}% of the measured "
                     f"{self.ceiling:.0f} GB/s streaming ceiling")
        return text


def launches_of(kern):
    """{name: launches} of the hand kernel the f32 Krylov operator of an
    equation's ``kern`` runs (the block-DIA operator first, then the band
    kernel unless block-ELL was enabled; fem/momentum.py:_f32_action); {}
    for block-ELL and the cumsum matvec, which run torch ops."""
    if kern.dia is not None:
        return {"dia_matvec": kern.dia.launches}
    if kern.band is not None and kern.blockell is None:
        return {"band_matvec": kern.band.launches}
    return {}


def launch_text(launched, steps):
    """", x <kernel> launches/step" for each kernel of ``launched``."""
    return "".join(f", {v / steps:.1f} {k} launches/step"
                   for k, v in launched.items())


def need_launch(tag, device, n):
    """``n``; on the card raises when it is 0."""
    if device.type == "cuda" and n <= 0:
        raise RuntimeError(f"{tag}: the hand kernel was not launched on the "
                           f"card")
    return n


def moved(tag, eq, before):
    """{kernel: launches since ``before``} of ``eq``'s hand kernel (from
    :func:`launches_of`).  On the card raises when it was not launched, or
    when the path has none but block-ELL, which only ``--backend`` picks."""
    got = {k: v - before.get(k, 0)
           for k, v in launches_of(eq.kernel).items()}
    if got or eq.kernel.blockell is None:
        need_launch(tag, eq.device, sum(got.values()))
    return got


# --------------------------------------------------------------------------- #
# 1. the benchmark equation (bench.py:build)
# --------------------------------------------------------------------------- #
# The set-up functions take the package module (``pkg``, default
# safeincave_torch, the only one this script passes): the JAX package's
# public API is the same, and the parity tests set the JAX reference up
# through these functions too.
def on(pkg, device):
    """``device`` as keyword arguments of ``pkg``'s constructors (none for
    the JAX package, nor when ``device`` is None: the port's default)."""
    if device is None or pkg.__name__ != "safeincave_torch":
        return {}
    return {"device": device}


def bench_material(n, device=None, pkg=sc):
    """bench.py's material: Spring + Kelvin-Voigt + dislocation creep +
    Desai viscoplasticity on ``n`` elements."""
    one = np.ones(n)
    dev = on(pkg, device)
    mat = pkg.Material(n, **dev)
    mat.set_density(2200.0 * one)
    mat.add_to_elastic(pkg.Spring(102e9 * one, 0.3 * one))
    mat.add_to_non_elastic(pkg.Viscoelastic(105e11 * one, 10e9 * one,
                                            0.32 * one, **dev))
    mat.add_to_non_elastic(pkg.DislocationCreep(1.9e-20 * one, 51600 * one,
                                                3.0 * one, **dev))
    mat.add_to_non_elastic(pkg.ViscoplasticDesai(
        mu_1=5.3665857009859815e-11 * one, N_1=3.1 * one,
        a_1=1.965018496922832e-05 * one, eta=0.8275682807874163 * one,
        n=3.0 * one, beta_1=0.0048 * one, beta=0.995 * one, m=-0.5 * one,
        gamma=0.095 * one, sigma_t=5.0 * one, alpha_0=0.0022 * one, **dev))
    return mat


def bench_bcs(eq, pkg=sc):
    """bench.py's supports (the first boundary pinned in all components
    when no face has a known name) and the 24 h sinusoidal pressure of 10
    +- 4 MPa on the loaded faces, on ``eq``'s grid."""
    momBC = pkg.MomentumBC
    names = eq.grid.get_boundary_names()
    bc = momBC.BcHandler(eq)
    tv = [0.0, 1e12]
    fixed = [(nm, comp) for nm, comp in FIXED if nm in names] \
        or [(names[0], comp) for comp in range(3)]
    for nm, comp in fixed:
        bc.add_boundary_condition(momBC.DirichletBC(nm, comp, [0., 0.], tv))
    # the 24 h sinus keeps every window doing comparable nonlinear work
    t_sched = np.arange(0.0, 400 * DT, DT)
    p_sched = 10 * MPa + 4 * MPa * np.sin(2 * np.pi * t_sched / (24 * DT))
    for nm in LOADED:
        if nm in names:
            bc.add_boundary_condition(momBC.NeumannBC(
                nm, 2, 0.0, 0.0, list(p_sched), list(t_sched), g=0.0))
    eq.set_boundary_conditions(bc)


def bench_equation(grid, device=None, pkg=sc, eq_kw=None, **settings):
    """bench.py's benchmark equation on ``grid``: theta 0.5,
    :data:`SETTINGS` with ``settings`` beside them, :func:`bench_material`
    at 298 K, no body force, :func:`bench_bcs`.  ``eq_kw`` goes to
    ``LinearMomentum`` (``auto_backend``)."""
    eq = pkg.LinearMomentum(grid, theta=0.5, **on(pkg, device),
                            **(eq_kw or {}))
    eq.set_solver(pkg.SolverSettings(**SETTINGS, **settings))
    n = eq.n_elems
    eq.set_material(bench_material(n, device, pkg))
    eq.set_T0(298.0 * np.ones(n))
    eq.set_T(298.0 * np.ones(n))
    eq.build_body_force([0.0, 0.0, 0.0])
    bench_bcs(eq, pkg)
    return eq


def build(device=None, lag_tangent=False, adaptive_rtol=False, backend=None):
    """bench.py's cavern benchmark equation on ``device`` (default: the
    card): the band-ordered cavern600 mesh, or the box nx=17 when no cavern
    mesh is found.  ``backend`` ("band", "blockell" or "dia") forces a
    stiffness backend and raises when it cannot be enabled."""
    device = torch.device(device) if device is not None \
        else sc.default_device()
    try:
        cav = find_grid("cavern_regular_600_3D", fallback="cavern_proxy_600")
    except FileNotFoundError:
        cav = None
    if cav is not None:
        grid = sc.GridHandlerGMSH("geom", cav, reorder="band")
        log(f"mesh: {os.path.basename(cav)} ({grid.n_nodes} nodes, "
            f"{grid.n_elems} tets, band-reordered)")
    else:
        grid = sc.GridBox(Lx=600.0, Ly=600.0, Lz=800.0, nx=17, ny=17, nz=17)
        log(f"mesh: synthetic box ({grid.n_nodes} nodes, {grid.n_elems} "
            f"tets)")
    eq = bench_equation(grid, device, lag_tangent=lag_tangent,
                        adaptive_rtol=adaptive_rtol)
    log(f"lag_tangent: {lag_tangent}  adaptive_rtol: {adaptive_rtol}")
    if backend:
        getattr(eq, f"enable_{backend}_matvec")()
        log(f"matvec backend: {backend} (--backend)")
    else:
        chosen = [nm for attr, nm in (("dia", "block-DIA"),
                                      ("blockell", "block-ELL"),
                                      ("band", "band kernel"))
                  if getattr(eq.kernel, attr, None) is not None]
        log(f"matvec backend: {chosen[0]} (auto-selected)" if chosen
            else "matvec backend: matrix-free cumsum (library default)")
    return eq


def elastic_start(eq):
    """The elastic response and the initial creep rates; returns seconds."""
    eq.bc.update_dirichlet(0.0)
    eq.bc.update_neumann(0.0)
    t0 = time.perf_counter()
    eq.solve_elastic_response()
    sync(eq.device)
    secs = time.perf_counter() - t0
    eps = eq.compute_total_strain()
    eq.compute_elastic_stress(eps)
    eq.compute_eps_ne_rate(eq.sig_v, 0.0)
    eq.update_eps_ne_rate_old()
    return secs


def run_chunk(eq, ts):
    """bench.py's retrying chunk: ``solve_time_steps`` over ``ts``; a step
    the chunk could not converge is retried pure-f64 from its entry state
    (``Simulator_M``'s flow) and counts toward the time.  Returns (rows,
    retries); raises when the retry fails too."""
    rows, retries = [], 0
    pending = list(ts)
    while pending:
        stats = eq.solve_time_steps(pending, [DT] * len(pending), tol=1e-8,
                                    maxiter=40)
        n_ok = int((stats[:, 5] > 0.5).astype(int).cumprod().sum())
        rows.extend(stats[:n_ok])
        if n_ok == len(pending):
            break
        eq._fp32_disable = True
        try:
            ite, errv = eq.solve_time_step(pending[n_ok], DT, tol=1e-8,
                                           maxiter=40)
        finally:
            eq._fp32_disable = False
        if not errv <= 1e-8:
            raise RuntimeError(f"f64 retry of the step at "
                               f"t={pending[n_ok] / 3600:.0f} h failed: "
                               f"err={errv:.3e}")
        eq.commit_time_step(DT)
        rows.append(np.asarray([ite, errv, eq.krylov_total,
                                eq.solver_stats[0], eq.solver_stats[1], 1.0]))
        retries += 1
        pending = pending[n_ok + 1:]
    return np.asarray(rows), retries


# --------------------------------------------------------------------------- #
# 2. the headline (bench.py:926-1073), in repeats from one saved state
# --------------------------------------------------------------------------- #
def headline(eq, steps=20, repeats=5):
    """Elastic response, warm-up steps 1..steps, then the timed window
    steps+1..2 steps, ``repeats`` times from the state saved after the
    warm-up.  Returns the summary dict; raises when the repeats did not do
    the same work or (on the card) launched no hand kernel."""
    device = eq.device
    el_s = elastic_start(eq)
    log(f"elastic solve (incl. first use): {el_s:.2f}s, krylov iters="
        f"{eq.solver_stats[0]}, res={eq.solver_stats[1]:.2e}")
    t0 = time.perf_counter()
    warm, warm_retries = run_chunk(eq, [(k + 1) * DT for k in range(steps)])
    sync(device)
    log(f"warm-up chunk (steps 1-{steps}, incl. first use): "
        f"{time.perf_counter() - t0:.2f}s, {warm[:, 0].mean():.2f} "
        f"fp-iters/step, {warm_retries} f64 retries")
    window = [(steps + 1 + k) * DT for k in range(steps)]
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        state = os.path.join(tmp, "warm.npz")
        save_checkpoint(state, eq)
        for r in range(repeats):
            load_checkpoint(state, eq)
            before = launches_of(eq.kernel)
            sync(device)
            t0 = time.perf_counter()
            reads = tracing.count_of("read")
            rows, retries = run_chunk(eq, window)
            sync(device)
            secs = time.perf_counter() - t0
            reads = tracing.count_of("read") - reads
            got = moved("headline", eq, before)
            runs.append({"s_per_step": secs / steps, "rows": rows,
                         "retries": retries, "launches": got,
                         "reads": reads})
            log(f"repeat {r + 1}/{repeats}: {secs:.3f}s "
                f"({1e3 * secs / steps:.1f} ms/step, {retries} f64 retries)")
    first = runs[0]
    for k, run in enumerate(runs[1:], 2):
        if not (np.array_equal(run["rows"][:, [0, 2]],
                               first["rows"][:, [0, 2]])
                and run["retries"] == first["retries"]
                and run["launches"] == first["launches"]):
            raise RuntimeError(
                f"repeat {k} did other work than repeat 1 from the same "
                f"state: fixed-point/Krylov per step "
                f"{run['rows'][:, [0, 2]].tolist()} against "
                f"{first['rows'][:, [0, 2]].tolist()}")
    per = [run["s_per_step"] for run in runs]
    rows = first["rows"]
    out = {"median_s": statistics.median(per), "min_s": min(per),
           "max_s": max(per), "repeats": repeats, "steps": steps,
           "window": [steps + 1, 2 * steps],
           "fp_per_step": float(rows[:, 0].mean()),
           "krylov_per_step": float(rows[:, 2].mean()),
           "retries": first["retries"],
           # per repeat, per step: [fixed-point iterations, Krylov iterations]
           "counts": [run["rows"][:, [0, 2]].tolist() for run in runs],
           "launches_per_step": {k: v / steps
                                 for k, v in first["launches"].items()},
           "launches": {k: sum(run["launches"][k] for run in runs)
                        for k in first["launches"]},
           # host reads of tensors (item, tolist, float, int, bool)
           "host_reads_per_step": first["reads"] / steps,
           "final_err": float(rows[-1, 1])}
    log(f"{steps} steps (fused driver), steps {steps + 1}-{2 * steps} from "
        f"one saved state, {repeats} repeats: median "
        f"{1e3 * out['median_s']:.1f} ms/step (min {1e3 * out['min_s']:.1f}, "
        f"max {1e3 * out['max_s']:.1f}); {out['fp_per_step']:.2f} "
        f"fp-iters/step, {out['krylov_per_step']:.1f} krylov-iters/step"
        f"{launch_text(first['launches'], steps)}, {out['retries']} f64 "
        f"retries, final err={out['final_err']:.2e}, "
        f"{out['host_reads_per_step']:.1f} host reads/step"
        f"; the same counts in every repeat")
    return out


# --------------------------------------------------------------------------- #
# 3. the scale roofline (bench.py:bench_matvec_scale)
# --------------------------------------------------------------------------- #
def dia_bytes(plan, n_nodes, fbytes):
    """bench.py's (streamed, effective) bytes of one block-DIA matvec: the
    value planes and u actually moved, and the true nonzeros' bytes."""
    streamed = (plan.Dn * 9 * n_nodes + 6 * n_nodes) * fbytes
    effective = (plan.n_pairs * 9 + 6 * n_nodes) * fbytes
    return streamed, effective


def matvec_bytes(n_elems, n_nodes, fbytes):
    """bench.py's bytes of one element-wise stiffness action: per element
    u gathered (12 values), grad_N (12), vol (1), CT (36) and the forces
    scattered (12); per node the result read and written."""
    return (12 + 12 + 1 + 36 + 12) * fbytes * n_elems \
        + 2 * 3 * fbytes * n_nodes


def bench_matvec_scale(device, roof, nx=44, seed=0):
    """The block-DIA operator on the natural-order GridBox ``nx``: the
    card's streaming-copy rate (which becomes ``roof.ceiling``), the f32
    and f64 DIA matvecs, the assembly and the cumsum matvec.  Returns the
    DIA kernel's launches of each precision; raises on the card when one of
    them did not run."""
    grid = sc.GridBox(Lx=600.0, Ly=600.0, Lz=800.0, nx=nx, ny=nx, nz=nx)
    kern = MomentumKernel(grid, device)
    E, N = kern.n_elems, kern.n_nodes
    mat = sc.Material(E, device=device)
    mat.add_to_elastic(sc.Spring(102e9 * np.ones(E), 0.3 * np.ones(E)))
    dia = BlockDIA(kern)
    p = dia.plan
    log(f"[scale] box mesh: {N} nodes, {E} tets, {3 * N} dofs; DIA {p.Dn} "
        f"offsets at {p.fill:.3f} fill, structured assembly: "
        f"{dia.structured}")

    # the ceiling: a 128 MB f32 buffer scaled in place (read + write)
    big = torch.ones(32 * 1024 * 1024, dtype=torch.float32, device=device)
    copy_ms = call_ms(lambda: big.mul_(1.0000001), 100, device)
    roof.ceiling = 2 * big.numel() * 4 / (copy_ms * 1e-3) / 1e9
    del big
    share = (f"{100 * roof.ceiling / roof.nominal:.1f}% of the "
             f"{roof.nominal:.0f} GB/s nominal" if roof.nominal
             else "nominal unknown")
    log(f"[scale] streaming-copy calibration: {roof.ceiling:.0f} GB/s "
        f"achieved ({share}, {roof.name})")
    CT64 = kern.prep(mat.C)
    vals64 = dia.assemble(CT64)
    rng = np.random.default_rng(seed)
    out, launched = {}, {}
    for dtype, fbytes, iters in ((torch.float32, 4, 500),
                                 (torch.float64, 8, 100)):
        before = dia.launches
        op = dia.operator(vals64.to(dtype).contiguous())
        u = torch.as_tensor(rng.normal(size=(N, 3)), dtype=dtype,
                            device=device)
        ms = call_ms(lambda: op(u), iters, device)
        streamed, effective = dia_bytes(p, N, fbytes)
        name = str(dtype).split(".")[-1]
        out[name] = ms
        launched[f"dia_matvec_f{fbytes * 8}"] = need_launch(
            "scale", device, dia.launches - before)
        log(f"[scale] matvec[block-DIA {name}]: {1e3 * ms:.1f} us "
            f"({3 * N / ms / 1e3:.0f} MDOF/s, streamed "
            f"{roof(streamed, ms)}; effective "
            f"{effective / (ms * 1e-3) / 1e9:.1f} GB/s)")

    for dtype in (torch.float32, torch.float64):
        CTd = CT64.to(dtype)
        ms = call_ms(lambda: dia.assemble(CTd), 10, device, calls=1)
        log(f"[scale] assemble[{str(dtype).split('.')[-1]}]: {ms:.1f} ms "
            f"(once per linearized solve)")

    CT32 = kern.prep(mat.C.to(torch.float32))
    u32 = torch.as_tensor(rng.normal(size=(N, 3)), dtype=torch.float32,
                          device=device)
    ms = call_ms(lambda: kern.matvec(CT32, u32), 20, device)
    log(f"[scale] matvec[matrix-free cumsum f32]: {1e3 * ms:.1f} us "
        f"({3 * N / ms / 1e3:.0f} MDOF/s) - gather/scatter-bound, why the "
        f"assembled operator owns this regime")
    return {"launches": launched, "ms": out, "ceiling_gbps": roof.ceiling}


# --------------------------------------------------------------------------- #
# 4. the TM-cyclic configurations (bench.py:build_tm_cyclic, bench_tm_cyclic)
# --------------------------------------------------------------------------- #
def build_tm_cyclic(grid_name, fallback=None, label=None, device=None,
                    pkg=sc, eq_kw=None, **settings):
    """bench.py's ``build_tm_cyclic``: coupled TM cyclic loading on the
    band-ordered mesh ``grid_name`` (``fallback`` first in grids/, as
    bench.py finds it).  bench.py's quirks are kept: the interlayer test is
    ``"nterlayer" in region`` (case-sensitive: cavern_proxy_1200's
    "INTERLAYER" runs as single-region KV + DC, with 10 +- 4 MPa on TOP and
    Cavern) and the heat Dirichlet ramp goes on "Top" only.  ``settings``
    go beside bench.py's Krylov settings, ``eq_kw`` to ``LinearMomentum``.
    Returns (eq, heat)."""
    dev = on(pkg, device)
    momBC, heatBC = pkg.MomentumBC, pkg.HeatBC
    path = pkg.Utils.find_grid(grid_name, fallback=fallback)
    grid = pkg.GridHandlerGMSH("geom", path, reorder="band")
    regions = grid.get_subdomain_names()
    if label:
        log(f"[{label}] mesh: {os.path.basename(os.path.dirname(path))} "
            f"({grid.n_nodes} nodes, {grid.n_elems} tets, "
            f"regions={regions})")
    has_inter = any("nterlayer" in r for r in regions)

    def per_region(salt_val, inter_val, over_val=None):
        if over_val is None:
            over_val = salt_val
        return np.asarray(grid.get_parameter(
            {r: (inter_val if "nterlayer" in r
                 else over_val if "verburden" in r else salt_val)
             for r in regions}))

    n = grid.n_elems
    one = np.ones(n)
    inter = per_region(0.0, 1.0, 0.0)
    over = per_region(0.0, 0.0, 1.0)
    salt = 1.0 - inter - over
    eq = pkg.LinearMomentum(grid, theta=0.5, **dev, **(eq_kw or {}))
    eq.set_solver(pkg.SolverSettings(**SETTINGS, **settings))
    mat = pkg.Material(n, **dev)
    mat.set_density(2200.0 * salt + 2900.0 * inter + 2500.0 * over)
    mat.add_to_elastic(pkg.Spring(102e9 * salt + 70e9 * inter + 35e9 * over,
                                 0.30 * salt + 0.27 * inter + 0.25 * over))
    mat.add_to_non_elastic(pkg.Viscoelastic(
        per_region(105e11, 105e13, 105e13), 10e9 * one, 0.32 * one, **dev))
    if has_inter:
        # salt creep masked off the interlayers and the overburden cap,
        # Mohr-Coulomb interlayers
        mat.add_to_non_elastic(pkg.DislocationCreep(
            1.9e-20 * salt, 51600 * one, 3.0 * one, name="ds_creep", **dev))
        mat.add_to_non_elastic(pkg.MohrCoulombViscoplastic(
            mu_1=1e-9 * inter, N_1=1.0 * one, cohesion=4.0 * one,
            friction_angle=np.radians(35.0) * one,
            dilation_angle=0.0 * one, sigma_t=1.0 * one, **dev))
    else:
        mat.add_to_non_elastic(pkg.DislocationCreep(
            1.9e-20 * one, 51600 * one, 3.0 * one, name="ds_creep", **dev))
    mat.add_to_thermoelastic(pkg.Thermoelastic(44e-6 * one, **dev))
    mat.set_specific_heat_capacity(850.0 * one)
    mat.set_thermal_conductivity(7.0 * one)
    eq.set_material(mat)
    T0 = 298.0
    eq.set_T0(T0 * one)
    eq.set_T(T0 * one)
    eq.build_body_force([0.0, 0.0, 0.0])

    names = grid.get_boundary_names()
    bc = momBC.BcHandler(eq)
    tv = [0.0, 1e12]
    for nm, comp in (("West", 0), ("South", 1), ("Bottom", 2),
                     ("WEST", 0), ("SOUTH", 1), ("BOTTOM", 2)):
        if nm in names:
            bc.add_boundary_condition(momBC.DirichletBC(nm, comp, [0., 0.],
                                                        tv))
    t_sched = np.arange(0.0, 400 * DT, DT)
    if has_inter:
        # overburden above the cavern-pressure band keeps the state
        # compressive
        p_sched = 8 * MPa + 2 * MPa * np.sin(2 * np.pi * t_sched
                                             / (24 * DT))
        for nm in ("Top", "TOP"):
            if nm in names:
                bc.add_boundary_condition(momBC.NeumannBC(
                    nm, 2, 0.0, 0.0, [15 * MPa, 15 * MPa], tv, g=0.0))
        if "Cavern" in names:
            bc.add_boundary_condition(momBC.NeumannBC(
                "Cavern", 2, 0.0, 0.0, list(p_sched), list(t_sched), g=0.0))
    else:
        p_sched = 10 * MPa + 4 * MPa * np.sin(2 * np.pi * t_sched
                                              / (24 * DT))
        for nm in ("Top", "TOP", "Cavern"):
            if nm in names:
                bc.add_boundary_condition(momBC.NeumannBC(
                    nm, 2, 0.0, 0.0, list(p_sched), list(t_sched), g=0.0))
    eq.set_boundary_conditions(bc)

    heat = pkg.HeatDiffusion(grid, **dev)
    heat.set_solver(pkg.SolverSettings(method="cg", rtol=1e-12, max_it=400))
    heat.set_material(mat)
    heat.set_initial_T(T0 * np.ones(grid.n_nodes))
    bc_h = heatBC.BcHandler(heat)
    if "Top" in names:
        bc_h.add_boundary_condition(heatBC.DirichletBC(
            "Top", [T0, 293., 293.], [0.0, 12 * DT, 1e12]))
    if "Cavern" in names:
        bc_h.add_boundary_condition(heatBC.RobinBC(
            "Cavern", [T0, 283., 283.], 5.0, [0.0, 24 * DT, 1e12]))
    heat.set_boundary_conditions(bc_h)
    return eq, heat


def init_tm(eq, heat, label=""):
    """Elastic response + initial creep rates at T0 (the TM init)."""
    T_el = heat.get_T_elems()
    eq.set_T0(T_el)
    eq.set_T(T_el)
    secs = elastic_start(eq)
    if label:
        log(f"[{label}] elastic solve (incl. first use): {secs:.1f}s")


def ramp_note(heat):
    """What becomes of the heat Dirichlet ramp on this mesh."""
    if heat.bc.dirichlet_boundaries:
        return "heat Dirichlet ramp on " + ", ".join(
            b.boundary_name for b in heat.bc.dirichlet_boundaries)
    return "heat Dirichlet ramp skipped: no face named 'Top' (bench.py's " \
        "case-sensitive name)"


def bench_tm_cyclic(grid_name, fallback, label, baseline_key, device,
                    n_steps=10):
    """A timed fused run of a :func:`build_tm_cyclic` configuration: the
    first step alone, then ``n_steps`` in one chunk; every step must
    converge.  Returns the section's numbers."""
    eq, heat = build_tm_cyclic(grid_name, fallback, label, device=device)
    init_tm(eq, heat, label)
    before = launches_of(eq.kernel)
    t0 = time.perf_counter()
    stats = eq.solve_tm_time_steps(heat, [DT], [DT], tol=1e-6, maxiter=20)
    sync(device)
    log(f"[{label}] TM first fused step (incl. first use): "
        f"{time.perf_counter() - t0:.1f}s (conv={int(stats[0, 5])})")
    t0 = time.perf_counter()
    stats = np.concatenate([stats, eq.solve_tm_time_steps(
        heat, [(k + 2) * DT for k in range(n_steps)], [DT] * n_steps,
        tol=1e-6, maxiter=20)])
    sync(device)
    per = (time.perf_counter() - t0) / n_steps
    launched = moved(label, eq, before)
    if not (stats[:, 5] > 0.5).all():
        raise RuntimeError(f"[{label}] non-converged steps: "
                           f"{stats[:, [2, 3, 5]].tolist()}")
    s = stats[1:]
    ratio = measured_ratio(baseline_key, per)
    vs = (f", vs measured CPU baseline "
          f"{load_measured_baseline()[baseline_key]['s_per_step']:.2f} "
          f"s/step = "
          f"{ratio:.1f}x" if ratio else "")
    log(f"[{label}] TM cyclic (fused driver): {per * 1e3:.1f} ms/step over "
        f"{n_steps} steps ({s[:, 2].mean():.2f} fp-iters/step, "
        f"{s[:, 4].mean():.1f} krylov-iters/step, heat "
        f"{s[:, 0].mean():.1f} cg-iters/step"
        f"{launch_text(launched, n_steps + 1)}){vs}; {ramp_note(heat)}")
    return {"ms_per_step": 1e3 * per, "vs_baseline_measured": ratio,
            "fp_per_step": float(s[:, 2].mean()),
            "krylov_per_step": float(s[:, 4].mean()),
            "heat_cg_per_step": float(s[:, 0].mean()),
            "launches": launched, "heat_ramp": bool(
                heat.bc.dirichlet_boundaries)}


# --------------------------------------------------------------------------- #
# 5. the matvec roofline at cavern600 (bench.py:bench_matvec)
# --------------------------------------------------------------------------- #
def bench_matvec(eq, roof, seed=0):
    """The cumsum stiffness action in f32 and f64 and the band kernel in
    f32 on ``eq``'s mesh, with bench.py's byte count.  Returns the band
    launches; raises on the card when the band kernel is not selected or
    did not run."""
    kern, device = eq.kernel, eq.device
    E, N = kern.n_elems, kern.n_nodes
    out = {}
    for dtype, fbytes, iters in ((torch.float32, 4, 200),
                                 (torch.float64, 8, 50)):
        CT = kern.prep(eq.mat.C.to(dtype))
        u = torch.as_tensor(np.random.default_rng(seed).normal(size=(N, 3)),
                            dtype=dtype, device=device)
        ms = call_ms(lambda: kern.matvec(CT, u), iters, device)
        name = str(dtype).split(".")[-1]
        out[f"cumsum_{name}"] = ms
        log(f"matvec[cumsum {name}]: {1e3 * ms:.1f} us "
            f"({3 * N / ms / 1e3:.0f} MDOF/s, "
            f"{roof(matvec_bytes(E, N, fbytes), ms)})")
    band = kern.band
    if band is None:
        if device.type == "cuda":
            raise RuntimeError("matvec: the band kernel is not selected on "
                               "the card")
        log("matvec[band f32]: no band kernel on the CPU (the plain twin is "
            "not timed)")
        return {"launches": {}, "ms": out}
    before = band.launches
    op = band.operator(band.pack_ct(kern.prep(eq.mat.C.to(torch.float32))))
    u = torch.as_tensor(np.random.default_rng(seed).normal(size=(N, 3)),
                        dtype=torch.float32, device=device)
    ms = call_ms(lambda: op(u), 500, device)
    out["band_float32"] = ms
    log(f"matvec[band f32]: {1e3 * ms:.1f} us ({3 * N / ms / 1e3:.0f} "
        f"MDOF/s, {roof(matvec_bytes(E, N, 4), ms)})")
    return {"launches": {"band_matvec": need_launch(
        "matvec", device, band.launches - before)}, "ms": out}


# --------------------------------------------------------------------------- #
# 6. the coupled TM configuration on cavern600 (bench.py:bench_tm)
# --------------------------------------------------------------------------- #
def tm_material(n, device=None, pkg=sc):
    """bench.py's thermo-mechanical material (bench_tm): Spring +
    Kelvin-Voigt + dislocation creep + pressure-solution creep +
    Thermoelastic, cp 850 J/kg/K, k 7 W/m/K."""
    one = np.ones(n)
    dev = on(pkg, device)
    mat = pkg.Material(n, **dev)
    mat.set_density(2200.0 * one)
    mat.add_to_elastic(pkg.Spring(102e9 * one, 0.3 * one))
    mat.add_to_non_elastic(pkg.Viscoelastic(105e11 * one, 10e9 * one,
                                            0.32 * one, **dev))
    mat.add_to_non_elastic(pkg.DislocationCreep(
        1.9e-20 * one, 51600 * one, 3.0 * one, name="ds_creep", **dev))
    mat.add_to_non_elastic(pkg.PressureSolutionCreep(
        1e-22 * one, 1e-2 * one, 51600 * one, name="ps_creep", **dev))
    mat.add_to_thermoelastic(pkg.Thermoelastic(44e-6 * one, **dev))
    mat.set_specific_heat_capacity(850.0 * one)
    mat.set_thermal_conductivity(7.0 * one)
    return mat


def tm_equations(grid, wall="Cavern", device=None, pkg=sc, solver=None,
                 heat_precision="mixed", eq_kw=None, **settings):
    """bench.py's thermo-mechanical configuration on ``grid``: the
    benchmark's mechanical loads (:func:`bench_bcs`), :func:`tm_material`,
    initial T 298 K, a Dirichlet ramp 298 -> 293 K over 12 h on TOP (the
    mesh's name for the face bench.py calls "Top"; "Top" where the mesh
    has no TOP) and a Robin wall (h = 5 W/m2/K, 298 -> 283 K over 24 h) on
    ``wall``.  The momentum solver is ``solver``, else :data:`SETTINGS`
    with ``settings``.  Returns (momentum equation, heat equation)."""
    dev = on(pkg, device)
    eq = pkg.LinearMomentum(grid, theta=0.5, **dev, **(eq_kw or {}))
    eq.set_solver(solver or pkg.SolverSettings(**SETTINGS, **settings))
    mat = tm_material(eq.n_elems, device, pkg)
    eq.set_material(mat)
    eq.build_body_force([0.0, 0.0, 0.0])
    bench_bcs(eq, pkg)
    heat = pkg.HeatDiffusion(grid, **dev)
    heat.set_solver(pkg.SolverSettings(method="cg", rtol=1e-12, max_it=400,
                                       precision=heat_precision))
    heat.set_material(mat)
    heat.set_initial_T(298.0 * np.ones(grid.n_nodes))
    heatBC = pkg.HeatBC
    bc_h = heatBC.BcHandler(heat)
    names = grid.get_boundary_names()
    top = "TOP" if "TOP" in names else "Top"
    if top in names:
        bc_h.add_boundary_condition(heatBC.DirichletBC(
            top, [298., 293., 293.], [0.0, 12 * DT, 1e12]))
    if wall in names:
        bc_h.add_boundary_condition(heatBC.RobinBC(
            wall, [298., 283., 283.], 5.0, [0.0, 24 * DT, 1e12]))
    heat.set_boundary_conditions(bc_h)
    return eq, heat


def bench_tm(eq_mech, n_tm=20):
    """bench.py's second configuration on the benchmark mesh
    (:func:`tm_equations` with ``eq_mech``'s solver; no Desai), driven by
    the fused TM driver.  A step that fails is retried at dt/2, /4, /8
    (bench.py's flow); raises when dt/8 fails."""
    device = eq_mech.device
    eq, heat = tm_equations(eq_mech.grid, "Cavern", device,
                            solver=eq_mech.solver)
    init_tm(eq, heat)

    def run_tm(ts_list, dts_list):
        rows, retries = [], 0
        pending = list(zip(ts_list, dts_list))
        while pending:
            stats = eq.solve_tm_time_steps(heat, [p[0] for p in pending],
                                           [p[1] for p in pending],
                                           tol=1e-6, maxiter=20)
            n_ok = int((stats[:, 5] > 0.5).astype(int).cumprod().sum())
            rows.extend(stats[:n_ok])
            if n_ok == len(pending):
                break
            t_f, d_f = pending[n_ok]
            for cut in (2, 4, 8):
                sub = eq.solve_tm_time_steps(heat, [t_f], [d_f / cut],
                                             tol=1e-6, maxiter=20)
                retries += 1
                if sub[0, 5] > 0.5:
                    rows.append(sub[0])
                    break
            else:
                raise RuntimeError(f"TM step at t={t_f / 3600:.0f}h failed "
                                   f"at dt/8")
            pending = pending[n_ok + 1:]
        return np.asarray(rows), retries

    before = launches_of(eq.kernel)
    t0 = time.perf_counter()
    run_tm([DT], [DT])
    sync(device)
    log(f"TM first fused step (incl. first use): "
        f"{time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    stats, retries = run_tm([(k + 2) * DT for k in range(n_tm)],
                            [DT] * n_tm)
    sync(device)
    per = (time.perf_counter() - t0) / len(stats)
    launched = moved("tm", eq, before)
    log(f"TM config (fused driver): {per * 1e3:.1f} ms/step over "
        f"{len(stats)} steps ({stats[:, 2].mean():.2f} fp-iters/step, "
        f"{stats[:, 4].mean():.1f} krylov-iters/step, heat "
        f"{stats[:, 0].mean():.1f} cg-iters/step, {retries} dt-retries, "
        f"err={stats[-1, 3]:.1e}{launch_text(launched, n_tm + 1)}); "
        f"{ramp_note(heat)} (bench.py asks for 'Top', which this mesh "
        f"lacks, and skips the ramp)")
    return {"ms_per_step": 1e3 * per, "retries": retries,
            "launches": launched}


# --------------------------------------------------------------------------- #
# 7. the per-step host-sync loop (bench.py:bench_hostsync)
# --------------------------------------------------------------------------- #
def bench_hostsync(eq, n_steps=20):
    """The reference-style loop: ``solve_time_step`` then
    ``commit_time_step``, one step per call, from t = (3 n + 2) h on; raises
    on a step that does not converge."""
    device = eq.device
    t_base = (3 * n_steps + 2) * DT
    before = launches_of(eq.kernel)
    t0 = time.perf_counter()
    ite, err = eq.solve_time_step(t_base, DT, tol=1e-8, maxiter=40)
    sync(device)
    log(f"first per-step solve (incl. first use): "
        f"{time.perf_counter() - t0:.2f}s, iters={ite}, err={err:.2e}, "
        f"krylov_total={eq.krylov_total}")
    eq.commit_time_step(DT)
    iters_total = kry_total = 0
    t0 = time.perf_counter()
    reads = tracing.count_of("read")
    for k in range(n_steps):
        ite, err = eq.solve_time_step(t_base + (k + 1) * DT, DT,
                                      tol=1e-8, maxiter=40)
        if not err <= 1e-8:
            raise RuntimeError(f"host-sync step {k + 1} did not "
                               f"converge: err={err:.3e}")
        iters_total += ite
        kry_total += eq.krylov_total
        eq.commit_time_step(DT)
    sync(device)
    elapsed = time.perf_counter() - t0
    reads = tracing.count_of("read") - reads
    launched = moved("hostsync", eq, before)
    log(f"{n_steps} steps (per-step host sync): {elapsed:.3f}s "
        f"({elapsed / n_steps * 1e3:.1f} ms/step, "
        f"{iters_total / n_steps:.2f} fp-iters/step, "
        f"{kry_total / n_steps:.1f} krylov-iters/step"
        f"{launch_text(launched, n_steps + 1)}), final err={err:.2e}, "
        f"last-solve res={eq.solver_stats[1]:.2e}, "
        f"{reads / n_steps:.1f} host reads/step")
    return {"ms_per_step": 1e3 * elapsed / n_steps, "launches": launched,
            "host_reads_per_step": reads / n_steps}


# --------------------------------------------------------------------------- #
def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", help="torch device (default: the card; "
                    "'cpu' runs on the CPU)")
    ap.add_argument("--sections", nargs="+", choices=SECTIONS,
                    default=list(SECTIONS),
                    help="sections to run, in the order of --help's list "
                    "(default: all)")
    ap.add_argument("--repeats", type=int, default=5,
                    help="timed windows from the saved state (default 5)")
    ap.add_argument("--steps", type=int, default=20,
                    help="steps of the warm-up chunk and of the timed window, "
                    "and of the TM and host-sync sections (default 20)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the matvec sections' random vectors")
    ap.add_argument("--lag-tangent", action="store_true")
    ap.add_argument("--adaptive-rtol", action="store_true")
    ap.add_argument("--backend", choices=("band", "blockell", "dia"),
                    help="force the benchmark equation's stiffness backend "
                    "(raises if it cannot be enabled)")
    args = ap.parse_args(argv)
    if args.repeats < 1 or args.steps < 1:
        ap.error("--repeats and --steps must be at least 1")
    return args


def main(argv=None):
    """Run the sections; prints the headline JSON line on stdout when the
    headline runs, and returns the summary dict (also on stderr)."""
    args = parse_args(argv)
    t_start = time.perf_counter()
    device = torch.device(args.device) if args.device \
        else sc.default_device()
    card = card_line(device)
    log(f"device: {device} | {card} | torch {torch.__version__}"
        + (f" CUDA {torch.version.cuda}" if device.type == "cuda" else "")
        + f" | host: {os.cpu_count()} CPUs, 1-min load average "
        f"{os.getloadavg()[0]:.2f}")
    roof = Roofline(device)
    want = [s for s in SECTIONS if s in args.sections]
    # the steps are host-bound, so the host's load is read at both ends
    summary = {"card": card, "sections": {}, "launches": {},
               "host_load": [os.getloadavg()[0]]}
    eq = None

    def count(result, name):
        summary["sections"][name] = result
        for k, v in result.get("launches", {}).items():
            summary["launches"][k] = summary["launches"].get(k, 0) + v

    def bench_eq():
        nonlocal eq
        if eq is None:
            eq = build(device, lag_tangent=args.lag_tangent,
                       adaptive_rtol=args.adaptive_rtol,
                       backend=args.backend)
            if "headline" not in want:
                elastic_start(eq)
        return eq

    for name in want:
        log(f"[t+{time.perf_counter() - t_start:.0f}s] section: {name}")
        if name == "headline":
            eq = bench_eq()
            log(f"dofs: {3 * eq.n_nodes}")
            res = headline(eq, args.steps, args.repeats)
            per_step = res["median_s"]
            line = {"metric": "newton_step_wallclock_cavern600",
                    "value": round(per_step, 5), "unit": "s/step",
                    "vs_baseline": round(REFERENCE_SECONDS_PER_STEP
                                         / per_step, 2)}
            r = measured_ratio("cavern600_mech", per_step)
            if r:
                line["vs_baseline_measured"] = round(r, 2)
                base = load_measured_baseline()["cavern600_mech"]
                log(f"vs measured CPU baseline {base['s_per_step']:.4f} "
                    f"s/step = {r:.1f}x ({base['notes']})")
            log(f"card: {card}")
            print(json.dumps(line), flush=True)
            count(res, name)
        elif name == "scale":
            count(bench_matvec_scale(device, roof, seed=args.seed), name)
        elif name == "tm_cyclic":
            runs = {}
            for grid_name, fb, label, key in TM_CYCLIC:
                log(f"[t+{time.perf_counter() - t_start:.0f}s] {label}")
                runs[label] = bench_tm_cyclic(grid_name, fb, label, key,
                                              device)
            count({"launches": {k: sum(r["launches"].get(k, 0)
                                       for r in runs.values())
                                for k in ("band_matvec", "dia_matvec")},
                   "configs": runs}, name)
        elif name == "matvec":
            count(bench_matvec(bench_eq(), roof, seed=args.seed), name)
        elif name == "tm":
            count(bench_tm(bench_eq(), n_tm=args.steps), name)
        elif name == "hostsync":
            count(bench_hostsync(bench_eq(), n_steps=args.steps), name)
    summary["seconds"] = time.perf_counter() - t_start
    summary["host_load"].append(os.getloadavg()[0])
    log("bench_torch summary " + json.dumps(summary, default=float))
    return summary


if __name__ == "__main__":
    main()
