"""Smoke run of the PyTorch/CUDA port (safeincave_torch) on one GPU, and
of its parallel layer on four.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is non-zero:

1. device  - the card (nvidia-smi name, power limit) and torch/CUDA versions.
2. build   - nvcc builds the band, block-DIA and symmetric dense kernels from
             safeincave_torch/csrc/, one process each, in parallel; the host
             compiler builds native/mesh_preprocess.cpp (Morton / RCB
             ordering), which must load: the numpy versions are for
             machines without a compiler.
3. kernel  - each kernel against its plain PyTorch twin on a random
             energy-symmetric tangent, at every shape it is measured at:
             the band matvec at cavern_proxy_600 (the main path), at the
             band-ordered GridBox nx=44 (bench.py's scale size), at the
             band-ordered 38k-tet cavern_interlayer_1200 mesh (the yearly
             path) and at the band-ordered cavern_proxy_1200 and
             cavern_interlayer_proxy (phase 18's meshes), 2e-5 max|ref|;
             the f32 DIA matvec at the box path's nx=17 and at nx=44, 1e-5
             max|ref|, and the f64 DIA matvec at nx=17, 1e-12; the dense
             preconditioner's packed symmetric apply at cavern600's and
             cavern_interlayer_1200's 3N on a random matrix, 1e-5 max|ref|,
             with ``torch.mv`` on the full matrix (the gemv it replaced) as
             its ``library_ms``.
             Bitwise repeatability and energy symmetry.  Per kernel and
             shape: ``ms`` (the wrapper call, CUDA events over 200 calls),
             ``device_ms`` (the kernels' own time per call, torch.profiler,
             the L2 cache flushed by a 128 MB read before each call, as
             the Krylov loop's preconditioner apply leaves it;
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
             outputs are ``SaveFields`` writing XDMF/HDF5 files into a
             temporary directory through the port's own HDF5 writer (the
             machine has no h5py), read back through the port's postproc:
             the saves at the expected times, the last one equal to the
             fields in memory bit for bit.  Every step converged,
             the band kernel launched in each stage, final fields within
             1e-6 max|ref| of tests/golden/torch_port_sim_cavern600.npz,
             equal converged flags, fixed-point counts within +-1; the
             smoother repeats bitwise; the last checkpoint, loaded into a
             fresh equation, runs 2 more steps to the straight run's state
             bit for bit.  Prints ms/step per stage, the driver's share of
             stage 2 (time outside ``solve_time_steps``), band launches per
             step, the saves' host ms per save and .h5 bytes, and one
             checkpoint's save time.
9. json    - the JSON driver: ``safeincave_torch.app.sim_cli.main`` in a
             child process on the card (``--json-child``), on
             ``torch_port_configs.box_case`` over ``box_mesh(600, 600, 800,
             nx=17)`` written with the port's ``write_msh`` (natural order:
             block-DIA auto-selected, dense preconditioner, f32 sweep on).
             The child writes the case's XDMF/HDF5 outputs and prints its
             DIA launch count and its timed saves on its last line.  Exit
             0, DIA launched, operation-stage u and p_elems within 1e-6
             max|ref| of tests/golden/torch_port_json_box17.npz; the
             operation's u and p_elems files read back at 0-4 h, the last
             save equal to the child's fields bit for bit.
10. tm     - bench.py's thermo-mechanical configuration
             (``torch_port_configs.wire_tm``: Spring, Kelvin-Voigt,
             dislocation and pressure-solution creep, ``Thermoelastic``; a
             Dirichlet ramp on TOP and a Robin wall on "Cavern" for the heat
             equation, mixed-precision CG at rtol 1e-12) through
             ``Simulator_TM`` on the band-ordered cavern600 mesh: 24 steps
             at 1 h in fused chunks, u and T saved every 6 steps, a
             checkpoint with the heat keys at step 12 (``CheckpointSink``,
             an output that writes the checkpoint).  u and T are written
             as files and read back as in phase 8.  Every step
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

12. lag    - phase 4's cavern600 main path (bench material, band kernel,
             dense preconditioner, sweep off) three ways, one after the
             other in this process, each a 3-step warm-up chunk, then two
             timed 5-step chunks with the ways in turns: default, ``lag_tangent=True``,
             ``adaptive_rtol=True``.  Per way: ms/step, fixed-point
             iterations, tangent builds, Krylov iterations and band
             launches per step, rollbacks.  Every step converged; the
             lagged and adaptive u and sig_v within 2e-7 max|ref| of the
             default's; each flagged way within 1e-6 max|ref| of its JAX
             golden (tests/golden/torch_port_{lag,adaptive}_cavern600.npz),
             fixed-point counts within +-1 of it; the default way's 3-step
             state against torch_port_cavern600.npz as phase 5 holds it.
13. yearly - examples/mechanics/nobian_yearly ``--full`` on the port,
             built by the twin's ``build(full=True)``
             (safeincave_torch/examples/mechanics/nobian_yearly/main.py;
             the stages by ``torch_port_configs.yearly_*``, the sweep
             off): the band-ordered 38k-tet
             cavern_interlayer_1200 mesh (7,669 nodes), the region-masked
             material (Spring, Kelvin-Voigt, dislocation creep in the salt,
             Mohr-Coulomb in the interlayers), precond "auto", sweep off;
             the equilibrium stage (30 days at 5 days), then the first 4
             days of data/operational_year.csv at 6 h through
             ``Simulator_M`` in fused chunks with u and q_elems saved every
             8 steps (files, read back as in phase 8), StepMetrics and one
             checkpoint at step 16.  The band
             kernel and the dense preconditioner must be selected; prints
             the dense inverse's bytes and build time.  Every step
             converged, fields within 1e-6 max|ref| of
             tests/golden/torch_port_yearly_1200.npz, fixed-point counts
             within +-1, the saves and the checkpoint where expected.
14. order  - cavern600 under four node orders with the bench material:
             as the JSON driver loads it (no ``reorder``) on the cumsum
             operator, the same with ``enable_blockell_matvec()``,
             ``reorder="morton"`` with block-ELL, and band order with the
             band kernel.  Per way: ms/step in two 5-step chunks after a
             3-step one, the ways in turns, fixed-point and Krylov
             iterations per step, K and
             the f64 block tensor's bytes; u and sig_v, brought back to the
             file's node and element order, within 1e-8 max|ref| of the
             first way's.
15. point  - calibrate_creep.py's fit (300 Adam steps through the
             closed-form model) and one ``TriaxialSimulator.run_compression``
             of calibrate_triaxial.py's twin (81 times, two confinements) on
             the card: ms per ``calibrate`` step, fitted parameters within
             1e-6 and the loss history within 1e-6 relative of
             tests/golden/torch_port_point.npz, the twin's histories within
             1e-9 max|ref|.

16. halo   - the parallel layer, last (it profiles, and the profiler leaves
             a cost on every later launch of its process).  The cavern600
             main path (phase 4's configuration, sweep off) converted by
             ``shard_equation(eq, make_device_mesh(8), mode="halo")``: all 8
             parts stacked on the card in this process (no process
             group), S=507, H=163, R=6 checked, the
             ``halo_two_level`` preconditioner, no band or DIA launch on
             the sharded equation; elastic response, a 3-step chunk, then a
             5-step chunk in turns with the unsharded run of the same
             configuration.  Against tests/golden/torch_port_halo_cavern600
             .npz (JAX ``shard_equation`` over 8 virtual CPU devices):
             elastic u 1e-8 relative, 3-step u and sig_v 1e-6 max|ref|,
             fixed-point counts +-1; against the unsharded 3 steps: u rtol
             1e-8 (atol 1e-13 m), sig_v rtol 1e-8 (atol 0.1 Pa).  Then box17
             (phase 6's configuration) in 4 parts with ``mode="psum"``
             against its unsharded run over 3 steps, the same criteria;
             ``shard_tm`` of ``wire_tm`` on cavern600 in 4 parts, 2 fused
             steps, against the unsharded pair (T rtol 1e-10 atol 1e-8, u
             rtol 1e-8); and the app layer: ``InputFileBuilder`` writes and
             validates a 2-step case over box_mesh(nx=3),
             ``SimulatorRunner`` runs it in a child ``sim_cli`` on the card
             (exit 0, streamed step rows, the child's u file read back
             through postproc with saves at 0, 1 and 2 h).  Per way
             (halo, psum, unsharded): ms/step, fixed-point and Krylov
             iterations per step, device launches per f64 and f32 matvec
             (torch.profiler) and rows received per matvec, each line with
             the card's name and power limit.

17. examples - the examples tree on the card: each twin of
             safeincave_torch/examples through its ``main`` with
             ``device`` the card, in a temporary working directory, at its
             own mesh and material and the arguments of
             ``torch_port_configs.EXAMPLE_RUNS``: each script's defaults
             but nobian_yearly, at its documented CI scale ("--dt-days 2",
             the generated cavern; phase 13 runs ``--full``) cut in depth
             from 365 to 120 days, then ``--resume`` from its step-32
             checkpoint, and thermomechanics/2_cavern, on a stand-in for
             the reference's overburden mesh
             (``torch_port_configs.overburden_standin``, written into the
             temporary directory) with its operation cut from 240 to 40
             days; its Morton order leaves it on the cumsum operator, no
             hand kernel.  The f32 sweep is off, as in phases 8, 12 and 13:
             on CUDA the scripts' "auto" turns it on, and on 1_triaxial it
             changes the fixed-point counts and makes steps retry (PERF.md
             section 7).  Per example: every step
             converged, the files where the JAX script puts them (.xdmf
             beside .h5, log.txt, ksp_log.jsonl, metrics.jsonl,
             checkpoint.npz), the fields read back through postproc
             within 1e-6 max|ref| of
             tests/golden/torch_port_examples_<name>.npz (the JAX example
             on the CPU at the same arguments), the save times equal, the
             fixed-point counts within +-1, the DIA kernel launched in
             1_triaxial, 2_cube_regions, thermomechanics/1_cube,
             nobian_interlayer and nobian_yearly (the generated cavern is
             in natural order).  The calibrations: calibrate_creep (300
             Adam steps) and calibrate_labdata (400) through ``main``,
             calibrate_triaxial and calibrate_multimodel with their Adam
             steps cut to ``TRIAXIAL_FIT_STEPS`` / ``MULTIMODEL_STEPS``
             (a step takes ~20 s and ~4 s on the card: 250 and 400 of them
             would take hours); the fitted parameters within 1e-6 relative
             of the golden.  Each line: ms/step (or s per fit), the kernel's
             launches per step, ms per save and .h5 bytes, the card's name
             and power limit.  Last, 1_triaxial once more at its defaults
             with the f32 sweep forced on, against
             tests/golden/torch_port_examples_triaxial_sweep.npz (the JAX
             script with the sweep forced on): every step converged, each
             final field within ``TRIAX_SWEEP_SPREAD`` times the JAX
             package's own spread of it under a round-off change (its
             jacobi run beside the 2level one: with the sweep on the
             script's fields move by 1.6e-3 to 6.9% of max|ref| in the
             JAX package itself); the dt halvings, the sweeps run and
             accepted and the fixed-point counts beside the golden's are
             reported.  Runs before phase 18.
18. tm_cyclic - bench.py's three TM-cyclic configurations (BASELINE
             configs 4-5; ``torch_port_configs.tm_cyclic``, a line-for-line
             twin of bench.py's ``build_tm_cyclic``): regular1200 on
             cavern_proxy_1200 (Kelvin-Voigt + dislocation creep),
             interlayer600 on cavern_interlayer_proxy and interlayer1200 on
             cavern_interlayer_1200 (dislocation creep in the salt,
             Mohr-Coulomb interlayers), band order, built with the port's
             CUDA "auto" choices: the band kernel and the dense
             preconditioner must be selected.  Each path runs twice, in
             turns: the elastic response, the first coupled step alone,
             then 10 steps in chunks of 2 (``solve_tm_time_steps``, dt 1 h,
             tol 1e-6, 20 iterations), as bench_tm_cyclic drives them.
             With the f32 sweep off the run is held to
             tests/golden/torch_port_tmcyc_<path>.npz (the JAX package on
             the CPU, 2level, cumsum, 11 steps): elastic u at 1e-8
             relative, convergence flags equal, fixed-point counts within
             1, u, T and sig_v after step 1 and u, T, p and q after step 11
             within ``TMCYC_SPREAD`` times the JAX package's own spread
             between its 2level and dense preconditioners (stored in the
             golden), at most 1e-5 max|ref|.  With "auto" (the sweep on)
             every step must converge where the golden's did; its fields'
             distance from the sweep-off run is reported.  Per path and
             way: ms/step (median of the chunks after the first step), the
             first step apart, fixed-point, Krylov and heat CG iterations
             per step, band launches per step, sweeps run and accepted,
             peak device memory, and the ratio to baseline_measured.json's
             1-core CPU JAX row.  Runs after phase 17, before phase 16.
19. bench  - ``python3 bench_torch.py`` (the port's counterpart of
             bench.py) in a child process on the card, every section but
             TM-cyclic (phase 18 runs those three configurations twice; the
             script stays inside its time): the cavern600 headline
             (elastic response, warm-up steps 1-20, then steps 21-40 in 5
             repeats from one saved state), the scale roofline on the
             natural-order GridBox nx=44 (the streaming ceiling, the f32
             and f64 DIA kernel, assembly, cumsum), the cavern600 matvec
             roofline (cumsum f32 and f64, band f32), the coupled TM
             configuration on cavern600 and the per-step host-sync loop
             (~60-95 s).
             Exit 0, exactly one stdout line with bench.py's keys, every
             section run, the same fixed-point and Krylov counts in every
             repeat, the band kernel launched in the headline and the DIA
             kernel in the scale section.  Echoes the child's lines and
             repeats the headline's median, min, max and counts on a line
             of its own.
20. gpu_tests - tests/test_torch_kernels_gpu.py and
             tests/test_torch_heat_graphs.py with the ``gpu`` marker in
             a child pytest on the card (``--noconftest``: tests/conftest.py
             imports JAX, which the card's machine lacks); any failure or
             skip, or no test run, fails the phase.  Phases 19 and 20 run
             after phase 18, before phase 16.
21. conformance - the port against the original SafeInCave stack and the
             JAX package's remaining snapshots, through the port alone
             (``torch_port_configs.oracle_cube``, ``cavern_box`` and
             ``interlayer_tm``; no JAX, nothing of
             tests/golden_configs.py): the oracle cube of
             tests/test_reference_oracle.py (elastic response and one
             step; tests/files/expected_values_equations/
             expected_values.json on sorted magnitudes, u 5e-7, eps_tot
             5e-6, alpha 2e-6, u_1 more than 1.0 from u_0, and
             tests/golden/torch_port_oracle_cube.npz entry for entry at
             1e-8 max|ref| with the same iteration count), and
             tests/golden/fields.npz's ``cavern_*`` (three steps of
             golden_configs.py's ``run_mechanics`` loop) and ``inter_*``
             (three coupled steps) at tests/test_golden_fields.py's
             1e-8.  Each case runs pinned to the settings the references
             were made with (2level, the cumsum operator, no f32 sweep;
             no hand kernel may launch),
             gated at those tolerances, then with the CUDA "auto" choices
             (dense preconditioner, the f32 sweep, block-DIA where the
             numbering allows), whose distances, seconds and kernel
             launches are printed and not gated; the fields of an "auto"
             run more than 1e-6 of max|ref| from their reference are
             listed.  Last, the Python blocks of docs/MIGRATION_TORCH.md
             run once with ``device="cuda"``.  Runs after phase 20.

22. graphs - the captured time step (fem/graphs.py) against the same
             functions under ``graphs.eager()``, three configurations:
             cavern600 with the sweep off (phase 4's), the headline
             configuration (cavern600, precond and sweep "auto", as
             bench_torch.py builds it) and box17 (phase 6's).  Per
             configuration two equations, one captured and one eager, from
             their own elastic solves: steps 1-3 held to the golden of
             phase 5 (cavern600, both cavern ways) or 7 (box17) as those
             phases hold it, then three timed 3-step chunks with the two
             in turns.  After every chunk: equal fixed-point and Krylov
             counts, every field and state within 1e-12 of max|ref|
             (bitwise reported).  Then a fresh cavern600 equation, captured,
             at Krylov block sizes 1, 2, 4 and 8 in turns (ms/step, ms per
             solve, host reads and Krylov iterations per step), and last
             two profiled steps of each equation (torch.profiler: device
             idle share, device operations per step).  Per configuration
             and mode: ms/step, ms per tangent build and per linear solve
             (CUDA events around each call), host reads per step (the
             tensor read methods patched), graph replays and band/DIA
             launches per step, the card's name and power limit.  Runs
             after phase 21, before phase 16.

23. band64 - the band kernel's f64 action (``BandMatvec.operator64``, the
             defect-correction residual's operator on band-ordered meshes)
             at cavern_proxy_600, cavern_proxy_1200 and
             cavern_interlayer_1200 (3N = 10,080, 20,448 and 23,007) on a
             random energy-symmetric tangent: against the plain twin in
             f64 (1e-13 max|ref|), bitwise repeatable, energy symmetry;
             ``device_us`` per call (torch.profiler, every kernel of the
             call, the L2 flushed before each), ``bound_us`` (8 (48 E +
             6 N) bytes over 3.35 TB/s), ``pct_of_bound``, ``wrapper_us``
             (CUDA events), and beside it the device time of the cumsum
             matvec it replaces (``MomentumKernel.matvec`` in f64) and of
             that chain's scan; the registers and spills ptxas reports for
             the f64 kernels; then the f64 tests of
             tests/test_torch_kernels_gpu.py (``-k f64``) in a child.
             Runs after phase 22, before phase 16 (it profiles).

Phase 9 runs its case twice, with the f32 sweep as "auto" selects it and
with ``fp32_phase=False``, and prints both lines.

    python3 chip_smoke.py --phase cards

needs 4 visible cards (it exits non-zero and says so with fewer) and runs
the parallel layer with one rank per card: ``parallel.launch`` spawns 4
ranks over NCCL (group timeout 600 s, launch timeout 840 s: a hang fails
the phase), and each runs the ways of ``CARD_WAYS``:

    (a) cavern600 halo, D=8 parts on W=4 ranks, against
        tests/golden/torch_port_halo_cavern600.npz as phase 16 holds it
        (elastic u 1e-8 relative; 3-step u and sig_v 1e-6 max|ref|;
        fixed-point counts +-1);
    (b) cavern600 halo, D=4 on W=4;  (c) box17 psum, D=4 on W=4 (dense
        preconditioner, f32 sweep "auto");  (d) ``shard_tm`` of ``wire_tm``
        on cavern600, D=4 on W=4, 2 fused steps;  (e) the 38k-tet
        cavern_interlayer_1200 mesh (band order, the bench material and
        loads) halo, D=4 on W=4, one fused step.

Every way is held against the stacked run of the same D on rank 0's card
(``make_device_mesh(D, stacked=True)``), in turns within the call: after the
warm-up chunk and after the timed chunks, u, sig_v (and T) within rtol
1e-10 (atol 1e-10 max|ref|), fixed-point counts equal, and u the same bits
on every rank.  Per way: ms/step (median of 3 chunks after the warm-up
chunk, the stacked run in turns), fixed-point and Krylov iterations per
step, ms per f64 and f32 matvec (CUDA events, 50 calls, every rank in
step), the bytes and inter-rank rounds of one f64 matvec on rank 0, the
rows each rank sends per matvec, peak memory per card; and ms per
all-reduce of one f64 and per inter-rank round (60 x 3 f64 rows with one
peer), CUDA events over 200 calls, at the start and the end; each line with
every card's name and power limit.  No ``ok`` line.

The last lines are the kernel JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``.  There is no CPU fallback: without a CUDA
device the script exits non-zero before printing any result.

    python3 chip_smoke.py --tree DIR

runs phase 3 alone on the ``safeincave_torch`` package of another checkout
(DIR holds its ``safeincave_torch/`` and ``tests/``), to time two designs of
the kernels in turns within one call; it prints the kernel JSON and the
card, and no ``ok`` line.

    python3 chip_smoke.py --phase tm|tm_box|lag|yearly|order|point|examples|tm_cyclic|bench|gpu_tests|conformance|graphs|band64|halo

builds the kernels and runs that phase alone (no ``ok`` line).
"""
import argparse
import contextlib
import dataclasses
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
KERNELS = ("band_matvec", "dia_matvec", "sym_dense_matvec")
# H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12               # float32 outside the tensor cores
BAND = dict(name="band_matvec_f32", route="cuda",
            source="safeincave_torch/csrc/band_matvec.cu",
            replaces="safeincave_tpu/fem/bandkernel.py:74")
DIA = dict(name="dia_matvec_f32", route="cuda",
           source="safeincave_torch/csrc/dia_matvec.cu",
           replaces="safeincave_tpu/fem/dia.py:301")
SYM = dict(name="sym_dense_matvec_f32", route="cuda",
           source="safeincave_torch/csrc/sym_dense_matvec.cu",
           replaces="none: the dense preconditioner's gemv",
           library="torch.mv on the full inverse")


# the path whose launches a kernel row of each mesh reports (else the
# kernel's first path)
OWN_PATH = {"cavern_interlayer_1200": "yearly",
            "cavern_proxy_1200": "tmcyc_regular1200",
            "cavern_interlayer_proxy": "tmcyc_interlayer600"}


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
        # lines, as the preconditioner's apply leaves it in the Krylov loop;
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
    library call of the same operator (``what["library"]``, by default the
    cuSPARSE SpMV) held and timed beside it."""
    err, scale, sym, ms, plain_ms = hold(f"{what['name']} {shape}", kernel,
                                         plain, u, v, tol)
    x = u.reshape(-1)
    lib = what.get("library", "cuSPARSE")
    lib_err = (A @ x - plain(u).reshape(-1)).abs().max().item()
    if not lib_err <= tol * scale:
        raise AssertionError(f"{lib} operator at {shape} differs from "
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
                  f"{plain_ms:.4f} ms; {lib} {row['library_ms']:.4f} ms, "
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

    shapes = [("cavern600", cfg.cavern600_grid(st)),
              ("box nx=44 band order", reordered_grid(box(44), "band")[0])]
    if hasattr(cfg, "yearly_grid"):     # absent from an older --tree
        shapes.append(("cavern_interlayer_1200", cfg.yearly_grid(st)))
    if hasattr(cfg, "TM_CYCLIC"):       # absent from an older --tree
        shapes += [(cfg.TM_CYCLIC[p][1],
                    cfg.band_grid(st, *cfg.TM_CYCLIC[p][:2]))
                   for p in ("tmcyc_regular1200", "tmcyc_interlayer600")]
    sym_sizes = {}
    for shape, grid in shapes:
        E, N = grid.n_elems, grid.n_nodes
        if shape in ("cavern600", "cavern_interlayer_1200"):
            sym_sizes[shape] = 3 * N
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

    try:
        from safeincave_torch.fem import symdense
    except ImportError:                 # absent from an older --tree
        sym_sizes = {}
    for shape, n in sym_sizes.items():
        # a random symmetric matrix of the dense preconditioner's size,
        # packed; the yardstick is the gemv the port ran before
        g = torch.Generator(device=dev).manual_seed(n)
        inv = torch.randn((n, n), generator=g, device=dev)
        sym = symdense.SymDense(inv)
        full = 0.5 * (inv + inv.T)
        del inv
        index = tuple(torch.as_tensor(a, device=dev)
                      for a in symdense.chunk_index(n))
        rows.append(measure(
            timer, SYM, f"{shape} (3N={n})", sym,
            lambda x: symdense.sym_dense_plain(sym.tiles, n, x, index),
            full, *(torch.randn(n, generator=g, device=dev)
                    for _ in range(2)), 1e-5,
            4 * n * (n + 1) // 2 + 2 * 4 * n, 2 * n * n))
        del sym, full, index
        torch.cuda.empty_cache()

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


def chunks_in_turns(eqs, chunks):
    """Append two timed 5-step chunks per equation to ``chunks[way]``, the
    ways in turns.  Every way has run its 3-step warm-up chunk by now, so
    none pays the process's first use of an operation for the others."""
    for t_first in (4 * HOUR, 9 * HOUR):
        for way, eq in eqs.items():
            chunks[way] += run_chunks(eq, t_first, (5,))


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


@contextlib.contextmanager
def timed_saves(st):
    """While active, each ``SaveFields.save_fields`` call that writes
    appends its host seconds to the returned list: the device synchronised
    first, then the fields' ``.cpu()`` fetches and the HDF5 writes and
    flushes.  Subclasses that call ``super().save_fields`` are timed too."""
    import torch
    cls = st.SaveFields
    real = cls.save_fields
    secs = []

    def save_fields(self, t):
        if self._call_count % self.save_every:
            return real(self, t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(self, t)
        secs.append(time.perf_counter() - t0)
        return out
    cls.save_fields = save_fields
    try:
        yield secs
    finally:
        cls.save_fields = real


def h5_bytes(folder):
    """Bytes of the .h5 files under ``folder``."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(folder) for f in files
               if f.endswith(".h5"))


def save_note(saves, folder):
    """The output layer's numbers of a run: saves, host ms per save and
    the bytes of its .h5 files."""
    ms = 1e3 * sum(saves) / max(len(saves), 1)
    return (f"{len(saves)} SaveFields writes at {ms:.2f} ms per save (host: "
            f"synchronise, .cpu() fetch, HDF5 write and flush), "
            f"{h5_bytes(folder)} bytes of .h5")


def read_back(st, out, holders=None):
    """Read an output's files back through the port's postproc: returns the
    save times, and raises unless each field's last save equals the field
    in memory bit for bit (``holders`` maps a field to the object holding
    it; default the output's equation)."""
    times = None
    for field, _ in out.fields:
        t, v, _, _ = st.PostProcessingTools.read_timeseries(
            out.output_folder, field)
        obj = (holders or {}).get(field, out.eq)
        want = getattr(obj, field).detach().cpu().numpy()
        got = v[-1].reshape(want.shape)
        if got.dtype != want.dtype or got.tobytes() != want.tobytes():
            raise AssertionError(
                f"{out.output_folder}/{field}: the last save read back "
                f"differs from the field in memory "
                f"({np.abs(got - want).max():.3e})")
        if times is not None and not np.array_equal(t, times):
            raise AssertionError(f"{out.output_folder}: fields saved at "
                                 f"different times")
        times = t
    return [float(x) for x in times]


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
        out = st.SaveFields(eq, save_every=every)
        out.set_output_folder(os.path.join(tmp, "sim", stage))
        for f in fields:
            out.add_output_field(f, f)
        metrics = st.StepMetrics(os.path.join(tmp, f"sim_{stage}.jsonl"))
        screen = io.StringIO()
        torch.cuda.synchronize()
        band.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(screen), timed_saves(st) as saves:
            tc = cfg.run_cavern_stage(st, eq, stage, [out], metrics=metrics,
                                      **extra)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        times = read_back(st, out)
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
        if not np.allclose(times, want, rtol=0, atol=1e-6):
            raise AssertionError(f"sim {stage}: saves at {times}, want "
                                 f"{want}")
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
                      f"chunks, saves, smoothing, metrics, checkpoints: "
                      f"{100 * (steps_ms - solve_ms) / steps_ms:.1f}%); "
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
                   f"times, read back through postproc, the last equal to "
                   f"the fields in memory bit for bit; "
                   + save_note(saves, out.output_folder))
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


class CheckpointSink:
    """Phase 10's harness for a checkpoint mid-run: an output (``SaveFields``'
    protocol) that saves no field but writes one checkpoint, heat field
    included, at its ``save_every``-th step; as an output it also makes the
    fused chunks end on that step."""

    fields = ()

    def __init__(self, st, path, eq, heat, tc, save_every):
        self.st, self.path, self.eq, self.heat, self.tc = \
            st, path, eq, heat, tc
        self.save_every = save_every
        self._calls = 0

    def set_output_folder(self, folder):
        pass

    def initialize(self):
        pass

    def save_mesh(self):
        pass

    def calls_until_next_keep(self):
        j = (1 - self._calls) % self.save_every
        return j if j else self.save_every

    def skip_calls(self, k):
        if k >= self.calls_until_next_keep():
            raise AssertionError("fused chunk crossed a save boundary")
        self._calls += k

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
    eq, heat = cfg.wire_tm(st, cfg.cavern600_grid(st), "Cavern",
                           precond="auto")
    band = eq.kernel.band
    if band is None:
        raise AssertionError("tm: band kernel not auto-selected on CUDA")
    tc = st.TimeController(dt=1.0, initial_time=0.0,
                           final_time=float(n_steps), time_unit="hour")
    outs = []
    for obj, field in ((eq, "u"), (heat, "T")):
        out = st.SaveFields(obj, save_every=every)
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
            recorded_tm_chunks(st, chunks, band), timed_saves(st) as saves:
        sim = st.Simulator_TM(eq, heat, tc, outs)
        sim.run()
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    times = [read_back(st, out) for out in outs[:2]]
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
    for out, got in zip(outs, times):
        if not np.allclose(got, want, rtol=0, atol=1e-6):
            raise AssertionError(f"tm: {out.fields[0][0]} saved at {got}, "
                                 f"want {want}")
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
              f"times, read back through postproc, the last equal to the "
              f"fields in memory bit for bit; "
              + save_note(saves, os.path.join(tmp, "tm")))

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
    out = st.SaveFields(heat_t, save_every=every)
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
              f"{read_back(st, out)} read back")
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


def json_child(case_path, result_path, sweep="auto"):
    """``--json-child``: run sim_cli on the case with the recording
    simulator; write the stage records to ``result_path`` and print the DIA
    launch count and the timed saves on the last line.  ``sweep="off"``
    makes the JSON driver's solver settings with ``fp32_phase=False``."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import safeincave_torch as st
    import safeincave_torch.config as config
    import torch_port_configs as cfg
    from safeincave_torch.app import sim_cli
    records = []
    config.Simulator_M = cfg.recording_simulator(st, records)
    if sweep == "off":
        config.SolverSettings = lambda **kw: st.SolverSettings(
            **{**kw, "fp32_phase": False})
    with timed_saves(st) as saves:
        sim = sim_cli.main(["--json", case_path])
    dia = sim.mom_eq.kernel.dia
    if dia is None or not dia.structured:
        raise AssertionError("json: block-DIA with the structured assembly "
                             "not auto-selected on the written box")
    data = {}
    for prefix, rec in zip(("eq", "op"), records):
        data.update({f"{prefix}_{k}": v for k, v in rec.items()})
    np.savez(result_path, **data)
    print(json.dumps({"dia_launches": dia.launches, "saves": saves}),
          flush=True)


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
    ref_it = np.concatenate([golden["eq_rows"], golden["op_rows"]])[:, 0]
    first = None
    for sweep in ("auto", "off"):
        result = os.path.join(tmp, f"json_result_{sweep}.npz")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--json-child", case, result, sweep],
                              capture_output=True, text=True, timeout=900)
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"json: sim_cli failed:\n"
                                 f"{proc.stdout[-3000:]}\n"
                                 f"{proc.stderr[-3000:]}")
        last = json.loads(proc.stdout.strip().splitlines()[-1])
        launches = last["dia_launches"]
        if launches <= 0:
            raise AssertionError("json: the DIA kernel never launched")
        got = np.load(result)
        rows = np.concatenate([got["eq_rows"], got["op_rows"]])
        if not (rows[:, 2] == 1).all():
            raise AssertionError(f"json: non-converged steps {rows.tolist()}")
        errs = {f: within(f"json operation {f}", got[f"op_{f}"],
                          golden[f"op_{f}"], 1e-6) for f in ("u", "p_elems")}
        out_op = os.path.join(tmp, "json_out", "operation")
        for f in ("u", "p_elems"):
            t, v, _, _ = st.PostProcessingTools.read_timeseries(out_op, f)
            if v[-1].tobytes() != got[f"op_{f}"].reshape(v[-1].shape) \
                    .tobytes():
                raise AssertionError(f"json: the last {f} save read back "
                                     f"differs from the field in memory")
        if not np.allclose(t, [0.0, HOUR, 2 * HOUR, 3 * HOUR, 4 * HOUR],
                           rtol=0, atol=1e-6):
            raise AssertionError(f"json: operation saves at {t}")
        say("json", f"sim_cli --json on box17 (write_msh -> read_msh, "
                    f"E=29478, N=5832) in a child process, f32 sweep "
                    f"{sweep}: exit 0 in {secs:.1f} s (process start, build "
                    f"load and both stages); {len(rows)} steps converged, "
                    f"fixed-point it {rows[:, 0].astype(int).tolist()} "
                    f"({rows[:, 0].mean():.2f}/step) vs golden "
                    f"{ref_it.astype(int).tolist()}; DIA launches "
                    f"{launches}, {launches / len(rows):.1f} per step; "
                    f"operation u {errs['u']:.2e}, p_elems "
                    f"{errs['p_elems']:.2e} vs golden (<=1e-6 max|ref|); "
                    f"operation u and p_elems read back through postproc at "
                    f"{len(t)} times, the last equal to the fields in "
                    f"memory bit for bit; "
                    + save_note(last["saves"], os.path.join(tmp, "json_out")))
        if first is None:
            first = (launches, launches / len(rows))
    return first


    return launches, launches / len(rows)


def dense_build_log(st):
    """Make every dense-preconditioner build of the port append (seconds,
    bytes of the inverse) to the returned list."""
    import torch
    mom = st.fem.momentum
    real, log = mom._dense_inverse_precond, []

    def timed(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inv = real(*args)
        torch.cuda.synchronize()
        log.append((time.perf_counter() - t0,
                    inv.numel() * inv.element_size()))
        return inv
    mom._dense_inverse_precond = timed
    return log


def need_band(tag, eq):
    """The equation's band operator; raises unless CUDA selected it and
    the dense preconditioner."""
    band = eq.kernel.band
    if band is None:
        raise AssertionError(f"{tag}: band kernel not auto-selected on CUDA")
    P, _ = eq._get_precond()
    if not (len(P) == 1 and P[0].shape[0] == 3 * eq.grid.n_nodes):
        raise AssertionError(f"{tag}: precond 'auto' did not resolve to "
                             f"dense")
    return band


def lag_phase(st, cfg):
    """Phase 12; returns (band launches, launches per step) over the three
    ways."""
    grid = cfg.cavern600_grid(st)
    ways = {"default": {}, "lag": {"lag_tangent": True},
            "adaptive": {"adaptive_rtol": True}}
    eqs, chunks, warm = {}, {w: [] for w in ways}, {}
    for way, flags in ways.items():
        eq = eqs[way] = cfg.wire_flagged(st, grid, flags, precond="auto")
        cfg.elastic_init(eq)
        need_band(f"lag {way}", eq).launches = 0
        chunks[way] += run_chunks(eq, HOUR, (3,))
        warm[way] = (eq.u.cpu().numpy(), eq.sig_v.cpu().numpy(),
                     eq.kernel.band.launches, eq.tangent_builds_total,
                     eq.rollbacks_total)
    chunks_in_turns(eqs, chunks)
    fields, launches_all, steps_all = {}, 0, 0
    for way, eq in eqs.items():
        band = eq.kernel.band
        all_rows = np.concatenate([r for r, _ in chunks[way]])
        rows = all_rows[3:]
        n = len(rows)
        if not (all_rows[:, 5] == 1).all():
            raise AssertionError(f"lag {way}: non-converged steps "
                                 f"{all_rows[:, [0, 1, 5]].tolist()}")
        if band.launches <= 0:
            raise AssertionError(f"lag {way}: band kernel never launched")
        fields[way] = (eq.u.cpu().numpy(), eq.sig_v.cpu().numpy())
        if way == "default":
            g = np.load(GOLDEN.format("cavern600"))
            e_u = within("lag default u", warm[way][0], g["u"], 1e-6)
            e_s = within("lag default sig_v", warm[way][1], g["sig_v"], 1e-6)
            vs = (f"3-step u {e_u:.2e}, sig_v {e_s:.2e} vs the cavern600 "
                  f"golden (<=1e-6 max|ref|)")
            if eq.tangent_builds_total != eq.fp_iterations_total:
                raise AssertionError("lag default: an iteration skipped its "
                                     "tangent build")
        else:
            g = np.load(GOLDEN.format(f"{way}_cavern600"))
            d_it = int(np.abs(all_rows[:, 0] - g["rows"][:, 0]).max())
            if d_it > 1:
                raise AssertionError(
                    f"lag {way}: fixed-point counts "
                    f"{all_rows[:, 0].tolist()} vs golden "
                    f"{g['rows'][:, 0].tolist()}")
            e_d = [within(f"lag {way} vs default", a, b, 2e-7)
                   for a, b in zip(fields[way], fields["default"])]
            e_g = [within(f"lag {way} vs golden", a, g[k], 1e-6)
                   for a, k in zip(fields[way], ("u", "sig_v"))]
            vs = (f"u {e_d[0]:.2e}, sig_v {e_d[1]:.2e} vs the default way "
                  f"(<=2e-7 max|ref|); u {e_g[0]:.2e}, sig_v {e_g[1]:.2e} vs "
                  f"the JAX golden with the flag (<=1e-6), fixed-point "
                  f"counts {'equal' if d_it == 0 else 'within 1'} "
                  f"(sum {int(all_rows[:, 0].sum())} vs "
                  f"{int(g['rows'][:, 0].sum())})")
        ms = [1e3 * s / len(r) for r, s in chunks[way][1:]]
        say("lag", f"{way}: {ms[0]:.1f} and {ms[1]:.1f} ms/step in the two "
                   f"timed 5-step chunks (the ways in turns); per step "
                   f"{rows[:, 0].mean():.2f} fixed-point it, "
                   f"{(eq.tangent_builds_total - warm[way][3]) / n:.2f} "
                   f"tangent builds, {rows[:, 2].mean():.1f} Krylov it, "
                   f"{(band.launches - warm[way][2]) / n:.1f} band launches; "
                   f"{eq.rollbacks_total - warm[way][4]} rollbacks "
                   f"({eq.rollbacks_total} with the warm-up chunk); {vs}")
        launches_all += band.launches
        steps_all += len(all_rows)
    return launches_all, launches_all / steps_all


def yearly_phase(st, cfg, dev, tmp):
    """Phase 13; returns (band launches, launches per step)."""
    import torch
    golden = np.load(GOLDEN.format("yearly_1200"))
    builds = dense_build_log(st)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    twin = cfg.load_example("safeincave_torch",
                            cfg.EXAMPLE_RUNS["yearly"][0])
    grid, eq = twin["build"](full=True, device=dev)
    # the example's settings (precond "auto": dense here), the sweep off
    eq.set_solver(dataclasses.replace(eq.solver, fp32_phase=False))
    if grid.n_nodes != 7669 or grid.reorder_method != "band":
        raise AssertionError(f"yearly: mesh {grid.n_nodes} nodes, order "
                             f"{grid.reorder_method}")
    if eq.kernel.band is None:
        raise AssertionError("yearly: band kernel not auto-selected on CUDA")
    band = eq.kernel.band
    band.launches = 0
    ck = os.path.join(tmp, "yearly_checkpoint.npz")
    total_steps, notes = 0, []
    for prefix, stage, every, extra in (
            ("eq", "equilibrium", 1, {}),
            ("op", "operation", cfg.YEARLY_SAVE_EVERY,
             dict(checkpoint_every=cfg.YEARLY_CHECKPOINT_EVERY,
                  checkpoint_path=ck))):
        out = st.SaveFields(eq, save_every=every)
        out.set_output_folder(os.path.join(tmp, "yearly", stage))
        for f in cfg.YEARLY_FIELDS[stage]:
            out.add_output_field(f, f)
        metrics = st.StepMetrics(os.path.join(tmp, f"yearly_{stage}.jsonl"))
        n0 = band.launches
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), \
                timed_saves(st) as saves:
            tc = cfg.run_yearly_stage(st, eq, grid, stage, [out],
                                      metrics=metrics, **extra)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        times = read_back(st, out)
        need_band(f"yearly {stage}", eq)
        rec = cfg.yearly_record(eq, metrics, stage)
        rows, ref_rows = rec["rows"], golden[f"{prefix}_rows"]
        n = len(ref_rows)
        if not (len(rows) == n and (rows[:, 2] == 1).all()):
            raise AssertionError(f"yearly {stage}: steps {rows.tolist()}")
        d_it = int(np.abs(rows[:, 0] - ref_rows[:, 0]).max())
        if d_it > 1:
            raise AssertionError(f"yearly {stage}: fixed-point counts "
                                 f"{rows[:, 0].tolist()} vs golden "
                                 f"{ref_rows[:, 0].tolist()}")
        if band.launches - n0 <= 0:
            raise AssertionError(f"yearly {stage}: band kernel never "
                                 f"launched")
        errs = {f: within(f"yearly {stage} {f}", rec[f],
                          golden[f"{prefix}_{f}"], 1e-6)
                for f in (*cfg.YEARLY_FIELDS[stage], "sig_v")}
        want = [k * tc.dt for k in range(0, n + 1, every)]
        if not np.allclose(times, want, rtol=0, atol=1e-6):
            raise AssertionError(f"yearly {stage}: saves at {times}, want "
                                 f"{want}")
        walls = [r["wall_s"] for r in metrics.records]
        say("yearly", f"{stage}: {n} steps converged in {secs:.2f} s (dense "
                      f"preconditioner build included); "
                      f"{1e3 * sum(walls) / n:.1f} ms/step in the solver, "
                      f"{1e3 * float(np.mean(walls[every:])):.1f} after the "
                      f"first chunk; {rows[:, 0].mean():.2f} fixed-point "
                      f"it/step (golden {ref_rows[:, 0].mean():.2f}, max "
                      f"|difference| {d_it}); band launches "
                      f"{band.launches - n0}, {(band.launches - n0) / n:.1f} "
                      f"per step; vs golden "
                      + ", ".join(f"{f} {e:.2e}" for f, e in errs.items())
                      + f" (<=1e-6 max|ref|); {len(want)} saves at the "
                      f"expected times, read back through postproc, the "
                      f"last equal to the fields in memory bit for bit; "
                      f"{1e3 * secs / n:.1f} ms/step in the stage; "
                      + save_note(saves, out.output_folder))
        total_steps += n
        notes.append(1e3 * float(np.mean(walls[every:])))
    with np.load(ck) as z:
        step, n_keys = int(z["tc_step"]), len(z.files)
    if step != cfg.YEARLY_CHECKPOINT_EVERY:
        raise AssertionError(f"yearly: checkpoint at step {step}")
    say("yearly", f"cavern_interlayer_1200: E={grid.n_elems}, "
                  f"N={grid.n_nodes}, {3 * grid.n_nodes} DOFs; band kernel "
                  f"and dense preconditioner selected by 'auto'; dense "
                  f"inverse built {len(builds)} times (once per stage's "
                  f"boundary conditions): "
                  + ", ".join(f"{s:.2f} s" for s, _ in builds)
                  + f", {builds[0][1] / 1e9:.3f} GB each; one checkpoint "
                  f"({n_keys} arrays, step {step}); phase "
                  f"{time.perf_counter() - t0:.1f} s, peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return band.launches, band.launches / total_steps


# phase 18: the 10 steps after the first, timed in chunks; the sweep-off
# run's field tolerance is TMCYC_SPREAD times the JAX package's own spread
# between its 2level and dense preconditioners at the golden's steps
# (the golden's dense.* keys), at most 1e-5 max|ref|
TMCYC_CHUNKS = (2, 2, 2, 2, 2)
TMCYC_SPREAD = 100.0
TMCYC_HELD = ("u_1", "T_1", "sig_v_1", "u", "T", "p", "q")


def tmcyc_tolerance(golden):
    """(tolerance, spread): the spread is the largest field distance
    between the JAX package's 2level and dense runs of the golden."""
    spread = max(float(golden[f"dense.{k}"]) for k in TMCYC_HELD)
    return min(TMCYC_SPREAD * spread, 1e-5), spread


def tmcyc_run(st, cfg, dev, path, fp32_phase):
    """One way of a phase-18 path: built on the card with the port's CUDA
    "auto" choices (band kernel, dense preconditioner) and ``fp32_phase``;
    the elastic response, the first step alone, then the 10 more of
    bench_tm_cyclic in ``TMCYC_CHUNKS``."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eq, heat = cfg.tm_cyclic_path(st, path, device=dev, precond="auto",
                                  fp32_phase=fp32_phase)
    band = eq.kernel.band
    if band is None:
        raise AssertionError(f"tm_cyclic {path}: band kernel not "
                             f"auto-selected on CUDA")
    band.launches = 0
    sweeps = []
    real = eq._fp32_sweep

    def watched(*args, **kw):
        out = real(*args, **kw)
        sweeps.append(out[4] > 0)       # iterations: 0 when rejected
        return out
    eq._fp32_sweep = watched
    cfg.tm_cyclic_init(eq, heat)
    torch.cuda.synchronize()
    run = {"elastic_s": time.perf_counter() - t0,
           "elastic_krylov": eq.solver_stats[0],
           "u_elastic": eq.u.cpu().numpy()}
    need_band(f"tm_cyclic {path}", eq)
    t0 = time.perf_counter()
    rows = [cfg.tm_cyclic_run(eq, heat, 1)]
    torch.cuda.synchronize()
    run["first_s"] = time.perf_counter() - t0
    run.update({f"{k}_1": v for k, v in cfg.tm_cyclic_fields(eq,
                                                             heat).items()})
    first_launches, chunks, t_first = band.launches, [], 2 * HOUR
    for n in TMCYC_CHUNKS:
        t0 = time.perf_counter()
        rows.append(cfg.tm_cyclic_run(eq, heat, n, t_first=t_first))
        torch.cuda.synchronize()
        chunks.append((time.perf_counter() - t0) / n)
        t_first += n * HOUR
    run.update(cfg.tm_cyclic_fields(eq, heat, pq=True))
    run.update(rows=np.concatenate(rows), chunk_ms=[1e3 * s for s in chunks],
               launches=band.launches,
               launches_per_step=(band.launches - first_launches)
               / sum(TMCYC_CHUNKS),
               sweeps=len(sweeps), accepted=sum(sweeps),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               E=eq.grid.n_elems, N=eq.grid.n_nodes)
    return run


def tm_cyclic_phase(st, cfg, dev, card):
    """Phase 18; returns {path: (band launches, launches per step)} over
    both ways of each path."""
    with open(os.path.join(ROOT, "baseline_measured.json")) as f:
        baseline = json.load(f)
    out = {}
    for path, (_, _, bkey) in cfg.TM_CYCLIC.items():
        golden = np.load(GOLDEN.format(path))
        ref_rows = golden["rows"]
        tol, spread = tmcyc_tolerance(golden)
        runs = {"off": tmcyc_run(st, cfg, dev, path, False),
                "auto": tmcyc_run(st, cfg, dev, path, "auto")}
        off, on = runs["off"], runs["auto"]
        e_el = rel_err(off["u_elastic"], golden["u_elastic"])
        if not e_el <= 1e-8:
            raise AssertionError(f"tm_cyclic {path}: elastic u {e_el:.2e} "
                                 f"> 1e-8 of the golden")
        if not np.array_equal(off["rows"][:, 5], ref_rows[:, 5]):
            raise AssertionError(f"tm_cyclic {path} sweep off: converged "
                                 f"{off['rows'][:, 5].tolist()} vs golden "
                                 f"{ref_rows[:, 5].tolist()}")
        d_it = int(np.abs(off["rows"][:, 2] - ref_rows[:, 2]).max())
        if d_it > 1:
            raise AssertionError(f"tm_cyclic {path} sweep off: fixed-point "
                                 f"counts {off['rows'][:, 2].tolist()} vs "
                                 f"golden {ref_rows[:, 2].tolist()}")
        errs = {k: within(f"tm_cyclic {path} sweep off {k}", off[k],
                          golden[k], tol) for k in TMCYC_HELD}
        if not (on["rows"][:, 5] >= ref_rows[:, 5]).all():
            raise AssertionError(f"tm_cyclic {path} sweep auto: converged "
                                 f"{on['rows'][:, 5].tolist()} where the "
                                 f"golden's {ref_rows[:, 5].tolist()}")
        if not on["sweeps"]:
            raise AssertionError(f"tm_cyclic {path}: fp32_phase 'auto' ran "
                                 f"no f32 sweep on CUDA")
        dist = {k: rel_err(on[k], off[k]) for k in TMCYC_HELD}
        base = baseline[bkey]["s_per_step"]
        for way, r in runs.items():
            rows = r["rows"]
            ms = float(np.median(r["chunk_ms"]))
            vs = (f"vs JAX golden (2level, cumsum; JAX 2level-vs-dense "
                  f"spread {spread:.2e}, tolerance {tol:.2e} max|ref|): "
                  f"elastic u {e_el:.2e}, "
                  + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
                  + f"; fixed-point counts within {d_it} of the golden's"
                  if way == "off" else
                  "fields vs the sweep-off run (reported, not held): "
                  + ", ".join(f"{k} {e:.2e}" for k, e in dist.items()))
            say("tm_cyclic",
                f"{path} sweep {way}: E={r['E']} N={r['N']}; elastic "
                f"{r['elastic_s']:.2f} s (dense build included, "
                f"{r['elastic_krylov']} Krylov); first step "
                f"{1e3 * r['first_s']:.1f} ms; {int(rows[:, 5].sum())}/"
                f"{len(rows)} steps converged (golden "
                f"{int(ref_rows[:, 5].sum())}); {ms:.1f} ms/step (median of "
                f"{len(TMCYC_CHUNKS)} chunks of {TMCYC_CHUNKS[0]}: "
                + ", ".join(f"{c:.1f}" for c in r["chunk_ms"])
                + f"); per step {rows[:, 2].mean():.2f} fixed-point it "
                f"(golden {ref_rows[:, 2].mean():.2f}), "
                f"{rows[:, 4].mean():.1f} Krylov it (golden "
                f"{ref_rows[:, 4].mean():.1f}, 2level on the CPU), "
                f"{rows[:, 0].mean():.1f} heat CG it; band launches "
                f"{r['launches']}, {r['launches_per_step']:.1f} per step "
                f"after the first; f32 sweeps run {r['sweeps']}, accepted "
                f"{r['accepted']}; peak device memory {r['peak_gib']:.2f} "
                f"GiB; 1-core CPU JAX baseline (baseline_measured.json "
                f"{bkey}) {base:.2f} s/step = {1e3 * base / ms:.1f}x this "
                f"run; {vs}; {card}")
        steps = sum(len(r["rows"]) for r in runs.values())
        launches = sum(r["launches"] for r in runs.values())
        out[path] = (launches, launches / steps)
    return out


def to_file_order(ref_grid, grid, u, sig_v):
    """Nodal ``u`` and element ``sig_v`` of ``grid`` in the node and
    element order of ``ref_grid`` (the same mesh, renumbered): nodes are
    matched by their coordinates, elements by their nodes."""
    def match(a_ref, a):
        ia, ib = np.lexsort(a_ref.T), np.lexsort(a.T)
        perm = np.empty(len(ia), dtype=np.int64)
        perm[ia] = ib
        if not np.array_equal(a[perm], a_ref):
            raise AssertionError("order: the meshes do not match")
        return perm

    nperm = match(np.asarray(ref_grid.points), np.asarray(grid.points))
    ref_of = np.empty(len(nperm), dtype=np.int64)
    ref_of[nperm] = np.arange(len(nperm))
    eperm = match(np.sort(np.asarray(ref_grid.conn), axis=1),
                  np.sort(ref_of[np.asarray(grid.conn)], axis=1))
    return u[nperm], sig_v[eperm]


def order_phase(st, cfg):
    """Phase 14: the unreordered cavern mesh and its alternatives."""
    path = st.Utils.find_grid("cavern_regular_600_3D",
                              fallback="cavern_proxy_600")
    ways = (("file order, cumsum", None, False),
            ("file order, block-ELL", None, True),
            ("morton, block-ELL", "morton", True),
            ("band, band kernel", "band", False))
    eqs, ops, chunks = {}, {}, {}
    for way, reorder, bell in ways:
        grid = st.GridHandlerGMSH("geom", path, reorder=reorder)
        eq = eqs[way] = cfg.wire_bench(st, grid, precond="auto")
        if st.fem.momentum.select_backend(grid, eq.device) != (
                "band" if reorder == "band" else "dia" if reorder is None
                else None):
            raise AssertionError(f"order {way}: backend selection")
        if (eq.kernel.band is not None) != (reorder == "band") \
                or eq.kernel.dia is not None:
            raise AssertionError(f"order {way}: unexpected operator")
        ops[way] = "band kernel" if reorder == "band" else "cumsum operator"
        if bell:
            eq.enable_blockell_matvec()
            plan = eq.kernel.blockell.plan
            ops[way] = (f"block-ELL K={plan.K}, Gn={plan.Gn}, f64 blocks "
                        f"{plan.nbytes(8) / 1e6:.1f} MB, f32 "
                        f"{plan.nbytes(4) / 1e6:.1f} MB")
        cfg.elastic_init(eq)
        chunks[way] = run_chunks(eq, HOUR, (3,))
    chunks_in_turns(eqs, chunks)
    ref = None
    for way, eq in eqs.items():
        rows = np.concatenate([r for r, _ in chunks[way]])
        if not (rows[:, 5] == 1).all():
            raise AssertionError(f"order {way}: non-converged steps")
        u, sig = eq.u.cpu().numpy(), eq.sig_v.cpu().numpy()
        if ref is None:
            ref = (eq.grid, u, sig)
            vs = "the reference of the other ways"
        else:
            u, sig = to_file_order(ref[0], eq.grid, u, sig)
            vs = (f"u {within(f'order {way} u', u, ref[1], 1e-8):.2e}, sig_v "
                  f"{within(f'order {way} sig_v', sig, ref[2], 1e-8):.2e} "
                  f"vs the first way in the file's order (<=1e-8 max|ref|)")
        ms = [1e3 * s / len(r) for r, s in chunks[way][1:]]
        say("order", f"{way}: {ops[way]}; {ms[0]:.1f} and {ms[1]:.1f} ms/step "
                     f"in the two timed 5-step chunks (the ways in turns), "
                     f"{rows[3:, 0].mean():.2f} fixed-point it/step, "
                     f"{rows[3:, 2].mean():.1f} Krylov it/step; {vs}")


def point_phase(st, cfg, dev):
    """Phase 15: the calibration fit and the triaxial twin on the card."""
    import torch
    golden = np.load(GOLDEN.format("point"))
    f64 = torch.float64
    observed = cfg.creep_observed()
    model = cfg.creep_model(torch.exp, lambda x: torch.as_tensor(
        x, dtype=f64, device=dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitted, hist = st.calibrate(model, observed=observed,
                                loss_scale=np.abs(observed).max(),
                                **cfg.CREEP_FIT)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    steps = cfg.CREEP_FIT["steps"]
    e_fit = {k: abs(float(fitted[k]) / float(golden[f"fit_{k}"]) - 1.0)
             for k in ("A", "n")}
    e_hist = float(np.abs(np.asarray(hist) / golden["history"] - 1.0).max())
    if not (max(e_fit.values()) <= 1e-6 and e_hist <= 1e-6):
        raise AssertionError(f"point: fitted {e_fit}, loss history {e_hist}")
    say("point", f"calibrate (closed-form creep, {steps} Adam steps in log "
                 f"space, autograd on the card): {1e3 * fit_s / steps:.2f} "
                 f"ms/step; fitted A {float(fitted['A']):.6e}, n "
                 f"{float(fitted['n']):.6f} (true {cfg.CREEP_TRUE['A']:.1e}, "
                 f"{cfg.CREEP_TRUE['n']}); vs JAX golden: A {e_fit['A']:.2e}, "
                 f"n {e_fit['n']:.2e} (<=1e-6), loss history {e_hist:.2e} "
                 f"relative (<=1e-6); loss {hist[0]:.3e} -> {hist[-1]:.3e}")

    times = golden["triax_times"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, mat = cfg.triaxial_twin(
        st, cfg.TRIAX_TRUE["cohesion"], cfg.TRIAX_TRUE["friction"], times,
        lambda n: torch.ones(n, dtype=f64, device=dev))
    torch.cuda.synchronize()
    twin_s = time.perf_counter() - t0
    if res["S_diff"].device.type != "cuda" or mat.device.type != "cuda":
        raise AssertionError("point: the twin did not run on the card")
    errs = {k: within(f"point {k}", res[k].cpu().numpy(), golden[k], 1e-9)
            for k in ("S_diff", "sig_zz", "eps_vol", "eps_ne")}
    say("point", f"TriaxialSimulator.run_compression ({len(times)} times, 2 "
                 f"confinements, 12 Newton steps each): {twin_s:.2f} s, "
                 f"{1e3 * twin_s / (len(times) - 1):.1f} ms per time step; "
                 f"vs JAX golden "
                 + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
                 + " (<=1e-9 max|ref|)")


def launches_per_call(fn, dev, n=5):
    """Device launches (kernels, copies, fills) one call of ``fn`` makes,
    from torch.profiler over n calls; None off the card, or where the
    profiler recorded no device event."""
    if dev.type != "cuda":
        return None
    fn()
    us = DeviceTimer._kernel_us(fn, n)
    return sum(k for _, k in us.values()) / n if us else None


def allclose(tag, got, ref, rtol, atol):
    """numpy's allclose test, raising with the worst element; returns
    max|got - ref| / max|ref|."""
    err = np.abs(got - ref) - (atol + rtol * np.abs(ref))
    if not (err <= 0).all():
        i = np.unravel_index(np.argmax(err), err.shape)
        raise AssertionError(f"{tag}: {got[i]} vs {ref[i]} at {i} (rtol "
                             f"{rtol}, atol {atol})")
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def app_run(st, cfg, dev, tmp):
    """Phase 16's app run: ``InputFileBuilder`` writes and validates a
    2-step case over box_mesh(nx=3); ``SimulatorRunner`` runs it in a child
    ``sim_cli`` on ``dev``.  Returns (seconds, streamed lines, operation
    save times, the child's device line)."""
    from safeincave_torch.app import InputFileBuilder, SimulatorRunner
    grid_dir = os.path.join(tmp, "app_grid")
    os.makedirs(grid_dir, exist_ok=True)
    st.mesh.write_msh(os.path.join(grid_dir, "geom.msh"),
                      *st.mesh.box_mesh(nx=3, ny=3, nz=3))
    out_dir = os.path.join(tmp, "app_out")
    b = (InputFileBuilder()
         .set_grid(grid_dir).set_output(out_dir)
         .set_solver(type="KrylovSolver", method="cg",
                     relative_tolerance=1e-12)
         .set_body_force(gravity=0.0, density=2000.0, direction=2)
         .set_time([0.0, HOUR, 2 * HOUR], theta=0.5)
         .set_equilibrium(active=False)
         .set_operation(active=True, dt_max=HOUR)
         .set_elastic("spring", 102e9, 0.3)
         .add_nonelastic("creep", "DislocationCreep",
                         {"A": 1.9e-20, "Q": 51600, "n": 3.0, "T": 298.0})
         .add_dirichlet("WEST", 0, [0.0, 0.0, 0.0])
         .add_dirichlet("SOUTH", 1, [0.0, 0.0, 0.0])
         .add_dirichlet("BOTTOM", 2, [0.0, 0.0, 0.0])
         .add_neumann("TOP", 2, [4e6, 8e6, 8e6]))
    errs = b.validate()
    if errs:
        raise AssertionError(f"app: the case does not validate: {errs}")
    case = b.save(os.path.join(tmp, "app_case.json"))
    lines = []
    t0 = time.perf_counter()
    runner = SimulatorRunner(output_callback=lines.append, device=dev.type)
    runner.launch(case)
    rc = runner.wait(timeout=600)
    secs = time.perf_counter() - t0
    text = "".join(lines)
    if rc != 0:
        raise AssertionError(f"app: the runner's child exited {rc}:\n"
                             f"{text[-3000:]}")
    times, u, _, _ = st.PostProcessingTools.read_timeseries(
        os.path.join(out_dir, "operation"), "u")
    times = [float(t) for t in times]
    if not np.isfinite(u).all():
        raise AssertionError("app: non-finite u read back")
    rows = cfg.screen_rows([ln.rstrip("\n") for ln in lines])
    if len(rows) != 2:
        raise AssertionError(f"app: {len(rows)} step rows streamed:\n"
                             f"{text[-3000:]}")
    if not np.allclose(times, [0.0, HOUR, 2 * HOUR], rtol=0, atol=1e-6):
        raise AssertionError(f"app: saves at {times}")
    device_line = next((ln.strip() for ln in lines if "device:" in ln), "")
    if dev.type not in device_line:
        raise AssertionError(f"app: the child ran on {device_line!r}")
    return secs, lines, times, device_line


@contextlib.contextmanager
def kernel_instances(st):
    """While active, every block-DIA and band operator the port builds is
    appended to ``made["dia"]`` / ``made["band"]``; each counts its own
    launches from 0."""
    from importlib import import_module
    made = {"dia": [], "band": []}
    classes = {"dia": import_module(f"{st.__name__}.fem.dia").BlockDIA,
               "band": import_module(
                   f"{st.__name__}.fem.bandkernel").BandMatvec}
    real = {k: cls.__init__ for k, cls in classes.items()}

    def recorder(key):
        def init(self, *args, **kw):
            real[key](self, *args, **kw)
            made[key].append(self)
        return init
    for key, cls in classes.items():
        cls.__init__ = recorder(key)
    try:
        yield made
    finally:
        for key, cls in classes.items():
            cls.__init__ = real[key]


# the examples whose equations must run on the block-DIA kernel (the
# generated cavern of nobian_yearly's CI scale is in natural order too)
DIA_EXAMPLES = ("triaxial", "cube_regions", "tm_cube", "interlayer",
                "yearly")
# files each example writes beside its fields, relative to its output root
EXAMPLE_FILES = {"interlayer": ("nobian_interlayer/ksp_log.jsonl",),
                 "yearly": ("nobian_yearly/metrics.jsonl",
                            "nobian_yearly/checkpoint.npz")}


def example_outputs(cfg, out_root, name):
    """Check the files an example writes: per field an .xdmf and an .h5,
    a log.txt in each folder that holds fields, and the example's own
    files; returns the number of steps its transcripts list."""
    logs = {}
    for base, dirs, files in os.walk(out_root):
        for f in files:
            if f.endswith(".xdmf") and f[:-5] + ".h5" not in files:
                raise AssertionError(f"examples {name}: {base}/{f} has no "
                                     f".h5 beside it")
        if any(f.endswith(".xdmf") for d in dirs
               for f in os.listdir(os.path.join(base, d))):
            if "log.txt" not in files:
                raise AssertionError(f"examples {name}: no log.txt in "
                                     f"{base}")
            with open(os.path.join(base, "log.txt")) as fh:
                logs[base] = fh.read()
    for rel in EXAMPLE_FILES.get(name, ()):
        if not os.path.isfile(os.path.join(out_root, rel)):
            raise AssertionError(f"examples {name}: {rel} was not written")
    # a stage's transcript is written to each of its output folders
    return sum(len(cfg.screen_rows(text.splitlines()))
               for text in set(logs.values()))


def hold_example(name, rec, ref):
    """The final saved fields within 1e-6 max|ref| of the JAX golden, the
    save times equal, the fixed-point counts of each transcript within
    +-1; returns the worst field error."""
    if set(rec) != set(ref):
        raise AssertionError(f"examples {name}: outputs "
                             f"{sorted(set(rec) ^ set(ref))} differ from "
                             f"the golden's")
    worst = 0.0
    for k, want in ref.items():
        got = rec[k]
        if k.endswith(".times"):
            if not np.array_equal(got, want):
                raise AssertionError(f"examples {name}: {k} {got} vs "
                                     f"{want}")
        elif k.endswith(".log") or k == "log":
            if got.shape != want.shape or np.abs(got - want).max(
                    initial=0) > 1:
                raise AssertionError(f"examples {name}: {k} fixed-point "
                                     f"counts {got.tolist()} vs golden "
                                     f"{want.tolist()}")
        else:
            worst = max(worst, within(f"examples {name} {k}", got, want,
                                      1e-6))
    return worst


def examples_phase(st, cfg, dev, tmp, card):
    """Phase 17; returns the DIA kernel's (launches, launches per step)
    over the examples that run on it."""
    with cfg.fp32_forced(st, False):
        out = run_examples(st, cfg, dev, tmp, card)
    triaxial_sweep(st, cfg, dev, tmp, card)
    return out


def run_examples(st, cfg, dev, tmp, card):
    import torch
    dia_launches = dia_steps = 0
    for name, (script, _, kwargs) in cfg.EXAMPLE_RUNS.items():
        golden = np.load(GOLDEN.format(f"examples_{name}"))
        ref = {k[len("card."):]: golden[k] for k in golden.files
               if k.startswith("card.")}
        run = os.path.join(tmp, "examples", name)
        kwargs = cfg.example_kwargs(st, name, kwargs,
                                    os.path.join(tmp, "grids", name))
        with kernel_instances(st) as made, timed_saves(st) as saves, \
                contextlib.redirect_stdout(io.StringIO()):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = cfg.run_example("safeincave_torch", script, run,
                                     kwargs, device=dev)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        out_root = os.path.join(run, "output")
        n_steps = example_outputs(cfg, out_root, name)
        rec = cfg.example_record(out_root,
                                 st.PostProcessingTools.read_timeseries)
        err = hold_example(name, rec, ref)
        launches = {k: sum(op.launches for op in ops)
                    for k, ops in made.items()}
        if name in DIA_EXAMPLES:
            if not made["dia"] or launches["dia"] <= 0:
                raise AssertionError(f"examples {name}: the DIA kernel "
                                     f"never launched")
            dia_launches += launches["dia"]
            dia_steps += n_steps
        kernel = ", ".join(
            f"{k} kernel {n} launches, {n / n_steps:.1f} per step"
            for k, n in launches.items() if made[k]) or \
            "no hand kernel on this path"
        if name == "tm_cavern":
            if made["band"] or made["dia"]:
                raise AssertionError("examples tm_cavern: a hand kernel "
                                     "was built on a Morton-ordered mesh")
            kernel = ("no hand kernel on this path: the script loads its "
                      "mesh in Morton order, which neither the band nor "
                      "the block-DIA plan takes (the cumsum operator)")
        extra = ""
        if name == "yearly":
            if not (result["max_error"] <= 1e-8 and result["steps"] > 0):
                raise AssertionError(f"examples yearly: {result}")
            ck = os.path.join(out_root, "nobian_yearly", "checkpoint.npz")
            with np.load(ck) as z:
                ck_step = int(z["tc_step"])
            with contextlib.redirect_stdout(io.StringIO()):
                resumed = cfg.run_example(
                    "safeincave_torch", script, run + "_resume",
                    {"argv": kwargs["argv"] + ["--resume", ck]},
                    device=dev)
            if not (resumed["steps"] == result["steps"] - ck_step
                    and resumed["max_error"] <= 1e-8):
                raise AssertionError(f"examples yearly: resumed from step "
                                     f"{ck_step}: {resumed}")
            extra = (f"; --resume from the step-{ck_step} checkpoint ran "
                     f"the last {resumed['steps']} steps, max error "
                     f"{resumed['max_error']:.2e}")
        say("examples", f"{script}: {n_steps} steps converged in "
                        f"{secs:.2f} s, "
                        f"{1e3 * secs / n_steps:.1f} ms/step; {kernel}; "
                        f"fields read back through postproc vs JAX golden "
                        f"{err:.2e} (<=1e-6 max|ref|), save times equal, "
                        f"fixed-point counts within 1; "
                        + save_note(saves, out_root) + extra + f"; {card}")
    for name, script in cfg.CALIBRATIONS.items():
        golden = np.load(GOLDEN.format(f"examples_{name}"))
        run = os.path.join(tmp, "examples", name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            if name == "creep":
                fits = {"fit": cfg.run_example("safeincave_torch", script,
                                               run, {}, device=dev)}
                steps = 300
            elif name == "labdata":
                out = cfg.run_example(
                    "safeincave_torch", script, run,
                    {"argv": ["--no-plot", "--out", run]}, device=dev)
                fits = {"fit": out["fitted"]}
                steps = 400
                if not os.path.isfile(os.path.join(run,
                                                   "fitted_params.json")):
                    raise AssertionError("examples labdata: no "
                                         "fitted_params.json")
            elif name == "triaxial_fit":
                steps = cfg.TRIAXIAL_FIT_STEPS
                fits = {"fit": cfg.run_example(
                    "safeincave_torch", script, run,
                    {"argv": [], "steps": steps}, device=dev)}
            else:
                steps = cfg.MULTIMODEL_STEPS
                sic, md = cfg.run_example("safeincave_torch", script, run,
                                          {"steps": steps}, device=dev)
                fits = {"sic.fit": sic, "md.fit": md}
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        worst = 0.0
        for prefix, fitted in fits.items():
            for k, v in fitted.items():
                want = float(golden[f"{prefix}.{k}"])
                e = abs(float(v) - want) / abs(want)
                if not e <= 1e-6:
                    raise AssertionError(f"examples {name}: {prefix}.{k} "
                                         f"{float(v)!r} vs golden {want!r}")
                worst = max(worst, e)
        say("examples", f"{script}: {len(fits)} fit(s) of {steps} Adam "
                        f"steps in {secs:.2f} s ({secs / len(fits):.2f} s "
                        f"per fit, the observed record included); fitted "
                        f"parameters vs JAX golden {worst:.2e} relative "
                        f"(<=1e-6); {card}")
    return dia_launches, dia_launches / dia_steps


# with the f32 sweep on, 1_triaxial's final fields move by 1.6e-3 (Fvp)
# to 6.9% (eps_cr) of max|ref| in the JAX package itself when only the
# round-off of its f32 Krylov iterates changes (the jacobi preconditioner
# for 2level; 1e-10 with the sweep off): the card's run is held to this
# many times that spread, per field (the golden's spread.* keys)
TRIAX_SWEEP_SPREAD = 10.0


def triaxial_sweep(st, cfg, dev, tmp, card):
    """Phase 17's last run: 1_triaxial at its defaults with the f32 sweep
    forced on, against tests/golden/torch_port_examples_triaxial_sweep.npz
    (the JAX script on the CPU with the sweep forced on): every step
    converged, the outputs and the last save time the golden's, each
    final field within ``TRIAX_SWEEP_SPREAD`` times the JAX package's own
    round-off spread of that field; the dt halvings and fixed-point
    counts reported beside the golden's."""
    import torch
    name = "triaxial_sweep"
    script, _, kwargs = cfg.SWEEP_RUNS[name]
    golden = np.load(GOLDEN.format(f"examples_{name}"))
    ref = {k[len("card."):]: golden[k] for k in golden.files
           if k.startswith("card.")}
    run = os.path.join(tmp, "examples", name)
    sweeps, err = [], io.StringIO()
    real = st.LinearMomentum._fp32_sweep

    def watched(self, *args, **kw):
        out = real(self, *args, **kw)
        sweeps.append(out[4] > 0)
        return out
    st.LinearMomentum._fp32_sweep = watched
    try:
        with kernel_instances(st) as made, cfg.fp32_forced(st, True), \
                contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(err):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cfg.run_example("safeincave_torch", script, run, kwargs,
                            device=dev)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
    finally:
        st.LinearMomentum._fp32_sweep = real
    out_root = os.path.join(run, "output")
    with open(os.path.join(out_root, "case_0", "log.txt")) as f:
        rows = cfg.screen_rows(f.read().splitlines())
    halvings = err.getvalue().count("halving dt")
    if not (len(rows) and (rows[:, 1] <= 1e-8).all()):
        raise AssertionError(f"examples {name}: steps {rows.tolist()}")
    rec = cfg.example_record(out_root,
                             st.PostProcessingTools.read_timeseries)
    fields = [k for k in ref if not (k.endswith(".times") or
                                     k.endswith("log"))]
    if set(rec) != set(ref) or \
            rec["case_0.u.times"][-1] != ref["case_0.u.times"][-1]:
        raise AssertionError(f"examples {name}: outputs {sorted(rec)} or "
                             f"their last save time differ from the "
                             f"golden's")
    errs = {k: within(f"examples {name} {k}", rec[k], ref[k],
                      TRIAX_SWEEP_SPREAD * float(golden[f"spread.{k}"]))
            for k in fields}
    counts, want = rec["case_0.log"], ref["case_0.log"]
    launches = sum(op.launches for op in made["dia"])
    say("examples", f"{script} with the f32 sweep forced on: {len(rows)} "
                    f"step rows, all converged (golden {len(want)}); "
                    f"{halvings} dt halvings (the JAX golden "
                    f"{int(golden['halvings.card'])}, the JAX run with "
                    f"jacobi {int(golden['halvings.jacobi'])}); "
                    f"{secs:.2f} s, {1e3 * secs / len(rows):.1f} ms/step; "
                    f"f32 sweeps run {len(sweeps)}, accepted {sum(sweeps)}; "
                    f"fixed-point counts {counts.astype(int).tolist()} vs "
                    f"golden {want.astype(int).tolist()} (reported); final "
                    f"fields vs the JAX golden with the sweep on, each "
                    f"beside the JAX package's own round-off spread (held "
                    f"at {TRIAX_SWEEP_SPREAD:g}x): "
                    + ", ".join(f"{k.split('.', 1)[1]} {e:.2e} (spread "
                                f"{float(golden[f'spread.{k}']):.2e})"
                                for k, e in errs.items())
                    + f"; DIA kernel {launches} launches; {card}")


def halo_phase(st, cfg, dev, card):
    """Phase 16: the cavern600 main path over 8 parts in halo mode, the
    box path in psum mode over 4 parts, the coupled pair under ``shard_tm``
    over 4, each against its unsharded run in this process, then the app
    layer's runner.  Returns {way: (ms/step, ms per f64 and f32 matvec,
    launches per f64 and f32 matvec)}."""
    import torch
    from safeincave_torch.parallel import (make_device_mesh,
                                           shard_equation, shard_tm)
    dev = torch.device(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    golden = np.load(GOLDEN.format("halo_cavern600"))
    grid = cfg.cavern600_grid(st)

    def timed_chunk(eq, t_first, n):
        sync()
        t0 = time.perf_counter()
        rows = eq.solve_time_steps([t_first + k * HOUR for k in range(n)],
                                   [HOUR] * n, tol=1e-8, maxiter=40)
        sync()
        if not (rows[:, 5] == 1).all():
            raise AssertionError(f"halo: non-converged steps "
                                 f"{rows[:, [0, 1, 5]].tolist()}")
        return rows, time.perf_counter() - t0

    # halo: cavern600 over 8 parts -------------------------------------- #
    t0 = time.perf_counter()
    eq = cfg.wire_bench(st, grid, precond="auto", device=dev)
    band0 = eq.kernel.band
    n = eq.n_elems
    shard_equation(eq, make_device_mesh(8, device=dev), mode="halo")
    plan = eq._halo.plan
    if (plan.S, plan.H, plan.R) != (507, 163, 6) or eq.n_elems != 16152:
        raise AssertionError(f"halo: plan S={plan.S} H={plan.H} R={plan.R}, "
                             f"{eq.n_elems} elements")
    if eq.kernel.band is not None or eq.kernel.dia is not None:
        raise AssertionError("halo: a band or DIA operator on the sharded "
                             "equation")
    setup_s = time.perf_counter() - t0
    cfg.elastic_init(eq)
    P, apply_M = eq._get_precond()
    if not (apply_M.__name__ == "apply_2l" and len(P) == 2
            and tuple(P[0].shape) == (8 * plan.S, 3, 3)):
        raise AssertionError("halo: the preconditioner is not "
                             "halo_two_level")
    u_el, el_krylov = eq.u.cpu().numpy(), eq.solver_stats[0]
    rows_h3, secs_h3 = timed_chunk(eq, HOUR, 3)
    u3, sig3 = eq.u.cpu().numpy(), eq.sig_v.cpu().numpy()[:n]

    # the same 3 steps unsharded, then the 5-step chunks in turns ------- #
    one = cfg.wire_bench(st, grid, precond="auto", device=dev)
    cfg.elastic_init(one)
    rows_u3, secs_u3 = timed_chunk(one, HOUR, 3)
    u3_one, sig3_one = one.u.cpu().numpy(), one.sig_v.cpu().numpy()
    rows_h5, secs_h5 = timed_chunk(eq, 4 * HOUR, 5)
    rows_u5, secs_u5 = timed_chunk(one, 4 * HOUR, 5)
    if band0 is not None and band0.launches:
        raise AssertionError("halo: the band kernel launched on the "
                             "sharded equation")
    e_el = within("halo elastic u vs golden", u_el, golden["u_elastic"],
                  1e-8)
    e_u = within("halo u vs golden", u3, golden["u"], 1e-6)
    e_s = within("halo sig_v vs golden", sig3, golden["sig_v"], 1e-6)
    d_it = int(np.abs(rows_h3[:, 0] - golden["rows"][:, 0]).max())
    if d_it > 1:
        raise AssertionError(f"halo: fixed-point counts "
                             f"{rows_h3[:, 0].tolist()} vs golden "
                             f"{golden['rows'][:, 0].tolist()}")
    d_u = allclose("halo u vs unsharded", u3, u3_one, 1e-8, 1e-13)
    d_s = allclose("halo sig_v vs unsharded", sig3, sig3_one, 1e-8, 0.1)

    # the same 8 parts on a process group of one rank (NCCL), in a child
    from safeincave_torch.parallel import launch
    t_w1 = time.perf_counter()
    (w1,) = launch(halo_rank, 1, "cuda", args=(3,), timeout=600,
                   group_timeout=300)
    w1_s = time.perf_counter() - t_w1
    for key, stacked in (("u_elastic", u_el), ("rows", rows_h3), ("u", u3),
                         ("sig", sig3)):
        if not np.array_equal(w1[key], stacked):
            raise AssertionError(f"halo: the world-size-1 NCCL run's {key} "
                                 f"differs from the stacked run")

    # psum: the box path over 4 parts ----------------------------------- #
    box = cfg.box17_grid(st)
    box_eqs, dia0 = {}, None
    for way in ("psum", "unsharded"):
        beq = cfg.wire_bench(st, box, precond="auto", fp32_phase="auto",
                             device=dev)
        if way == "psum":
            dia0 = beq.kernel.dia
            shard_equation(beq, make_device_mesh(4, device=dev), mode="psum")
            if dia0 is not None:
                dia0.launches = 0
        cfg.elastic_init(beq)
        box_eqs[way] = beq
    box_rows = {w: timed_chunk(beq, HOUR, 3) for w, beq in box_eqs.items()}
    if dia0 is not None and dia0.launches:
        raise AssertionError("psum: the DIA kernel launched on the sharded "
                             "equation")
    peq, beq1 = box_eqs["psum"], box_eqs["unsharded"]
    nb = beq1.n_elems
    d_pu = allclose("psum u vs unsharded", peq.u.cpu().numpy(),
                    beq1.u.cpu().numpy(), 1e-8, 1e-13)
    d_ps = allclose("psum sig_v vs unsharded",
                    peq.sig_v.cpu().numpy()[:nb], beq1.sig_v.cpu().numpy(),
                    1e-8, 0.1)

    # coupled: shard_tm over 4 parts ------------------------------------ #
    tm = {}
    for way in ("shard_tm", "unsharded"):
        teq, heat = cfg.wire_tm(st, grid, "Cavern", precond="auto",
                                device=dev)
        if way == "shard_tm":
            shard_tm(teq, heat, make_device_mesh(4, device=dev))
        cfg.tm_init(teq, heat)
        sync()
        t1 = time.perf_counter()
        r = teq.solve_tm_time_steps(heat, [HOUR, 2 * HOUR], [HOUR] * 2,
                                    tol=1e-6, maxiter=20)
        sync()
        if not (r[:, 5] == 1).all():
            raise AssertionError(f"tm {way}: non-converged {r.tolist()}")
        tm[way] = (r, time.perf_counter() - t1, teq.u.cpu().numpy(),
                   heat.T.cpu().numpy())
    d_T = allclose("shard_tm T vs unsharded", tm["shard_tm"][3],
                   tm["unsharded"][3], 1e-10, 1e-8)
    d_tu = allclose("shard_tm u vs unsharded", tm["shard_tm"][2],
                    tm["unsharded"][2], 1e-8, 1e-13)

    with tempfile.TemporaryDirectory() as tmp:
        app_s, lines, times, device_line = app_run(st, cfg, dev, tmp)

    # launches per matvec, last: the profiler leaves a cost on every later
    # launch of its process
    halo = eq._halo
    C = eq.mat.C
    CT_l, CT_l32 = halo.ct_to_local(C), halo.ct_to_local(C.float())
    x = halo.to_padded(torch.ones((grid.n_nodes, 3), dtype=torch.float64,
                                  device=dev))
    mp = halo.to_padded(one.bc.mask)
    ukern = one.kernel
    C1 = ukern.prep(one.mat.C)
    u1 = torch.ones((grid.n_nodes, 3), dtype=torch.float64, device=dev)
    band_op = (ukern.band.operator(ukern.band.pack_ct(C1.float()))
               if ukern.band is not None else
               (lambda v: ukern.matvec(C1.float(), v)))
    pk, Cp = peq.kernel, peq.mat.C
    ub = torch.ones((box.n_nodes, 3), dtype=torch.float64, device=dev)
    calls = {
        "halo": (lambda: halo.matvec_pad(CT_l, x, mp),
                 lambda: halo.matvec_pad(CT_l32, x.float(), mp.float())),
        "psum": (lambda: pk.matvec(Cp, ub),
                 lambda: pk.matvec(Cp.float(), ub.float())),
        "unsharded": (lambda: ukern.matvec(C1, u1),
                      lambda: band_op(u1.float()))}
    # ms per matvec: CUDA events over 100 calls, before the profiler runs
    mv_ms = {way: tuple(cuda_ms(fn, n=100) if dev.type == "cuda" else None
                        for fn in fns) for way, fns in calls.items()}
    launches = {way: tuple(launches_per_call(fn, dev) for fn in fns)
                for way, fns in calls.items()}

    def lc(v):
        return "not measured" if v is None else f"{v:.0f}"

    def mc(v):
        return "not measured" if v is None else f"{v:.3f} ms"

    P1, _ = one._get_precond()
    ways = (("halo", rows_h5, secs_h5, secs_h3,
             plan.comm_volume_per_matvec(), "8 parts, halo_two_level"),
            ("unsharded", rows_u5, secs_u5, secs_u3, 0,
             f"{'dense' if len(P1) == 1 else 'two-level'} preconditioner, "
             f"{'band kernel' if ukern.band is not None else 'cumsum'}"))
    for way, rows, secs, secs3, recv, what in ways:
        say("halo", f"{way} cavern600 ({what}; E={n}, N={grid.n_nodes}): "
                    f"{1e3 * secs / len(rows):.1f} ms/step in the 5-step "
                    f"chunk (the ways in turns; {1e3 * secs3 / 3:.1f} in "
                    f"the first 3-step chunk), {rows[:, 0].mean():.2f} "
                    f"fixed-point it/step, {rows[:, 2].mean():.1f} Krylov "
                    f"it/step; per matvec f64 {mc(mv_ms[way][0])} in "
                    f"{lc(launches[way][0])} launches, f32 "
                    f"{mc(mv_ms[way][1])} in {lc(launches[way][1])} "
                    f"(CUDA events, 100 calls; torch.profiler); rows "
                    f"received per matvec {recv}; {card}")
    say("halo", f"8 parts: S={plan.S}, H={plan.H}, R={plan.R}, round sizes "
                f"{plan.round_sizes}, rows received per matvec "
                f"{plan.comm_volume_per_matvec()} (true interface "
                f"{plan.comm_rows_true()}), elements {n} -> {eq.n_elems}; "
                f"plan and part tensors {setup_s:.2f} s; preconditioner "
                f"halo_two_level (coarse_agg {eq.solver.coarse_agg}); "
                f"elastic {el_krylov} Krylov it; no band or DIA launch on "
                f"the sharded equation; vs JAX golden (8 virtual CPU "
                f"devices): elastic u {e_el:.2e} (<=1e-8), 3-step u "
                f"{e_u:.2e}, sig_v {e_s:.2e} (<=1e-6 max|ref|), fixed-point "
                f"it {rows_h3[:, 0].astype(int).tolist()} vs "
                f"{golden['rows'][:, 0].astype(int).tolist()}; vs the "
                f"unsharded run: u {d_u:.2e}, sig_v {d_s:.2e} of max|ref| "
                f"(rtol 1e-8, atol 1e-13 m / 0.1 Pa), its fixed-point it "
                f"{rows_u3[:, 0].astype(int).tolist()}")
    for way, (rows, secs) in box_rows.items():
        beq = box_eqs[way]
        sweep = "on" if beq.solver.fp32_enabled(beq.device) else "off"
        what = ("4 parts, psum assembly" if way == "psum"
                else "block-DIA kernel" if beq.kernel.dia is not None
                else "cumsum operator")
        dense = len(beq._get_precond()[0]) == 1
        mv = (f"per matvec f64 {mc(mv_ms['psum'][0])} in "
              f"{lc(launches['psum'][0])} launches, f32 "
              f"{mc(mv_ms['psum'][1])} in {lc(launches['psum'][1])}"
              if way == "psum" else "the DIA kernel: phase 3")
        say("halo", f"box17 {way} ({what}, "
                    f"{'dense' if dense else 'two-level'} preconditioner, "
                    f"f32 sweep "
                    f"{sweep}; E={box.n_elems}, N={box.n_nodes}): "
                    f"{1e3 * secs / 3:.1f} ms/step in a 3-step chunk, "
                    f"{rows[:, 0].mean():.2f} fixed-point it/step, "
                    f"{rows[:, 2].mean():.1f} Krylov it/step; {mv}; rows "
                    f"received per matvec "
                    f"{box.n_nodes if way == 'psum' else 0}; {card}")
    say("halo", f"world-size-1 NCCL run (init_parts / launch, a child "
                f"process): elastic u, 3-step u, sig_v and step rows equal "
                f"to the stacked 8-part run bit for bit; "
                f"{w1['counts']['allreduce']} all-reduces, "
                f"{w1['counts']['rounds']} exchange rounds; the child "
                f"{w1_s:.1f} s")
    say("halo", f"psum vs unsharded box17: u {d_pu:.2e}, sig_v {d_ps:.2e} "
                f"of max|ref| (rtol 1e-8, atol 1e-13 m / 0.1 Pa); no DIA "
                f"launch on the sharded equation")
    for way, (r, secs, _, _) in tm.items():
        say("halo", f"tm {way} cavern600 (Robin wall"
                    f"{', 4 parts' if way == 'shard_tm' else ''}): 2 fused "
                    f"steps {1e3 * secs / 2:.1f} ms/step, "
                    f"{r[:, 0].mean():.1f} heat CG it, {r[:, 2].mean():.2f} "
                    f"fixed-point it, {r[:, 4].mean():.1f} Krylov it per "
                    f"step; {card}")
    say("halo", f"shard_tm vs unsharded: T {d_T:.2e} (rtol 1e-10, atol "
                f"1e-8), u {d_tu:.2e} (rtol 1e-8) of max|ref|")
    say("halo", f"app: InputFileBuilder case (box_mesh nx=3, 2 steps) "
                f"validated; SimulatorRunner's child sim_cli exit 0 in "
                f"{app_s:.1f} s, {len(lines)} lines streamed, 2 step rows, "
                f"'{device_line}', operation u saved at {times} s (the "
                f"child's SaveFields files, read back through postproc)")
    return {"halo": (1e3 * secs_h5 / 5, *mv_ms["halo"],
                     *launches["halo"]),
            "unsharded": (1e3 * secs_u5 / 5, *mv_ms["unsharded"],
                          *launches["unsharded"])}


def halo_rank(comm, n_steps):
    """Phase 16's halo case on a process group (run by ``launch`` in a
    child, this rank on its card): cavern600 as phase 4 wires it, 8 parts
    by ``shard_equation(eq, make_device_mesh(8), mode="halo")``, elastic
    response and ``n_steps`` fused steps.  Returns the fields (sig_v
    unpadded and gathered), the step rows and the collectives issued."""
    import torch
    import safeincave_torch as st
    import torch_port_configs as cfg
    from safeincave_torch.parallel import make_device_mesh, shard_equation
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eq = cfg.wire_bench(st, cfg.cavern600_grid(st), precond="auto",
                        device=comm.device)
    shard_equation(eq, make_device_mesh(8), mode="halo")
    cfg.elastic_init(eq)
    u_el = eq.u.cpu().numpy()
    rows = eq.solve_time_steps([(k + 1) * HOUR for k in range(n_steps)],
                               [HOUR] * n_steps, tol=1e-8, maxiter=40)
    return {"u_elastic": u_el, "rows": rows, "u": eq.u.cpu().numpy(),
            "sig": st.utils.unpad_elems(eq, eq.sig_v),
            "counts": dict(comm.counts)}


# the ways of --phase cards: (name, mesh, mode, parts, warm-up steps, steps
# per timed chunk)
CARD_WAYS = (("a", "cavern600", "halo", 8, 3, 2),
             ("b", "cavern600", "halo", 4, 3, 2),
             ("c", "box17", "psum", 4, 3, 2),
             ("d", "cavern600", "tm", 4, 2, 2),
             ("e", "cavern_interlayer_1200", "halo", 4, 1, 1))
CARD_CHUNKS = 3          # timed chunks per way, after the warm-up chunk
CARD_RTOL = 1e-10        # fields against the stacked run


def card_way(comm, st, cfg, way):
    """One way of ``--phase cards`` on every rank: the distributed run (D
    parts over the ranks) and, on rank 0 in turns, the stacked run of the
    same D on rank 0's card.  Returns rank 0's record (the other ranks'
    holds their peak memory and the hash of their u)."""
    import gc
    import hashlib
    import torch
    from safeincave_torch.parallel import (make_device_mesh,
                                           shard_equation, shard_tm)
    name, mesh_name, mode, D, n_warm, n_chunk = way
    dev, root = comm.device, comm.rank == 0
    grid = {"cavern600": cfg.cavern600_grid,
            "box17": cfg.box17_grid,
            "cavern_interlayer_1200": cfg.yearly_grid}[mesh_name](st)

    def build(stacked):
        mesh = make_device_mesh(D, device=dev, stacked=stacked)
        if mode == "tm":
            eq, heat = cfg.wire_tm(st, grid, "Cavern", precond="auto",
                                   device=dev)
            shard_tm(eq, heat, mesh)
            cfg.tm_init(eq, heat)
            return eq, heat
        eq = cfg.wire_bench(st, grid, precond="auto",
                            fp32_phase="auto" if mode == "psum" else False,
                            device=dev)
        shard_equation(eq, mesh, mode=mode)
        cfg.elastic_init(eq)
        return eq, None

    def chunk(eq, heat, t0, n):
        ts, dts = [t0 + k * HOUR for k in range(n)], [HOUR] * n
        torch.cuda.synchronize(dev)
        tic = time.perf_counter()
        if heat is None:
            rows = eq.solve_time_steps(ts, dts, tol=1e-8, maxiter=40)
            it, kry, conv = rows[:, 0], rows[:, 2], rows[:, 5]
        else:
            rows = eq.solve_tm_time_steps(heat, ts, dts, tol=1e-6,
                                          maxiter=20)
            it, kry, conv = rows[:, 2], rows[:, 4], rows[:, 5]
        torch.cuda.synchronize(dev)
        secs = time.perf_counter() - tic
        if not (conv == 1).all():
            raise AssertionError(f"cards {name}: non-converged steps "
                                 f"{rows.tolist()}")
        return np.stack([it, kry], 1), secs

    def state(eq, heat):
        out = {"u": eq.u.cpu().numpy(),
               "sig": st.utils.unpad_elems(eq, eq.sig_v)}
        if heat is not None:
            out["T"] = heat.T.cpu().numpy()
        return out

    torch.cuda.reset_peak_memory_stats(dev)
    tic = time.perf_counter()
    deq, dheat = build(False)
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - tic
    u_el = deq.u.cpu().numpy()
    warm, _ = chunk(deq, dheat, HOUR, n_warm)
    d_warm = state(deq, dheat)
    peak = torch.cuda.max_memory_allocated(dev)
    rec = {"peak": peak, "setup_s": setup_s, "warm": warm,
           "n_nodes": grid.n_nodes,
           "u_hash": hashlib.sha1(d_warm["u"].tobytes()).hexdigest()}
    if root:
        seq, sheat = build(True)
        s_warm, _ = chunk(seq, sheat, HOUR, n_warm)
        rec.update(s_u_el=seq.u.cpu().numpy(), u_el=u_el, s_warmrows=s_warm,
                   d_warm=d_warm, s_warm=state(seq, sheat))
    comm.barrier()
    dist_rows, dist_s, st_rows, st_s = [], [], [], []
    t = (n_warm + 1) * HOUR
    for _ in range(CARD_CHUNKS):
        r, secs = chunk(deq, dheat, t, n_chunk)
        dist_rows.append(r)
        dist_s.append(secs)
        comm.barrier()
        if root:
            r, secs = chunk(seq, sheat, t, n_chunk)
            st_rows.append(r)
            st_s.append(secs)
        comm.barrier()
        t += n_chunk * HOUR
    d_end = state(deq, dheat)
    rec["end_hash"] = hashlib.sha1(d_end["u"].tobytes()).hexdigest()
    if root:
        rec.update(d_end=d_end, s_end=state(seq, sheat),
                   dist_rows=np.concatenate(dist_rows),
                   st_rows=np.concatenate(st_rows),
                   dist_ms=[1e3 * x / n_chunk for x in dist_s],
                   st_ms=[1e3 * x / n_chunk for x in st_s])

    # per matvec: ms (CUDA events over 50 calls, every rank in step), and
    # the bytes this rank sent
    F64 = torch.float64
    if mode == "psum":
        kern, C = deq.kernel, deq.mat.C
        ub = torch.ones((grid.n_nodes, 3), dtype=F64, device=dev)
        mv = (lambda: kern.matvec(C, ub),
              lambda: kern.matvec(C.float(), ub.float()))
    else:
        halo = deq._halo
        C = deq.mat.C
        CT_l = halo.ct_to_local(C)
        CT_l32 = CT_l.float()
        x = halo.to_padded(torch.ones((grid.n_nodes, 3), dtype=F64,
                                      device=dev))
        mp = halo.to_padded(deq.bc.mask)
        mv = (lambda: halo.matvec_pad(CT_l, x, mp),
              lambda: halo.matvec_pad(CT_l32, x.float(), mp.float()))
    rec["mv_ms"] = [cuda_ms(fn, n=50) for fn in mv]
    comm.reset_counts()
    mv[0]()
    rec["mv_counts"] = dict(comm.counts)
    comm.barrier()
    if root:
        if mode == "psum":
            sk, sC = seq.kernel, seq.mat.C
            smv = (lambda: sk.matvec(sC, ub),
                   lambda: sk.matvec(sC.float(), ub.float()))
        else:
            sh = seq._halo
            sCT = sh.ct_to_local(seq.mat.C)
            sx = sh.to_padded(torch.ones((grid.n_nodes, 3), dtype=F64,
                                         device=dev))
            smp = sh.to_padded(seq.bc.mask)
            smv = (lambda: sh.matvec_pad(sCT, sx, smp),
                   lambda: sh.matvec_pad(sCT.float(), sx.float(),
                                         smp.float()))
        rec["st_mv_ms"] = [cuda_ms(fn, n=50) for fn in smv]
    comm.barrier()
    if mode != "psum":
        rec["rows_sent"] = deq._halo.rows_sent_per_matvec()
        rec["plan"] = (deq._halo.S, deq._halo.H, deq._halo.plan.R)
    # the equations hold reference cycles (an equation and its boundary
    # handler): collect them, so the next way's peak is its own
    del deq, dheat
    if root:
        del seq, sheat
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def card_comm_times(comm):
    """ms per all-reduce of one f64 (a Krylov dot) and per inter-rank
    round: one ``exchange`` of 60 x 3 f64 rows (cavern600's largest round)
    with one peer, ranks paired (0, 1), (2, 3); CUDA events over 200
    calls, every rank in step."""
    import torch
    dev = comm.device
    x = torch.zeros(1, dtype=torch.float64, device=dev)
    ar = cuda_ms(lambda: comm.allreduce_sum(x), n=200)
    peer = comm.rank ^ 1
    rows = torch.ones((60, 3), dtype=torch.float64, device=dev)
    ex = cuda_ms(lambda: comm.exchange([(peer, rows)],
                                       [(peer, (60, 3), rows.dtype)]), n=200)
    return ar, ex


def cards_rank(comm):
    """Every way of ``--phase cards`` on this rank."""
    import torch
    import safeincave_torch as st
    import torch_port_configs as cfg
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"comm_ms": card_comm_times(comm),
           "card": torch.cuda.get_device_name(comm.device)}
    for way in CARD_WAYS:
        out[way[0]] = card_way(comm, st, cfg, way)
    out["comm_ms_end"] = card_comm_times(comm)
    return out


def cards_phase(st, cfg):
    """``--phase cards``: one rank per card over NCCL, every way of
    CARD_WAYS against its stacked run on rank 0's card; cavern600 in 8
    parts against the JAX golden too."""
    import torch
    from safeincave_torch.parallel import launch
    n_cards = torch.cuda.device_count()
    if n_cards < 4:
        raise SystemExit(f"chip_smoke --phase cards: needs 4 visible cards, "
                         f"{n_cards} visible")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=index,name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    cards = smi.stdout.strip().splitlines()
    for line in cards:
        say("cards", f"card {line}")
    tic = time.perf_counter()
    ranks = launch(cards_rank, 4, "cuda", timeout=840, group_timeout=600)
    say("cards", f"4 ranks (NCCL, one per card) ran every way in "
                 f"{time.perf_counter() - tic:.1f} s")
    r0 = ranks[0]
    golden = np.load(GOLDEN.format("halo_cavern600"))
    where = "; ".join(cards)
    for name, mesh_name, mode, D, n_warm, n_chunk in CARD_WAYS:
        rec = r0[name]
        tag = f"cards {name}"
        for key in ("u_hash", "end_hash"):
            if len({r[name][key] for r in ranks}) != 1:
                raise AssertionError(f"{tag}: u differs between the ranks")
        errs = {}
        for when in ("warm", "end"):
            got, ref = rec[f"d_{when}"], rec[f"s_{when}"]
            for f in got:
                errs[f"{f} {when}"] = allclose(
                    f"{tag} {f} ({when}) vs stacked", got[f], ref[f],
                    CARD_RTOL, CARD_RTOL * np.abs(ref[f]).max())
        fp = (rec["warm"][:, 0], rec["s_warmrows"][:, 0],
              rec["dist_rows"][:, 0], rec["st_rows"][:, 0])
        if not (np.array_equal(fp[0], fp[1]) and np.array_equal(fp[2],
                                                                fp[3])):
            raise AssertionError(f"{tag}: fixed-point counts {fp}")
        if name == "a":
            e_el = within(f"{tag} elastic u vs golden", rec["u_el"],
                          golden["u_elastic"], 1e-8)
            e_u = within(f"{tag} u vs golden", rec["d_warm"]["u"],
                         golden["u"], 1e-6)
            e_s = within(f"{tag} sig_v vs golden", rec["d_warm"]["sig"],
                         golden["sig_v"], 1e-6)
            d_it = np.abs(rec["warm"][:, 0] - golden["rows"][:, 0]).max()
            if d_it > 1:
                raise AssertionError(f"{tag}: fixed-point counts "
                                     f"{rec['warm'][:, 0]} vs golden")
            say("cards", f"a vs JAX golden (8 virtual CPU devices): elastic "
                         f"u {e_el:.2e} (<=1e-8), 3-step u {e_u:.2e}, sig_v "
                         f"{e_s:.2e} (<=1e-6 max|ref|), fixed-point it "
                         f"{rec['warm'][:, 0].astype(int).tolist()} vs "
                         f"{golden['rows'][:, 0].astype(int).tolist()}")
        dr, sr = rec["dist_rows"], rec["st_rows"]
        peaks = ", ".join(f"{r[name]['peak'] / 2**30:.2f}"
                          for r in ranks)
        counts = rec["mv_counts"]
        comm_what = (f"plan S={rec['plan'][0]} H={rec['plan'][1]} "
                     f"R={rec['plan'][2]}; rank 0 sends "
                     f"{counts['bytes_sent']} bytes per f64 matvec in "
                     f"{counts['rounds']} inter-rank rounds (rows per "
                     f"matvec, forward and reverse, by rank: "
                     f"{[r[name]['rows_sent'] for r in ranks]})"
                     if mode != "psum" else
                     f"one all-reduce of the {rec['n_nodes']} x 3 nodal "
                     f"vector per matvec "
                     f"({counts['allreduce']} all-reduce)")
        say("cards", f"{name}: {mesh_name} {mode}, D={D} on W=4: "
                     f"{np.median(rec['dist_ms']):.1f} ms/step (median of "
                     f"{CARD_CHUNKS} chunks of {n_chunk} after a "
                     f"{n_warm}-step warm-up; "
                     f"{', '.join(f'{x:.1f}' for x in rec['dist_ms'])}), "
                     f"stacked on one card "
                     f"{np.median(rec['st_ms']):.1f} "
                     f"({', '.join(f'{x:.1f}' for x in rec['st_ms'])}), "
                     f"in turns; fixed-point it/step {dr[:, 0].mean():.2f} "
                     f"(stacked {sr[:, 0].mean():.2f}), Krylov it/step "
                     f"{dr[:, 1].mean():.1f} (stacked {sr[:, 1].mean():.1f}); "
                     f"ms per matvec f64 {rec['mv_ms'][0]:.3f}, f32 "
                     f"{rec['mv_ms'][1]:.3f} (stacked "
                     f"{rec['st_mv_ms'][0]:.3f}, {rec['st_mv_ms'][1]:.3f}; "
                     f"CUDA events, 50 calls); {comm_what}; peak memory per "
                     f"card {peaks} GiB (rank 0 before its stacked run); "
                     f"setup {rec['setup_s']:.1f} s; vs stacked "
                     + ", ".join(f"{k} {v:.1e}" for k, v in errs.items())
                     + f" of max|ref| (rtol {CARD_RTOL}); fixed-point counts "
                     f"equal; u the same bits on every rank; {where}")
    for key in ("comm_ms", "comm_ms_end"):
        ar = [r[key][0] for r in ranks]
        ex = [r[key][1] for r in ranks]
        say("cards", f"{'first' if key == 'comm_ms' else 'last'}: ms per "
                     f"all-reduce of one f64 by rank "
                     f"{', '.join(f'{x:.4f}' for x in ar)}; ms per "
                     f"inter-rank round (60 x 3 f64 rows, one peer) "
                     f"{', '.join(f'{x:.4f}' for x in ex)} (CUDA events, "
                     f"200 calls); {where}")


# the headline keys of bench.py's stdout line, which bench_torch.py repeats
BENCH_KEYS = ["metric", "unit", "value", "vs_baseline", "vs_baseline_measured"]
# every section of bench_torch.py but TM-cyclic, whose three
# configurations phase 18 runs twice: it keeps the full script well inside
# its 1200 s on a slow machine
BENCH_SECTIONS = ("headline", "scale", "matvec", "tm", "hostsync")


def bench_phase(card):
    """Phase 19: ``python3 bench_torch.py`` in a child on the card with
    :data:`BENCH_SECTIONS`; exit 0, one stdout JSON line with bench.py's
    keys, every section run, the headline in at least 5 repeats from one
    state with the same counts, the band kernel launched in the headline
    and the DIA kernel in the scale section.  Returns {kernel: (launches,
    launches per step)} of the child's run."""
    import torch
    torch.cuda.empty_cache()
    cmd = [sys.executable, os.path.join(ROOT, "bench_torch.py"),
           "--sections", *BENCH_SECTIONS]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                       timeout=900)
    secs = time.perf_counter() - t0
    for ln in r.stderr.splitlines():
        if not ln.startswith("bench_torch summary "):
            say("bench", ln)
    if r.returncode != 0:
        raise AssertionError(f"bench_torch.py exited {r.returncode}")
    out = [ln for ln in r.stdout.splitlines() if ln.strip()]
    if len(out) != 1:
        raise AssertionError(f"bench_torch.py printed {len(out)} stdout "
                             f"lines, not one JSON line: {out}")
    line = json.loads(out[0])
    if sorted(line) != BENCH_KEYS or line["value"] <= 0:
        raise AssertionError(f"bench_torch.py's line: {line}")
    summary = json.loads(next(
        ln for ln in r.stderr.splitlines()
        if ln.startswith("bench_torch summary "))[len("bench_torch summary "):])
    ran = summary["sections"]
    missing = [k for k in BENCH_SECTIONS if not isinstance(ran.get(k), dict)]
    if missing:
        raise AssertionError(f"bench_torch.py sections not run: {missing}")
    h = ran["headline"]
    band = h["launches"].get("band_matvec", 0)
    dia = ran["scale"]["launches"].get("dia_matvec_f32", 0)
    dia64 = ran["scale"]["launches"].get("dia_matvec_f64", 0)
    if h["repeats"] < 5 or any(c != h["counts"][0] for c in h["counts"]):
        raise AssertionError(f"bench_torch.py headline: {h['repeats']} "
                             f"repeats, counts {h['counts']}")
    if band <= 0 or dia <= 0 or dia64 <= 0:
        raise AssertionError(f"bench_torch.py: band launches {band} in the "
                             f"headline, DIA launches {dia} f32 and {dia64} "
                             f"f64 in the scale section")
    say("bench", f"bench_torch.py --sections {' '.join(BENCH_SECTIONS)} "
                 f"exit 0 in {secs:.1f} s: {line}; headline median "
                 f"{1e3 * h['median_s']:.1f} ms/step (min "
                 f"{1e3 * h['min_s']:.1f}, max {1e3 * h['max_s']:.1f}) over "
                 f"{h['repeats']} repeats of steps {h['window'][0]}-"
                 f"{h['window'][1]} from one saved state, the same counts in "
                 f"each: {h['fp_per_step']:.2f} fixed-point and "
                 f"{h['krylov_per_step']:.1f} Krylov it/step, "
                 f"{h['launches_per_step'].get('band_matvec', 0):.1f} band "
                 f"launches/step, {h['retries']} f64 retries; band launches "
                 f"{summary['launches'].get('band_matvec', 0)} over the run "
                 f"({band} in the headline's {h['repeats']} windows), DIA "
                 f"launches f32 {dia} / f64 {dia64} in the scale section; "
                 f"{card}")
    return {BAND["name"]: (band, h["launches_per_step"].get("band_matvec",
                                                            0.0)),
            DIA["name"]: (dia, None)}


def gpu_tests_phase():
    """Phase 20: tests/test_torch_kernels_gpu.py and
    tests/test_torch_heat_graphs.py with the ``gpu`` marker in a child
    pytest on the card, without tests/conftest.py (it imports JAX,
    which this machine lacks); fails when a test fails, skips or none
    ran."""
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-m", "gpu", "-q",
           "-p", "no:cacheprovider", "tests/test_torch_kernels_gpu.py",
           "tests/test_torch_heat_graphs.py"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                       timeout=600)
    lines = r.stdout.strip().splitlines()
    tail = lines[-1] if lines else ""
    passed = int(tail.split(" passed")[0].split()[-1]) \
        if " passed" in tail else 0
    if r.returncode != 0 or passed == 0 or "skipped" in tail:
        raise AssertionError(f"GPU tests: exit {r.returncode}, "
                             f"{tail!r}\n{r.stdout[-3000:]}{r.stderr[-2000:]}")
    say("gpu_tests", f"tests/test_torch_kernels_gpu.py and "
                     f"tests/test_torch_heat_graphs.py -m gpu: {tail} "
                     f"(exit 0, {time.perf_counter() - t0:.1f} s)")


def ptxas_report(name, kernels):
    """ptxas's lines (registers, stack, spills) for the entry functions of
    ``csrc/<name>.cu`` whose names contain one of ``kernels``: a second
    nvcc of the source with ``-Xptxas -v`` into a temporary library."""
    from safeincave_torch import _build
    src, _ = _build._paths(name)
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas",
                            "-v", "-o", os.path.join(tmp, "lib.so"), src],
                           capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise AssertionError(f"nvcc -Xptxas -v failed:\n{r.stderr[-3000:]}")
    out, entry = {}, None
    for line in (r.stdout + r.stderr).splitlines():
        if "Compiling entry function" in line or \
                "Function properties for" in line:
            entry = next((k for k in kernels if k in line), None)
        elif entry is not None and ("Used" in line or "spill" in line):
            out.setdefault(entry, []).append(
                line.replace("ptxas info    :", "").strip())
    return out


def band64_phase(st, cfg, dev):
    """Phase 23: the f64 band action at the three band-ordered meshes
    against its plain twin and timed beside the cumsum matvec it replaces;
    ptxas's registers; the f64 GPU tests in a child."""
    import torch
    from safeincave_torch.fem.bandkernel import BandMatvec, band_matvec_plain
    from safeincave_torch.fem.kernels import MomentumKernel
    f64 = torch.float64
    rng = np.random.default_rng(0)
    timer = DeviceTimer()
    for k, lines in ptxas_report("band_matvec", ("tile_forces_f64",
                                                 "node_sums_f64")).items():
        say("band64", f"ptxas {k}: {'; '.join(lines)}")

    def per_call_us(fn, n=100):
        """(device us per call summed over every kernel, {short name: us
        per call}), the L2 flushed before each call."""
        fn()
        us = timer._kernel_us(fn, n, timer.flush)
        per = {}
        for k, (t, _) in us.items():
            if k not in timer.flush_keys:
                name = short_name(k)
                per[name] = per.get(name, 0.0) + t / n
        if not per:         # the profiler handed back no CUDA event
            per = {"cuda graph": 1e3 * graph_ms(fn, timer.flush, n)}
        return sum(per.values()), per

    rows = []
    shapes = [("cavern600", cfg.cavern600_grid(st)),
              ("cavern_proxy_1200", cfg.band_grid(
                  st, *cfg.TM_CYCLIC["tmcyc_regular1200"][:2])),
              ("cavern_interlayer_1200", cfg.yearly_grid(st))]
    for shape, grid in shapes:
        E, N = grid.n_elems, grid.n_nodes
        kern = MomentumKernel(grid, dev)
        band = BandMatvec(kern)
        CT = torch.as_tensor(np.transpose(random_ct(E, rng), (1, 2, 0)),
                             dtype=f64, device=dev).contiguous()
        ctv = band.pack_ct64(CT)
        u, v = (torch.as_tensor(rng.normal(size=(N, 3)), dtype=f64,
                                device=dev) for _ in range(2))
        op = band.operator64(ctv)
        n0 = band.launches64
        err, scale, sym, ms, plain_ms = hold(
            f"band64 {shape}", op, lambda x: band_matvec_plain(
                ctv, band.gN64, band.conn, band.plan, x), u, v, 1e-13)
        if band.launches64 == n0 or band.launches:
            raise AssertionError("operator64 counted in the wrong counter")
        dev_us, per = per_call_us(lambda: op(u))
        chain_us, chain = per_call_us(lambda: kern.matvec(CT, u))
        scan_us = sum(t for k, t in chain.items() if "scan" in k)
        nbytes = 8 * (48 * E + 6 * N)
        bound_us = 1e6 * nbytes / HBM_BYTES_PER_S
        row = dict(shape=shape, E=E, N=N, dofs=3 * N, max_abs_err=err,
                   max_ref=scale, energy_symmetry=sym, device_us=dev_us,
                   kernels_us=per, bound_us=bound_us, bound_bytes=nbytes,
                   pct_of_bound=100.0 * bound_us / dev_us,
                   wrapper_us=1e3 * ms, plain_us=1e3 * plain_ms,
                   cumsum_device_us=chain_us, cumsum_scan_us=scan_us,
                   cumsum_kernels=len(chain),
                   pct_of_cumsum=100.0 * dev_us / chain_us)
        rows.append(row)
        say("band64", f"{shape} (E={E}, N={N}, 3N={3 * N}): max|err| "
                      f"{err:.3e} (max|ref| {scale:.3e}), bitwise "
                      f"repeatable, energy symmetry {sym:.1e}; device "
                      f"{dev_us:.2f} us ({fmt(per)}), bound {bound_us:.2f} "
                      f"us ({nbytes / 1e6:.2f} MB), "
                      f"{row['pct_of_bound']:.1f}% of bound; wrapper "
                      f"{row['wrapper_us']:.2f} us; the cumsum matvec "
                      f"{chain_us:.2f} us device in {len(chain)} kernel "
                      f"names, its scan {scan_us:.2f} us; the kernel "
                      f"{row['pct_of_cumsum']:.1f}% of it")
        del kern, band, CT, ctv, op
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-m", "gpu", "-q",
           "-p", "no:cacheprovider", "-k", "f64",
           "tests/test_torch_kernels_gpu.py"]
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                       timeout=600)
    tail = (r.stdout.strip().splitlines() or [""])[-1]
    if r.returncode != 0 or " passed" not in tail or "skipped" in tail:
        raise AssertionError(f"f64 GPU tests: exit {r.returncode}, "
                             f"{tail!r}\n{r.stdout[-3000:]}"
                             f"{r.stderr[-2000:]}")
    say("band64", f"tests/test_torch_kernels_gpu.py -m gpu -k f64: {tail}")
    return rows


# phase 21: tests/test_golden_fields.py's tolerance of the snapshots, and
# the distance of an "auto" run that goes into ROADMAP.md's queue 2 #5
FIELDS_RTOL = 1e-8
AUTO_NOTE = 1e-6
ORACLE_FIELDS = ("u_elastic", "eps_elastic", "alpha_elastic", "u_step",
                 "eps_step", "alpha_step")
CONFORMANCE = ("oracle_cube", "cavern_box", "interlayer_tm")


def within_snapshot(got, want):
    """tests/test_golden_fields.py's test: |got - want| <= FIELDS_RTOL
    (|want| + max|want|) everywhere."""
    return bool((np.abs(got - want) <= FIELDS_RTOL * (
        np.abs(want) + np.abs(want).max())).all())


def conformance_case(st, cfg, dev, case, pin, refs):
    """One case of phase 21 on the card: ({field: distance over
    max|ref|}, whether it meets the CPU tests' criteria, a note on its
    steps)."""
    if case == "oracle_cube":
        oracle, golden = refs["oracle"], refs["oracle_cube"]
        run = cfg.oracle_run(st, dev, pin)
        dists = {k: cfg.oracle_distance(run, oracle, k)
                 for k, _, _ in cfg.ORACLE_CHECKS}
        dists.update({f"jax.{k}": rel_err(run[k], golden[k])
                      for k in ORACLE_FIELDS})
        off_u0 = cfg.sorted_rel(run["u_step"], oracle["u_0"])
        ite, err = int(run["iterations"]), float(run["error"])
        ok = (err < 1e-9 and off_u0 > 1.0
              and ite == int(golden["iterations"])
              and all(dists[k] < tol for k, _, tol in cfg.ORACLE_CHECKS)
              and all(dists[f"jax.{k}"] <= FIELDS_RTOL
                      for k in ORACLE_FIELDS))
        return dists, ok, (f"step: {ite} iterations, error {err:.3e}, u_1 "
                           f"{off_u0:.3f} from u_0 (sorted)")
    snap = refs["fields"]
    if case == "cavern_box":
        u, sig, rows = cfg.run_sharding_steps(cfg.cavern_box(st, dev, pin),
                                              n_steps=3)
        got, tol = {"cavern_u": u, "cavern_sig": sig}, 1e-8
    else:
        eq, heat = cfg.interlayer_tm(st, dev, pin)
        rows = cfg.run_tm_steps(eq, heat)
        got = {"inter_u": cfg.as_np(eq.u), "inter_sig": cfg.as_np(eq.sig_v),
               "inter_T": cfg.as_np(heat.T)}
        tol = 1e-6
    ok = bool((rows[:, 1] <= tol).all()) and all(
        within_snapshot(v, snap[k]) for k, v in got.items())
    return ({k: rel_err(v, snap[k]) for k, v in got.items()}, ok,
            "fixed-point iterations " + ", ".join(
                f"{int(i)} (error {e:.2e})" for i, e in rows[:, :2]))


def conformance_phase(st, cfg, dev, card):
    """Phase 21: the port against the original SafeInCave stack's oracle
    and tests/golden/fields.npz's cavern box and interlayer TM snapshots,
    each case pinned to the references' settings (2level, cumsum, no f32
    sweep; gated at the CPU tests' tolerances) and then with the CUDA
    "auto" choices (reported); then the Python blocks of
    docs/MIGRATION_TORCH.md on the card.  Returns {kernel: launches} over
    the "auto" runs."""
    import torch
    with open(cfg.ORACLE) as f:
        refs = {"oracle": json.load(f)}
    with np.load(GOLDEN.format("oracle_cube")) as z:
        refs["oracle_cube"] = {k: z[k] for k in z.files}
    with np.load(cfg.FIELDS_GOLDEN) as z:
        refs["fields"] = {k: z[k] for k in z.files}
    launched = {BAND["name"]: 0, DIA["name"]: 0}
    auto_far = []
    t_phase = time.perf_counter()
    for case in CONFORMANCE:
        for pin in (True, False):
            t0 = time.perf_counter()
            with kernel_instances(st) as made:
                dists, ok, steps = conformance_case(st, cfg, dev, case, pin,
                                                    refs)
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            n = {BAND["name"]: sum(b.launches for b in made["band"]),
                 DIA["name"]: sum(d.launches for d in made["dia"])}
            say("conformance", f"{case} {'pinned' if pin else 'auto'}: "
                + ", ".join(f"{k} {v:.3e}" for k, v in dists.items())
                + (" (of max|ref|; the oracle's own keys on sorted "
                   "magnitudes)" if case == "oracle_cube" else
                   " (of max|ref|)")
                + f"; {steps}; launches band {n[BAND['name']]}, DIA "
                f"{n[DIA['name']]}; {secs:.2f} s; {card}")
            if pin:
                if any(n.values()):
                    raise AssertionError(f"conformance {case} pinned: a "
                                         f"hand kernel launched: {n}")
                if not ok:
                    raise AssertionError(f"conformance {case} pinned: "
                                         f"outside the CPU tests' criteria")
                continue
            for k in launched:
                launched[k] += n[k]
            # the original stack's own distance is ~2e-7: only the fields
            # held at 1e-8 enter the note
            auto_far += [f"{case} {k} {v:.3e}" for k, v in dists.items()
                         if v > AUTO_NOTE and (case != "oracle_cube"
                                               or k.startswith("jax."))]
    say("conformance", f"auto distances above {AUTO_NOTE:g} of max|ref|: "
                       + (", ".join(auto_far) or "none"))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        n_blocks = len(cfg.migration_blocks())
        cfg.run_migration_blocks("cuda", tmp)
    say("conformance", f"docs/MIGRATION_TORCH.md: {n_blocks} Python blocks "
                       f"ran with device=\"cuda\" in "
                       f"{time.perf_counter() - t0:.2f} s; the phase took "
                       f"{time.perf_counter() - t_phase:.2f} s")
    return launched


# phase 22: the captured time step against graphs.eager(), in turns
GRAPH_WAYS = (("cavern600", "cavern600", False),     # phase 4's equation
              ("headline", "cavern600", "auto"),     # bench_torch.py's
              ("box17", "box17", "auto"))            # phase 6's
GRAPH_MODES = ("captured", "eager")
GRAPH_TURNS = 3
GRAPH_STEPS = 3          # steps per timed chunk
GRAPH_TOL = 1e-12        # fields, captured against eager, of max|ref|
GRAPH_BLOCKS = (1, 2, 4, 8)


class StepClock:
    """CUDA events around every call of an equation's tangent suite and
    linear solves (the f64 solve and the f32 sweep's): the device's time
    from the call's first launch to its last, host waits inside
    included."""

    def __init__(self, eq):
        import torch
        self.spans = {"tangent": [], "solve": []}

        def timed(kind, fn):
            def call(*args, **kw):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kw)
                stop.record()
                self.spans[kind].append((start, stop))
                return out
            return call

        eq._tangent = timed("tangent", eq._tangent)
        eq._solve_lin = timed("solve", eq._get_solver())
        if eq.solver.fp32_enabled(eq.device):
            eq._solve32 = timed("solve", eq._get_solve32())

    def take(self):
        """{kind: (ms, calls)} since the last take."""
        import torch
        torch.cuda.synchronize()
        out = {k: (sum(a.elapsed_time(b) for a, b in v), len(v))
               for k, v in self.spans.items()}
        for v in self.spans.values():
            v.clear()
        return out


def mode_ctx(mode):
    from safeincave_torch.fem import graphs
    return graphs.eager() if mode == "eager" else contextlib.nullcontext()


def graph_chunk(eq, mode, clock, t_first, n):
    """``n`` steps of solve_time_steps at 1 h, captured or under
    ``graphs.eager()``: rows, ms/step, ms per tangent build and per linear
    solve, host reads, graph replays and hand-kernel launches per step."""
    import torch
    from safeincave_torch import tracing
    kern = eq.kernel.band if eq.kernel.band is not None else eq.kernel.dia
    launches, replays = kern.launches, eq.graphs.replays
    clock.take()
    with mode_ctx(mode):
        torch.cuda.synchronize()
        reads = tracing.count_of("read")
        t0 = time.perf_counter()
        rows = eq.solve_time_steps([t_first + k * HOUR for k in range(n)],
                                   [HOUR] * n, tol=1e-8, maxiter=40)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        reads = tracing.count_of("read") - reads
    spans = clock.take()
    if not (rows[:, 5] == 1).all():
        raise AssertionError(f"graphs {mode}: non-converged steps "
                             f"{rows[:, [0, 1, 5]]}")
    per = lambda k: spans[k][0] / max(spans[k][1], 1)  # noqa: E731
    return dict(rows=rows, ms=1e3 * secs / n, reads=reads / n,
                replays=(eq.graphs.replays - replays) / n,
                launches=(kern.launches - launches) / n,
                launches_total=kern.launches - launches,
                tangent_ms=per("tangent"), solve_ms=per("solve"),
                builds=spans["tangent"][1] / n, solves=spans["solve"][1] / n)


def equation_fields(eq):
    return [eq.u, eq.sig_v, eq.eps_tot_v] + [
        v for e in eq.mat.elems_ne for v in e.state.values()
        if v.is_floating_point()]


def same_work(tag, rows, eqs):
    """Captured against eager: equal fixed-point and Krylov counts in
    ``rows`` ({mode: rows}), fields within GRAPH_TOL of max|ref|; returns
    (largest distance, bitwise)."""
    if not np.array_equal(rows["captured"][:, [0, 2]],
                          rows["eager"][:, [0, 2]]):
        raise AssertionError(
            f"graphs {tag}: captured counts {rows['captured'][:, [0, 2]]} "
            f"against eager {rows['eager'][:, [0, 2]]}")
    worst, bitwise = 0.0, True
    for a, b in zip(equation_fields(eqs["captured"]),
                    equation_fields(eqs["eager"])):
        if a.equal(b):
            continue
        bitwise = False
        scale = float(b.abs().max())
        worst = max(worst, float((a - b).abs().max()) / (scale or 1.0))
    if worst > GRAPH_TOL:
        raise AssertionError(f"graphs {tag}: captured fields {worst:.3e} of "
                             f"max|ref| from eager (> {GRAPH_TOL})")
    return worst, bitwise


def idle_share(eq, mode, t_first, n=2):
    """(rows, device idle share, device operations per step) of ``n`` steps
    under torch.profiler: 1 - (device time of every kernel, copy and fill)
    / (host clock of the window); share and operations None when the
    profiler recorded no device event.  The device activity alone: the
    host operators' events would take the profiler longer to parse than
    the steps take to run."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with mode_ctx(mode):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rows = eq.solve_time_steps([t_first + k * HOUR for k in range(n)],
                                       [HOUR] * n, tol=1e-8, maxiter=40)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
    if not (rows[:, 5] == 1).all():
        raise AssertionError(f"graphs {mode}: profiled steps did not "
                             f"converge")
    busy_us = ops = 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", None)
            busy_us += ev.self_cuda_time_total if us is None else us
            ops += ev.count
    if not ops:
        return rows, None, None
    return rows, 1.0 - busy_us / wall_us, ops / n


def graphs_phase(st, cfg, card):
    """Phase 22: cavern600 (sweep off), the headline configuration (sweep
    "auto") and box17, each captured and under ``graphs.eager()`` in
    turns; the block-size sweep at cavern600; the profiled steps last (the
    profiler leaves a cost on every later launch of its process).  Returns
    {kernel name: (launches, per step)} of the captured runs' timed
    chunks at cavern600 and box17."""
    from safeincave_torch.fem import solvers
    ways, secs, t_start = {}, {}, time.perf_counter()
    for name, golden_name, sweep in GRAPH_WAYS:
        golden = np.load(GOLDEN.format(golden_name))
        grid = (cfg.cavern600_grid(st) if golden_name == "cavern600"
                else cfg.box17_grid(st))
        eqs, clocks, u_el = {}, {}, {}
        for mode in GRAPH_MODES:
            with mode_ctx(mode):
                eq = cfg.wire_bench(st, grid, precond="auto",
                                    fp32_phase=sweep)
                cfg.elastic_init(eq)
            eqs[mode], clocks[mode] = eq, StepClock(eq)
            u_el[mode] = eq.u.cpu().numpy()
        # steps 1-3 against the golden phases 5 and 7 hold
        first = {m: graph_chunk(eqs[m], m, clocks[m], HOUR, 3)
                 for m in GRAPH_MODES}
        for m in GRAPH_MODES:
            parity(f"graphs {name} {m}", golden, u_el[m], first[m]["rows"],
                   eqs[m].u.cpu().numpy(), eqs[m].sig_v.cpu().numpy())
        w = dict(eqs=eqs, clocks=clocks, runs={m: [] for m in GRAPH_MODES},
                 t=4 * HOUR, golden=golden_name)
        w["gap"], w["bitwise"] = same_work(
            f"{name} steps 1-3", {m: r["rows"] for m, r in first.items()},
            eqs)
        for turn in range(GRAPH_TURNS):
            pair = {m: graph_chunk(eqs[m], m, clocks[m], w["t"], GRAPH_STEPS)
                    for m in GRAPH_MODES}
            hold_graphs(w, f"{name} turn {turn + 1}",
                 {m: r["rows"] for m, r in pair.items()})
            for m in GRAPH_MODES:
                w["runs"][m].append(pair[m])
            w["t"] += GRAPH_STEPS * HOUR
        ways[name] = w
        secs[name] = time.perf_counter() - t_start - sum(secs.values())
    block_sweep(st, cfg, solvers, card)
    secs["block sizes"] = time.perf_counter() - t_start - sum(secs.values())
    launched = {}
    for name, w in ways.items():
        idle = {m: idle_share(w["eqs"][m], m, w["t"]) for m in GRAPH_MODES}
        hold_graphs(w, f"{name} profiled", {m: r[0] for m, r in idle.items()})
        report(name, w, idle, card)
        kname = BAND["name"] if w["golden"] == "cavern600" else DIA["name"]
        n = sum(r["launches_total"] for r in w["runs"]["captured"])
        if n <= 0:
            raise AssertionError(f"graphs {name}: the captured run launched "
                                 f"no {kname}")
        if name != "headline":
            launched[kname] = (n, n / (GRAPH_TURNS * GRAPH_STEPS))
    secs["profiled"] = time.perf_counter() - t_start - sum(secs.values())
    say("graphs", "phase 22 took " + ", ".join(
        f"{k} {v:.1f} s" for k, v in secs.items())
        + f" ({time.perf_counter() - t_start:.1f} s)")
    return launched


def hold_graphs(w, tag, rows):
    g, b = same_work(tag, rows, w["eqs"])
    w["gap"], w["bitwise"] = max(w["gap"], g), w["bitwise"] and b


def report(name, w, idle, card):
    kind = "band" if w["golden"] == "cavern600" else "DIA"
    for m in GRAPH_MODES:
        rs = w["runs"][m]
        med = lambda k: float(np.median([r[k] for r in rs]))  # noqa: E731
        _, share, ops = idle[m]
        idle_text = ("not measured (no device event)" if share is None else
                     f"{100 * share:.1f}% over 2 steps ({ops:.0f} device "
                     f"operations/step)")
        chunks = ", ".join(f"{r['ms']:.1f}" for r in rs)
        say("graphs", f"{name} {m}: {chunks} ms/step (median "
                      f"{med('ms'):.1f}); tangent build "
                      f"{med('tangent_ms'):.2f} ms ({med('builds'):.2f}/step)"
                      f", linear solve {med('solve_ms'):.2f} ms "
                      f"({med('solves'):.2f}/step); "
                      f"{rs[0]['rows'][:, 0].mean():.2f} fixed-point, "
                      f"{rs[0]['rows'][:, 2].mean():.1f} Krylov it/step; "
                      f"host reads {med('reads'):.1f}/step; graph replays "
                      f"{med('replays'):.1f}/step; {kind} launches "
                      f"{med('launches'):.1f}/step; device idle {idle_text}"
                      f" | {card}")
    say("graphs", f"{name}: captured = eager in fixed-point and Krylov "
                  f"counts in every chunk; fields "
                  + ("bitwise equal" if w["bitwise"] else
                     f"within {w['gap']:.2e} of max|ref|") + f" | {card}")


def block_sweep(st, cfg, solvers, card):
    """Phase 4's equation captured at each block size of GRAPH_BLOCKS, from
    its elastic state: one chunk each to capture, then two timed rounds in
    turns (descending, ascending).  The module's BLOCK is restored."""
    chosen = solvers.BLOCK
    eq = cfg.wire_bench(st, cfg.cavern600_grid(st), precond="auto")
    cfg.elastic_init(eq)
    clock, t = StepClock(eq), HOUR
    got = {B: [] for B in GRAPH_BLOCKS}
    order = (list(GRAPH_BLOCKS) + list(GRAPH_BLOCKS[::-1])
             + list(GRAPH_BLOCKS))
    try:
        for i, B in enumerate(order):
            solvers.BLOCK = B
            r = graph_chunk(eq, "captured", clock, t, GRAPH_STEPS)
            t += GRAPH_STEPS * HOUR
            if i >= len(GRAPH_BLOCKS):
                got[B].append(r)
    finally:
        solvers.BLOCK = chosen
    parts = []
    for B, rs in got.items():
        ms = "/".join(f"{r['ms']:.1f}" for r in rs)
        parts.append(f"B={B} {ms} ms/step, solve "
                     f"{np.mean([r['solve_ms'] for r in rs]):.2f} ms, "
                     f"{np.mean([r['reads'] for r in rs]):.1f} reads/step, "
                     f"{np.mean([r['rows'][:, 2].mean() for r in rs]):.1f} "
                     f"Krylov it/step")
    say("graphs", "cavern600 captured by Krylov block size: "
                  + "; ".join(parts) + f" (module BLOCK = {chosen}) | "
                  + card)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", help="run phase 3 alone on the "
                    "safeincave_torch package of this checkout")
    ap.add_argument("--json-child", nargs="+",
                    metavar="CASE RESULT [auto|off]",
                    help="phase 9's child: run sim_cli on CASE, write the "
                    "stage records to RESULT; 'off' runs without the f32 "
                    "sweep")
    ap.add_argument("--phase", choices=("tm", "tm_box", "lag", "yearly",
                                        "order", "point", "examples",
                                        "tm_cyclic", "bench", "gpu_tests",
                                        "conformance", "graphs", "band64",
                                        "halo", "cards"),
                    help="after the build, run this phase alone (no kernel "
                    "JSON and no ok line); 'cards' needs 4 cards")
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
    kernels = [k for k in KERNELS if k in _build.SIGNATURES]  # older --tree
    _build.build(kernels)
    for name in kernels:
        _build.load(name)
    say("build", f"{', '.join(kernels)} built in parallel and loaded in "
                 f"{time.perf_counter() - t0:.2f} s (nvcc: " + ", ".join(
                     f"{n} {_build.build_seconds.get(n, 0.0):.2f} s"
                     for n in kernels) + ")")
    if hasattr(st.mesh, "native"):      # absent from an older --tree
        if not st.mesh.native.available():
            raise AssertionError("native/mesh_preprocess.cpp did not build "
                                 "with the host compiler")
        say("build", f"native mesh preprocessing: the C++ library ran "
                     f"({os.path.basename(st.mesh.native._lib._name)}, g++ "
                     f"{_build.build_seconds.get('sicpre', 0.0):.2f} s); the "
                     f"numpy versions did not")

    # 3. kernels vs plain and cuSPARSE, every shape ------------------------ #
    if args.tree:
        print(json.dumps({"tree": args.tree,
                          "kernels": kernel_phase(st, cfg, dev)}), flush=True)
        print(card, flush=True)
        return
    if args.phase:
        with tempfile.TemporaryDirectory() as tmp:
            print({"tm": lambda: tm_phase(st, cfg, tmp),
                   "tm_box": lambda: tm_box_phase(st, cfg),
                   "lag": lambda: lag_phase(st, cfg),
                   "yearly": lambda: yearly_phase(st, cfg, dev, tmp),
                   "order": lambda: order_phase(st, cfg),
                   "point": lambda: point_phase(st, cfg, dev),
                   "examples": lambda: examples_phase(st, cfg, dev, tmp,
                                                      card),
                   "tm_cyclic": lambda: tm_cyclic_phase(st, cfg, dev, card),
                   "bench": lambda: bench_phase(card),
                   "gpu_tests": gpu_tests_phase,
                   "conformance": lambda: conformance_phase(st, cfg, dev,
                                                            card),
                   "graphs": lambda: graphs_phase(st, cfg, card),
                   "band64": lambda: band64_phase(st, cfg, dev),
                   "halo": lambda: halo_phase(st, cfg, dev, card),
                   "cards": lambda: cards_phase(st, cfg),
                   }[args.phase](),
                  flush=True)
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
    sym = eq._sym_dense()
    u_elastic = eq.u.cpu().numpy()
    elastic_krylov = eq.solver_stats[0]
    rows3 = eq.solve_time_steps([(k + 1) * HOUR for k in range(3)],
                                [HOUR] * 3, tol=1e-8, maxiter=40)
    u3, sig3 = eq.u.cpu().numpy(), eq.sig_v.cpu().numpy()
    ((rows1, _),) = run_chunks(eq, 4 * HOUR, (10,))
    before, sym_before = band.launches, sym.launches
    ((rows2, secs2),) = run_chunks(eq, 14 * HOUR, (10,))
    launches, sym_launches = band.launches, sym.launches
    band_per_step = (launches - before) / len(rows2)
    sym_per_step = (sym_launches - sym_before) / len(rows2)
    all_rows = np.concatenate([rows3, rows1, rows2])
    if not (all_rows[:, 5] == 1).all():
        raise AssertionError(f"non-converged steps: {all_rows[:, [0, 1, 5]]}")
    if launches <= 0 or sym_per_step <= 0:
        raise AssertionError("the main path never launched the band kernel "
                             "or the dense preconditioner's kernel")
    say("main", f"elastic {elastic_s:.2f} s incl. dense preconditioner "
                f"({elastic_krylov} Krylov); 23 steps converged; chunk 2: "
                f"{1e3 * secs2 / len(rows2):.1f} ms/step, "
                f"{rows2[:, 0].mean():.2f} fixed-point it/step, "
                f"{rows2[:, 2].mean():.1f} Krylov it/step; band launches "
                f"{launches}, {band_per_step:.1f} per step in chunk 2; "
                f"preconditioner applies {sym_launches}, {sym_per_step:.1f} "
                f"per step; peak "
                f"device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # 5. cavern600 parity --------------------------------------------------- #
    parity("parity", golden, u_elastic, rows3, u3, sig3)
    del eq, P, band, sym

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
        # 13. the yearly production run on the 38k-tet mesh ----------------- #
        yearly = yearly_phase(st, cfg, dev, tmp)

    # 11. the coupled chunk on box17: block-DIA and the f32 sweep ---------- #
    tm_box_launches, tm_box_per_step = tm_box_phase(st, cfg)

    # 12. tangent lagging and adaptive tolerances on the main path --------- #
    lag = lag_phase(st, cfg)
    # 14. node orders of the cavern mesh; 15. the point simulators --------- #
    order_phase(st, cfg)
    point_phase(st, cfg, dev)
    # 17. the examples tree through the twins' main ---------------------- #
    with tempfile.TemporaryDirectory() as tmp:
        examples = examples_phase(st, cfg, dev, tmp, card)
    # 18. bench.py's TM-cyclic configurations on the band kernel --------- #
    tm_cyclic = tm_cyclic_phase(st, cfg, dev, card)
    # 19. bench_torch.py in a child; 20. the GPU tests in a child --------- #
    bench = bench_phase(card)
    gpu_tests_phase()
    # 21. the original stack's oracle and the remaining snapshots --------- #
    conformance = conformance_phase(st, cfg, dev, card)
    # 22. the captured time step against graphs.eager(); it profiles ----- #
    graph_launches = graphs_phase(st, cfg, card)
    # 23. the f64 band action against the cumsum matvec; it profiles ----- #
    band64_phase(st, cfg, dev)
    # 16. the parallel layer and the app runner; last, as it profiles ----- #
    halo_phase(st, cfg, dev, card)

    # launches of each path, each counted from 0 just before the path ran
    paths = {BAND["name"]: {"main": (launches, band_per_step),
                            "sim": (sim_launches, sim_per_step),
                            "tm": (tm_launches, tm_per_step),
                            "lag": lag, "yearly": yearly, **tm_cyclic,
                            "bench": bench[BAND["name"]],
                            "conformance": (conformance[BAND["name"]],
                                            None),
                            "graphs": graph_launches[BAND["name"]]},
             DIA["name"]: {"box": (launches_box, dia_per_step),
                           "json": (json_launches, json_per_step),
                           "tm_box": (tm_box_launches, tm_box_per_step),
                           "examples": examples,
                           "bench": bench[DIA["name"]],
                           "conformance": (conformance[DIA["name"]], None),
                           "graphs": graph_launches[DIA["name"]]},
             SYM["name"]: {"main": (sym_launches, sym_per_step)}}
    for row in kernel_rows:
        by_path = paths[row["name"]]
        # a row of a mesh reports the path that runs at its shape
        own = next((p for mesh, p in OWN_PATH.items()
                    if row["shape"].startswith(mesh) and p in by_path),
                   next(iter(by_path)))
        row["launches"], row["launches_per_step"] = by_path[own]
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
