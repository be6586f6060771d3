"""The benchmark of safeincave_torch, the PyTorch/CUDA port: one cell of
BENCHMARK.json per run.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is a configuration (``configs/<name>.json`` and its builder
``configs/<name>.py``) under a traffic mix (``traffic/<name>.json``); the
metrics are the readers ``metrics/<name>.py`` that BENCHMARK.json lists,
the f32 stiffness action's implementations are ``kernels/*.json``, the
plain reference is ``reference/`` and the limits of the comparison are
``limits/<cell>.json``.  Each is found by its name.

The run needs as many CUDA devices as the cell asks for and exits non-zero
without them (``--rehearse-cpu`` runs the whole path on the CPU, on a small
generated mesh, for the tests).  ``--seed`` picks where in the loading
schedule the episodes start.  Set-up builds the configuration, runs its
warm stages, saves that state and runs one episode outside the window;
then episodes repeat from the saved state until ``--seconds`` have passed
(the window ends with the episode that crosses it).  ``--trace 0`` prints
the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics from an
instrumented window and one profiled episode after it.  After the window
the program's state is freed and the plain reference runs the same episode
from the same inputs; the last episode's saved fields and end state are
judged against it.  Standard output's last line is the result as JSON; the
numbers compared close standard error and the result line.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import glob  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from spec import BENCH, ROOT, load_json, load_module  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "safeincave_tpu")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def fail(msg, code):
    log(f"benchmark: {msg}")
    sys.exit(code)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="run on the CPU on a small generated mesh (tests)")
    return ap.parse_args(argv)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_metric(name):
    return load_module(os.path.join(BENCH, "metrics", f"{name}.py"),
                       f"bench_metric_{name}")


def metrics_of(spec, cell, trace):
    """The BENCHMARK.json metrics this cell reports in this mode."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def rehearsal_mesh(work, n=4):
    """A small two-interlayer cavern mesh (``n`` cells a side) written as
    ``geom.msh`` into a directory of ``work``, standing in for a
    configuration's grid."""
    from safeincave_torch.mesh.cavern_gen import GridCavern, InterlayerBand
    from safeincave_torch.mesh.msh_io import write_msh
    g = GridCavern(L=450.0, H=660.0, n=n,
                   interlayers=[InterlayerBand(250.0, 40.0, dip_deg=8.0),
                                InterlayerBand(430.0, 35.0, dip_deg=-5.0)],
                   overburden_from=560.0)
    folder = os.path.join(work, "mesh")
    os.makedirs(folder)
    fields = {n: (t, d) for d, names in g.dolfin_tags.items()
              for n, t in names.items()}
    write_msh(os.path.join(folder, "geom.msh"), g.points, g.conn,
              g.elem_tags, g.tris, g.tri_tags, fields)
    return folder


def card_info(torch, device, chips):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "memory_peak_bytes":
                int(torch.cuda.max_memory_allocated(device)),
            "power_limit": limit.stdout.strip().splitlines()[0]
            if limit.returncode == 0 and limit.stdout.strip() else None}


def main(argv=None):
    args = parse(argv)
    spec_path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.isfile(spec_path):
        fail("no BENCHMARK.json beside the benchmark", 2)
    with open(spec_path) as f:
        spec = json.load(f)
    cell = next((w for w in spec["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        fail(f"no workload {args.workload!r} in BENCHMARK.json", 2)
    if not os.path.isdir(os.path.join(ROOT, "safeincave_torch")):
        fail("the program (safeincave_torch) is not in this checkout", 2)
    import torch
    if not args.rehearse_cpu and (not torch.cuda.is_available()
                                  or torch.cuda.device_count()
                                  < cell["chips"]):
        fail(f"{cell['chips']} CUDA device(s) needed, "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
             f" visible", 3)
    device = torch.device("cpu" if args.rehearse_cpu else "cuda")
    torch.set_num_threads(2)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    sys.path[:0] = [BENCH, ROOT]
    import episodes
    from judge import judge
    from reference.episode import reference

    wanted = metrics_of(spec, cell["name"], args.trace)
    work = tempfile.mkdtemp(prefix="bench_", dir=os.environ.get("TMPDIR"))
    try:
        result = run_cell(args, cell, device, work, wanted, episodes, judge,
                          reference, torch)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    bad = forbidden_modules()
    if bad:
        fail(f"modules loaded that the port must not load: {bad}", 5)
    checks = result.pop("checks")
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    result["checks"] = checks
    print(json.dumps(result), flush=True)


def run_cell(args, cell, device, work, wanted, episodes, judge, reference,
             torch):
    with open(os.devnull, "w") as quiet:
        return _run_cell(args, cell, device, work, wanted, episodes, judge,
                         reference, torch, quiet)


def _run_cell(args, cell, device, work, wanted, episodes, judge, reference,
              torch, quiet):
    mesh_dir = rehearsal_mesh(work) if args.rehearse_cpu else None
    c = episodes.Cell(cell, args.seed, device, ROOT, work, mesh_dir)
    trace = {"reads": 0, "tangent_ms": [], "solve_ms": [], "heat_ms": [],
             "profile": None}
    with contextlib.redirect_stdout(quiet), \
            episodes.Recorder(c.sync, timed=bool(args.trace)) as rec:
        t_imports = time.perf_counter() - T0
        c.setup()
        t_first = time.perf_counter()
        first = c.episode(rec)
        setup_s = time.perf_counter() - T0
        c.phases = {"imports": t_imports, **c.phases,
                    "first_episode": time.perf_counter() - t_first}
        clock = episodes.StepClock(c.eq, c.heat) \
            if args.trace and device.type == "cuda" else None
        window, t_start, t_epoch = [], time.perf_counter(), time.time()
        end_state = os.path.join(work, "end_state.npz")
        reads = episodes.counting_reads() if args.trace \
            else contextlib.nullcontext([0])
        with reads as n_reads:
            while True:
                window.append(c.episode(rec, timed=bool(args.trace)))
                if time.perf_counter() - t_start >= args.seconds:
                    break
        episodes.save_checkpoint(end_state, c.eq, heat_eq=c.heat)
        trace["reads"] = n_reads[0]
        if clock is not None:
            spans = clock.take()
            clock.close()
            trace["tangent_ms"], trace["solve_ms"] = spans["tangent"], \
                spans["solve"]
            trace["heat_ms"] = spans["heat"]
        if args.trace and device.type == "cuda":
            from devtrace import profile_call
            rec.timed = False
            keep = c.work
            c.work = os.path.join(work, "profiled")
            os.makedirs(c.work)
            trace["profile"] = profile_call(lambda: c.episode(rec), c.sync)
            c.work = keep
    last = window[-1]
    device_info = card_info(torch, device, cell["chips"])
    n_elems, n_nodes = c.eq.n_elems, c.eq.n_nodes
    del c.eq, c.heat, clock
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    log(f"{cell['name']} seed {args.seed}: start {c.start_h} h, "
        f"{len(window)} episodes, counts per episode (steps, fixed-point, "
        f"Krylov) {first['steps']}, {first['fp']}, {first['krylov']}"
        + ("" if first["heat_cg"] is None
           else f", heat CG iterations {first['heat_cg']}"))
    log("set-up s: " + ", ".join(f"{k} {v:.3f}" for k, v in c.phases.items()))
    log(f"window from {t_epoch:.3f} (epoch s); episode s: "
        + ", ".join(f"{e['seconds']:.4f}" for e in window))
    gaps = sorted(b - a for e in window
                  for a, b in zip(e["stamps"], e["stamps"][1:]))
    if gaps:
        log(f"save gaps ms: min {1e3 * gaps[0]:.1f}, median "
            f"{1e3 * gaps[len(gaps) // 2]:.1f}, max {1e3 * gaps[-1]:.1f}, "
            f"of {len(gaps)}")
    if trace["profile"]:
        from devtrace import kernel_base as base
        prof = trace["profile"]
        log(f"profiled episode {prof['window_s']:.4f} s, device busy "
            f"{prof['busy_s']:.4f} s; the same episode without the "
            f"profiler {prof['plain_s']:.4f} s")
        names = {}
        for k, (n, sec) in trace["profile"]["kernels"].items():
            had = names.get(base(k), (0, 0.0))
            names[base(k)] = (had[0] + n, had[1] + sec)
        log("profiled kernels (calls, device s): " + "; ".join(
            f"{k} {n} {sec:.4f}" for k, (n, sec) in sorted(
                names.items(), key=lambda kv: -kv[1][1])))

    t_ref = time.perf_counter()
    fields = [name for name, _ in c.traffic["fields"]]
    ref = reference(c.cfg, c.traffic, os.path.join(c.mesh_dir, "geom.msh"),
                    c.start_h, torch.float64, device, ROOT)
    numbers = judge(last["out_dir"], end_state, ref, fields)
    log(f"reference: {time.perf_counter() - t_ref:.1f} s, fixed-point "
        f"iterations per step {ref['iterations']}")
    has_limits = os.path.isfile(os.path.join(BENCH, "limits",
                                             f"{cell['name']}.json"))
    limits = load_json("limits", f"{cell['name']}.json") if has_limits \
        else {}
    attempted = sum(e["attempted"] for e in window)
    converged = sum(e["steps"] for e in window)
    same = [e["work"] == first["work"] for e in window]
    checks = {k: {"value": v, "limit": limits.get(k)}
              for k, v in numbers.items()}
    checks["episodes_other_work"] = {"value": same.count(False), "limit": 0}
    checks["steps_failed"] = {"value": attempted - converged, "limit": 0}
    correct = all(ch["limit"] is not None and ch["value"] <= ch["limit"]
                  for ch in checks.values())

    run = {"episodes": window, "setup_s": setup_s, "trace": trace,
           "shapes": {"n_elems": n_elems, "n_nodes": n_nodes},
           "kernels": [load_json("kernels", os.path.basename(p))
                       for p in sorted(glob.glob(
                           os.path.join(BENCH, "kernels", "*.json")))],
           "peak": load_json("peaks.json").get(device_info["kind"])}
    metrics = {}
    for m in wanted:
        value = load_metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": correct, "attempted": attempted,
           "failed": attempted - converged, "metrics": metrics,
           "device": device_info}
    if args.trace:
        prof = trace["profile"] or {}
        out["device"]["busy_s"] = prof.get("busy_s", 0.0)
        out["device"]["window_s"] = prof.get("window_s", 0.0)
        if prof:
            out["breakdown"] = {"device_ops": prof["device_ops"],
                                "idle_gaps": prof["idle_gaps"]}
    out["checks"] = checks
    return out


if __name__ == "__main__":
    main()
