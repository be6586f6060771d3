"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place and computed one precision below the
configuration's (float32 for its float64), judged by the same numbers
against the float64 reference.  It has to come out as not correct.

    python benchmark/control.py --workload <cell> --seed <n> [<n> ...]

prints one JSON line per seed with the control's numbers.  It runs on the
card when there is one (``--device cpu`` and ``--rehearse-cpu`` for the
tests); the benchmark's own runs never run it.
"""
import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH]

import torch  # noqa: E402

from spec import load_json, start_hours  # noqa: E402
from judge import STRAIN_LIKE, STRESS_FIELDS, gap  # noqa: E402
from reference.episode import reference  # noqa: E402


def control_numbers(ctl, ref):
    """The judge's fields_gap and state_gap of the run ``ctl`` against
    ``ref``, both reference results in the mesh file's order."""
    stress = abs(ref["state"]["sig_v"]).max()
    fgap = max(gap(a, r, stress if name in STRESS_FIELDS else 0.0)
               for name in ref["saves"]
               for a, r in zip(ctl["saves"][name], ref["saves"][name]))
    strain = abs(ref["state"]["eps_tot_v"]).max()
    sgap = max(gap(ctl["state"][k], r,
                   strain if k.endswith(STRAIN_LIKE) else 0.0)
               for k, r in ref["state"].items())
    return {"fields_gap": fgap, "state_gap": sgap}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", help="a geom.msh in place of the grid")
    args = ap.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cell = next(w for w in json.load(f)["workloads"]
                    if w["name"] == args.workload)
    cfg = load_json("configs", f"{cell['config']}.json")
    traffic = load_json("traffic", f"{cell['traffic']}.json")
    mesh = args.mesh or os.path.join(ROOT, "grids", cfg["mesh"]["grid"],
                                     "geom.msh")
    for seed in args.seed:
        start = start_hours(cfg, seed)
        t0 = time.perf_counter()
        ref = reference(cfg, traffic, mesh, start, torch.float64,
                        args.device, ROOT)
        t1 = time.perf_counter()
        ctl = reference(cfg, traffic, mesh, start, torch.float32,
                        args.device, ROOT, strict=False)
        out = control_numbers(ctl, ref)
        out.update(workload=args.workload, seed=seed, start_h=start,
                   reference_s=t1 - t0,
                   control_s=time.perf_counter() - t1,
                   reference_iterations=sum(ref["iterations"]),
                   control_iterations=sum(ctl["iterations"]))
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
