"""Terminal editor for input_file.json cases (port of
``safeincave_tpu/app/editor.py``).

Dependency-free stand-in for the reference's Tkinter GUI suite (its
app/gsapp.py, MyBoundaryCond.py and MyConstitutiveModel.py): create,
inspect, edit, validate, and run a JSON case without hand-writing JSON.
``run`` runs on the card unless given ``--device cpu``.

Usage:
    python -m safeincave_torch.app.editor new case.json --grid grids/cube
    python -m safeincave_torch.app.editor show case.json
    python -m safeincave_torch.app.editor set case.json solver.method cg
    python -m safeincave_torch.app.editor add-bc case.json TOP neumann \
        --direction 2 --values 10e6 12e6
    python -m safeincave_torch.app.editor add-element case.json creep \
        DislocationCreep --params A=1.9e-20 Q=51600 n=3.0 T=298
    python -m safeincave_torch.app.editor import-csv case.json Cavern p.csv
    python -m safeincave_torch.app.editor validate case.json
    python -m safeincave_torch.app.editor run case.json [--device cpu]
    python -m safeincave_torch.app.editor edit case.json      (interactive)
"""
from __future__ import annotations

import argparse
import json
import sys

from .builder import InputFileBuilder, VALID_ELEMENT_TYPES, ELEMENT_PARAMS


def _parse_value(s: str):
    try:
        return json.loads(s)
    except json.JSONDecodeError:
        return s


def _show(b: InputFileBuilder):
    d = b.data
    print(f"grid: {d['grid']['path']}/{d['grid']['name']}.msh")
    print(f"  regions: {list(d['grid']['regions'])} "
          f"boundaries: {d['grid']['boundaries']}")
    print(f"output: {d['output']['path']}")
    s = d["solver_settings"]
    print(f"solver: {s['type']} method={s.get('method')} "
          f"rtol={s.get('relative_tolerance')}")
    bf = d["body_force"]
    print(f"body force: g={bf['gravity']} rho={bf['density']} "
          f"dir={bf['direction']}")
    ts = d["time_settings"]
    print(f"time: theta={ts['theta']} "
          f"time_list={ts['time_list'][:4]}{'...' if len(ts['time_list']) > 4 else ''} "
          f"({len(ts['time_list'])} pts)")
    eq = d["simulation_settings"]["equilibrium"]
    op = d["simulation_settings"]["operation"]
    print(f"equilibrium: active={eq['active']} dt_max={eq['dt_max']} "
          f"ite_max={eq['ite_max']}")
    print(f"operation: active={op['active']} dt_max={op['dt_max']} "
          f"hardening={op.get('hardening')}")
    print("boundary conditions:")
    for name, blk in d["boundary_conditions"].items():
        extra = (f"component={blk['component']}" if blk["type"] == "dirichlet"
                 else f"direction={blk['direction']} rho={blk['density']} "
                      f"zref={blk['reference_position']}")
        print(f"  {name}: {blk['type']} {extra} "
              f"values[{len(blk['values'])}]={blk['values'][:3]}...")
    print("constitutive model:")
    for name, blk in d["constitutive_model"]["elastic"].items():
        print(f"  {name}: Spring {blk['parameters']}")
    for name, blk in d["constitutive_model"]["nonelastic"].items():
        print(f"  {name}: {blk['type']} active={blk['active']} "
              f"equilibrium={blk.get('equilibrium')}")
    errs = b.validate()
    print("valid" if not errs else "PROBLEMS:\n  " + "\n  ".join(errs))


def _set_path(b: InputFileBuilder, dotted: str, value):
    """set a.b.c value  (aliases: solver.*, grid.*, output)."""
    alias = {"solver": "solver_settings", "time": "time_settings",
             "body": "body_force"}
    parts = dotted.split(".")
    parts[0] = alias.get(parts[0], parts[0])
    node = b.data
    for p in parts[:-1]:
        node = node[p]
    node[parts[-1]] = value


def _interactive(b: InputFileBuilder, path: str):
    print("interactive editor - commands: show | set <key> <value> | "
          "bc <name> dirichlet|neumann ... | save | run | quit")
    while True:
        try:
            line = input("sic> ").strip()
        except EOFError:
            break
        if not line:
            continue
        cmd, *rest = line.split()
        try:
            if cmd in ("q", "quit", "exit"):
                break
            elif cmd == "show":
                _show(b)
            elif cmd == "set" and len(rest) >= 2:
                _set_path(b, rest[0], _parse_value(" ".join(rest[1:])))
                print("ok")
            elif cmd == "save":
                b.save(rest[0] if rest else path)
                print(f"saved {rest[0] if rest else path}")
            elif cmd == "run":
                b.run()
            else:
                print("unknown command")
        except Exception as e:  # editor loop must survive user errors
            print(f"error: {e}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="safeincave_torch.app.editor")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("new")
    p.add_argument("file")
    p.add_argument("--grid", default="")
    p.add_argument("--grid-name", default="geom")

    for name in ("show", "validate", "run", "edit"):
        p = sub.add_parser(name)
        p.add_argument("file")
        if name == "run":
            p.add_argument("--device", choices=("cuda", "cpu"),
                           default="cuda")

    p = sub.add_parser("set")
    p.add_argument("file")
    p.add_argument("key")
    p.add_argument("value", nargs="+")

    p = sub.add_parser("add-bc")
    p.add_argument("file")
    p.add_argument("boundary")
    p.add_argument("type", choices=("dirichlet", "neumann"))
    p.add_argument("--component", type=int, default=0)
    p.add_argument("--direction", type=int, default=2)
    p.add_argument("--density", type=float, default=0.0)
    p.add_argument("--ref-pos", type=float, default=0.0)
    p.add_argument("--values", type=float, nargs="+", required=True)

    p = sub.add_parser("add-element")
    p.add_argument("file")
    p.add_argument("name")
    p.add_argument("type", choices=VALID_ELEMENT_TYPES + ("Spring",))
    p.add_argument("--params", nargs="+", default=[],
                   help="k=v pairs; expected: "
                        + "; ".join(f"{t}: {', '.join(ps)}"
                                    for t, ps in ELEMENT_PARAMS.items()))
    p.add_argument("--equilibrium", action="store_true")

    p = sub.add_parser("import-csv")
    p.add_argument("file")
    p.add_argument("boundary")
    p.add_argument("csv")
    p.add_argument("--direction", type=int, default=2)
    p.add_argument("--density", type=float, default=0.0)
    p.add_argument("--ref-pos", type=float, default=0.0)

    args = ap.parse_args(argv)

    if args.cmd == "new":
        b = InputFileBuilder()
        if args.grid:
            b.set_grid(args.grid, args.grid_name)
        b.data_path = args.file
        with open(args.file, "w") as f:
            json.dump(b.data, f, indent=2)   # skeleton may be incomplete
        print(f"created {args.file}")
        return 0

    b = InputFileBuilder.load(args.file)
    if args.cmd == "show":
        _show(b)
    elif args.cmd == "validate":
        errs = b.validate()
        if errs:
            print("\n".join(errs))
            return 1
        print("valid")
    elif args.cmd == "run":
        b.run(device=None if args.device == "cuda" else "cpu")
    elif args.cmd == "edit":
        _interactive(b, args.file)
    elif args.cmd == "set":
        _set_path(b, args.key, _parse_value(" ".join(args.value)))
        with open(args.file, "w") as f:
            json.dump(b.data, f, indent=2)
        print("ok")
    elif args.cmd == "add-bc":
        if args.type == "dirichlet":
            b.add_dirichlet(args.boundary, args.component, args.values)
        else:
            b.add_neumann(args.boundary, args.direction, args.values,
                          density=args.density,
                          reference_position=args.ref_pos)
        with open(args.file, "w") as f:
            json.dump(b.data, f, indent=2)
        print("ok")
    elif args.cmd == "add-element":
        params = dict(kv.split("=", 1) for kv in args.params)
        params = {k: _parse_value(v) for k, v in params.items()}
        if args.type == "Spring":
            b.set_elastic(args.name, params["E"], params["nu"])
        else:
            b.add_nonelastic(args.name, args.type, params,
                             equilibrium=args.equilibrium)
        with open(args.file, "w") as f:
            json.dump(b.data, f, indent=2)
        print("ok")
    elif args.cmd == "import-csv":
        b.import_pressure_csv(args.boundary, args.csv,
                              direction=args.direction,
                              density=args.density,
                              reference_position=args.ref_pos)
        with open(args.file, "w") as f:
            json.dump(b.data, f, indent=2)
        print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
