"""Headless CLI: run a JSON-configured simulation on the card (or the CPU).

Usage:  python -m safeincave_torch.app.sim_cli --json input_file.json
        [--device cpu]
"""
import argparse

from ..config import run_from_json


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Run a safeincave-torch simulation from a JSON input "
                    "file.")
    parser.add_argument("--json", required=True,
                        help="path to the input_file.json")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the simulation runs (default: cuda; "
                             "raises when no CUDA device is visible)")
    args = parser.parse_args(argv)
    return run_from_json(args.json,
                         device=None if args.device == "cuda" else "cpu")


if __name__ == "__main__":
    main()
