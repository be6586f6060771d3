"""The benchmark's data files, found by name: BENCHMARK.json at the
checkout's root, ``configs/``, ``traffic/``, ``limits/``, ``kernels/``,
``peaks.json``, and the reader or builder modules beside them."""
from __future__ import annotations

import importlib.util
import json
import os

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def load_json(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def start_hours(cfg, seed):
    """The hour of the configuration's schedule at which episodes start:
    ``base_h + step_h * (seed mod choices)``."""
    st = cfg["start"]
    return st["base_h"] + st["step_h"] * (int(seed) % st["choices"])
