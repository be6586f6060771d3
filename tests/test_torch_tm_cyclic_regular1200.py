"""bench.py's TM-cyclic configuration on cavern_proxy_1200 (6,816 nodes,
34,376 tets): bench.py's interlayer test is case-sensitive ("nterlayer"),
so the mesh's "INTERLAYER" region runs as single-region Kelvin-Voigt +
dislocation creep.  The JAX twin against bench.py's builder, and the port
on the CPU against the golden over the elastic response and the first
step (tests/torch_tm_cyclic_check.py)."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_tm_cyclic_check as chk  # noqa: E402
from torch_examples_check import one_torch_thread  # noqa: E402,F401

PATH = "tmcyc_regular1200"


def test_twin_equals_bench_builder(tmp_path):
    chk.bench_builder_matches(PATH, tmp_path)


def test_port_against_golden(one_torch_thread):
    chk.port_against_golden(PATH, steps=1)
