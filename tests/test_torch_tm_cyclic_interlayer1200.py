"""bench.py's TM-cyclic configuration on the repository's
cavern_interlayer_1200 mesh (7,669 nodes, 38,542 tets; Mohr-Coulomb
interlayers and an Overburden cap): the JAX twin against bench.py's
builder and the port's elastic response against the golden; the first
step (~3 min on the CPU) is ``slow``
(tests/torch_tm_cyclic_check.py)."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_tm_cyclic_check as chk  # noqa: E402
from torch_examples_check import one_torch_thread  # noqa: E402,F401

PATH = "tmcyc_interlayer1200"


def test_twin_equals_bench_builder(tmp_path):
    chk.bench_builder_matches(PATH, tmp_path)


def test_port_elastic_against_golden(one_torch_thread):
    chk.port_against_golden(PATH, steps=0)


@pytest.mark.slow
def test_port_step_against_golden(one_torch_thread):
    chk.port_against_golden(PATH, steps=1)
