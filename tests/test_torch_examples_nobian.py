"""The nobian examples on the port, on the CPU, against the JAX examples'
goldens (tests/golden/torch_port_examples_{interlayer,yearly}.npz):
mechanics/nobian_interlayer (its SaveFields and Simulator_M subclasses on
the port's classes, ksp_log.jsonl) and mechanics/nobian_yearly at CI scale
cut as tests/test_nobian_yearly.py cuts it (StepMetrics, sparse saves, a
checkpoint, then --resume from it)."""
import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_examples_check as chk  # noqa: E402
from torch_examples_check import one_torch_thread  # noqa: E402,F401
import torch_port_configs as cfg  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_interlayer_twin(tmp_path):
    _, rec, out = chk.run_twin("interlayer", tmp_path)
    ref = chk.golden_record("interlayer", "cpu")
    chk.hold(rec, ref)
    chk.hold_xdmf(out, rec=ref, tmp=tmp_path)
    log = os.path.join(out, "nobian_interlayer", "ksp_log.jsonl")
    rows = [json.loads(ln) for ln in open(log) if ln.strip()]
    assert rows and {"t", "krylov_its", "krylov_rnorm",
                     "krylov_total"} <= set(rows[0])
    chk.plot("interlayer", tmp_path)


def test_yearly_twin_and_resume(tmp_path):
    summary, rec, out = chk.run_twin("yearly", tmp_path)
    assert summary["steps"] == 40 and summary["max_error"] <= 1e-8
    ref = chk.golden_record("yearly", "cpu")
    chk.hold(rec, ref)
    chk.hold_xdmf(out, rec=ref, tmp=tmp_path)
    root = os.path.join(out, "nobian_yearly")
    rows = [json.loads(ln) for ln in open(os.path.join(root,
                                                       "metrics.jsonl"))]
    assert len(rows) == 40 and all(r["converged"] for r in rows)
    chk.plot("yearly", tmp_path)
    # resume mid-year from the step-32 checkpoint
    script, kwargs, _ = cfg.EXAMPLE_RUNS["yearly"]
    resumed = cfg.run_example(
        "safeincave_torch", script, str(tmp_path / "resume"),
        {"argv": kwargs["argv"] + ["--resume",
                                   os.path.join(root, "checkpoint.npz")]},
        device="cpu")
    assert resumed["steps"] == 8 and resumed["max_error"] <= 1e-8
