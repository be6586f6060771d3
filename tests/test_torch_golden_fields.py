"""PyTorch port vs tests/golden/fields.npz: the cavern box and the
interlayer TM snapshots.

tests/test_golden_fields.py holds the JAX package to four snapshots; the
port's triaxial and TM-cube runs are held to theirs in
tests/test_torch_momentum.py and tests/test_torch_tm.py.  Here the other
two, through the port on the CPU (one torch thread) with the settings the
snapshots were made with (the 2level preconditioner, the cumsum operator,
no f32 sweep), at that file's 1e-8 relative tolerance:

- ``cavern_u``/``cavern_sig``: gravity and a hydrostatic column on a box,
  three steps of tests/golden_configs.py's ``run_mechanics``;
- ``inter_u``/``inter_sig``/``inter_T``: Mohr-Coulomb interlayers in
  creeping salt on the generated multi-region cavern, thermoelastic
  coupling, three coupled steps.

Each builder's JAX branch (``torch_port_configs.cavern_box``,
``interlayer_tm`` and ``tm_cube``) sets up tests/golden_configs.py's
problem bit for bit.  The port runs pinned, as chip_smoke.py's gated
conformance phase runs it on the card; the pinned settings are shown to be
what each package's "auto" resolves to on the CPU, where the references
were made.
"""
import numpy as np
import pytest
import torch

import golden_configs as gc
import safeincave_tpu as sc
import safeincave_torch as st
import torch_port_configs as cfg
from test_golden_fields import _check

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def golden():
    with np.load(cfg.FIELDS_GOLDEN) as z:
        return {k: z[k] for k in z.files}


def test_cavern_box(golden):
    eq = cfg.cavern_box(st, "cpu", pin=True)
    assert eq.kernel.band is None and eq.kernel.dia is None
    u, sig, rows = cfg.run_sharding_steps(eq, n_steps=3)
    assert (rows[:, 1] <= 1e-8).all(), rows
    _check(u, "cavern_u", golden)
    _check(sig, "cavern_sig", golden)


def test_interlayer_tm(golden):
    eq, heat = cfg.interlayer_tm(st, "cpu", pin=True)
    assert eq.kernel.band is None and eq.kernel.dia is None
    rows = cfg.run_tm_steps(eq, heat)
    assert (rows[:, 1] <= 1e-6).all(), rows
    _check(cfg.as_np(eq.u), "inter_u", golden)
    _check(cfg.as_np(eq.sig_v), "inter_sig", golden)
    _check(cfg.as_np(heat.T), "inter_T", golden)


@pytest.mark.parametrize("name", ["cavern_box", "interlayer_tm", "tm_cube"])
def test_builder_equals_golden_configs(name):
    """The builder's JAX branch against tests/golden_configs.py's
    ``build_<name>``: the material, both boundary handlers' tables, the
    solver settings, the temperatures and the body force, bit for bit
    (``tm_cube`` is the builder tests/test_torch_tm.py holds to the
    snapshot's ``tm_*``)."""
    built = getattr(cfg, name)(sc)
    ref = getattr(gc, f"build_{name}")()
    got, want = (cfg.setup_arrays(*(b if isinstance(b, tuple) else (b,)))
                 for b in (built, ref))
    assert sorted(got) == sorted(want)
    tables = ["bc._dirichlet_meta.", "bc._neumann_meta.", "mat.elems_ne.1.",
              "solver.precond", "b_body"]
    if name != "cavern_box":
        tables += ["heat_bc.", "heat_T", "mat.elems_th."]
    for table in tables:
        assert any(k.startswith(table) for k in got), table
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", ["oracle_cube", "cavern_box",
                                  "interlayer_tm"])
def test_pinned_is_what_auto_resolves_to_on_the_cpu(name):
    """The port's pinned set-up (what the tests here and chip_smoke.py's
    gate run) is the JAX set-up the references were made with, but for the
    two pinned settings; and in each package, pinned and "auto" resolve on
    the CPU to the same preconditioner arrays, no f32 sweep and the cumsum
    operator."""
    def build(pkg, pin):
        b = getattr(cfg, name)(pkg, "cpu" if pkg is st else None, pin)
        eq, heat = b if name == "interlayer_tm" else (
            b[0] if isinstance(b, tuple) else b, None)
        return eq, cfg.setup_arrays(eq, heat)

    pinned_keys = {f"solver.{k}" for k in cfg.PINNED}
    _, port_setup = build(st, True)
    _, jax_setup = build(sc, False)
    assert pinned_keys <= set(port_setup)
    for k in pinned_keys:
        assert str(port_setup[k]) == str(cfg.PINNED[k[7:]]), k
    cfg.assert_same_setup(
        {k: v for k, v in port_setup.items() if k not in pinned_keys},
        {k: v for k, v in jax_setup.items() if k not in pinned_keys})
    for pkg in (st, sc):
        pinned, auto = (cfg.resolved(build(pkg, pin)[0])
                        for pin in (True, False))
        assert pinned[1:] == auto[1:] == (False, False, False), pkg.__name__
        assert len(pinned[0]) == len(auto[0]) == 2   # blocks and coarse
        for a, b in zip(pinned[0], auto[0]):
            np.testing.assert_array_equal(a, b)
