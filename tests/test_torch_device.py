"""The port's default device.

Every entry point of ``safeincave_torch`` that takes ``device=None`` runs on
the card; without a visible CUDA device it raises and names
``device="cpu"``, and never falls back to the CPU on its own.  A CPU run asks
for the CPU, as every test of the port does.  ``torch.cuda.is_available``
is patched inside each test, never at import.
"""
import numpy as np
import pytest
import torch

import safeincave_torch as st
import torch_port_configs as cfg

CPU_HINT = 'device="cpu"'


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert st.default_device() == torch.device("cuda")


def test_default_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match=CPU_HINT):
        st.default_device()


def _entry_points():
    one = np.ones(2)
    return {
        "LinearMomentum": lambda: st.LinearMomentum(
            st.GridBox(nx=1, ny=1, nz=1), theta=0.5),
        "Material": lambda: st.Material(2),
        "Viscoelastic": lambda: st.Viscoelastic(one, one, 0.3 * one),
        "DislocationCreep": lambda: st.DislocationCreep(one, one, one),
        "ViscoplasticDesai": lambda: st.ViscoplasticDesai(*[one] * 11),
        "Thermoelastic": lambda: st.Thermoelastic(one),
        "PressureSolutionCreep": lambda: st.PressureSolutionCreep(one, one,
                                                                  one),
        "MunsonDawsonCreep": lambda: st.MunsonDawsonCreep(*[one] * 10),
        "MohrCoulombViscoplastic": lambda: st.MohrCoulombViscoplastic(
            *[one] * 6),
        "MatsuokaNakaiViscoplastic": lambda: st.MatsuokaNakaiViscoplastic(
            *[one] * 6),
        "HeatDiffusion": lambda: st.HeatDiffusion(
            st.GridBox(nx=1, ny=1, nz=1)),
        "SolverSettings.fp32_enabled": lambda: st.SolverSettings(
            fp32_phase="auto").fp32_enabled(),
    }


@pytest.mark.parametrize("entry", sorted(_entry_points()))
def test_entry_point_raises_without_cuda(no_cuda, entry):
    with pytest.raises(RuntimeError, match=CPU_HINT):
        _entry_points()[entry]()


def test_cpu_on_request(no_cuda):
    """``device="cpu"`` builds the whole equation on the CPU, material and
    mechanisms included; "auto" then keeps the f32 sweep off."""
    eq = cfg.wire_bench(st, st.GridBox(nx=2, ny=2, nz=2), fp32_phase="auto",
                        device="cpu")
    assert eq.device == torch.device("cpu")
    assert eq.u.device.type == eq.mat.C.device.type == "cpu"
    assert all(e.device.type == "cpu" for e in eq.mat.elems_ne)
    assert eq.kernel.band is None and eq.kernel.dia is None
    assert eq.solver.fp32_enabled(eq.device) is False
