"""The f64 band stiffness action on the CPU: ``BandMatvec.operator64``'s
plain twin and the routing of ``_f64_action``.

On a CPU tensor ``operator64`` is ``band_matvec_plain`` in f64 on the
vol-folded tangent of ``pack_ct64``; it agrees with ``MomentumKernel.matvec``
(the cumsum plan, the volume multiplied into the forces) at 1e-13 max|ref|:
only the order of the sums and the place of the volume factor differ.  The
CUDA kernel runs on the card alone (tests/test_torch_kernels_gpu.py).

``_f64_action`` hands the defect-correction residual to the f64 band kernel
only for a band-ordered kernel on CUDA with no assembled operator.  On the
CPU, and on a structured block-DIA box, it keeps the cumsum matvec: the same
data tensor, and the same bits as ``MomentumKernel.matvec``.
"""
import numpy as np
import pytest
import torch

import safeincave_torch as st
import torch_port_configs as cfg
from safeincave_torch.fem import momentum
from safeincave_torch.fem.kernels import MomentumKernel

torch.set_num_threads(1)

GRIDS = {"cavern600": lambda: cfg.cavern600_grid(st),
         "yearly": lambda: cfg.yearly_grid(st)}


def _ct(E, rng):
    """Random energy-symmetric tangent (6, 6, E), f64."""
    M = rng.normal(size=(E, 6, 6))
    CT = 0.5 * (M + np.transpose(M, (0, 2, 1))) + 8.0 * np.eye(6)
    w = np.diag([1.0, 1, 1, 2, 2, 2])
    CT = 0.5 * (CT + np.linalg.inv(w) @ np.transpose(CT, (0, 2, 1)) @ w)
    return torch.as_tensor(np.ascontiguousarray(np.transpose(CT, (1, 2, 0))))


@pytest.mark.parametrize("name", list(GRIDS))
def test_operator64_plain_twin_matches_the_cumsum_matvec(name):
    grid = GRIDS[name]()
    rng = np.random.default_rng(7)
    kern = MomentumKernel(grid, "cpu")
    band = kern.enable_band()
    CT = _ct(grid.n_elems, rng)
    ctv = band.pack_ct64(CT)
    assert ctv.dtype == torch.float64 and ctv.is_contiguous()
    assert tuple(ctv.shape) == (36, grid.n_elems)
    assert torch.equal(ctv, (CT * kern.geom(torch.float64)[1])
                       .reshape(36, -1))
    u = torch.as_tensor(rng.normal(size=(grid.n_nodes, 3)))
    got = band.operator64(ctv)(u)
    ref = kern.matvec(CT, u)
    assert got.dtype == torch.float64
    assert (got - ref).abs().max().item() <= 1e-13 * ref.abs().max().item()
    assert band.launches64 == band.launches == 0   # the plain twin


def _box_dia():
    kern = MomentumKernel(st.GridBox(Lx=1.0, Ly=2.0, Lz=1.5, nx=3, ny=3,
                                     nz=3), "cpu")
    assert kern.enable_dia().structured
    return kern


def _band_cpu():
    kern = MomentumKernel(cfg.cavern600_grid(st), "cpu")
    kern.enable_band()
    return kern


@pytest.mark.parametrize("make", [_band_cpu, _box_dia],
                         ids=["band_on_cpu", "structured_dia_box"])
def test_f64_action_keeps_the_cumsum_operator(make):
    kern = make()
    rng = np.random.default_rng(8)
    CT = _ct(kern.n_elems, rng)
    mk, data, planes = momentum._f64_action(kern, CT)
    assert data is CT and planes is None
    u = torch.as_tensor(rng.normal(size=(kern.n_nodes, 3)))
    assert torch.equal(mk(data)(u), kern.matvec(CT, u))
    if kern.band is not None:
        assert kern.band.launches64 == 0


def test_counters_carry_band64_launches():
    """A band-wired equation on the CPU solves through the cumsum f64
    action: the counter is there and reads 0."""
    eq = cfg.wire_bench(st, cfg.cavern600_grid(st), precond="2level",
                        device="cpu")
    eq.enable_band_matvec()
    assert eq.counters()["band64_launches"] == 0
    cfg.elastic_init(eq)
    assert eq.solver_stats[0] > 0
    c = eq.counters()
    assert c["band64_launches"] == 0 and c["band_launches"] == 0
