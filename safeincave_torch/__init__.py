"""safeincave_torch - PyTorch/CUDA port of safeincave_tpu.

The port goes slice by slice; seven are in:

1. the cavern mechanics main path: band-reordered tet meshes, Spring +
   Viscoelastic + DislocationCreep + ViscoplasticDesai, Dirichlet supports
   and Neumann pressure, the elastic response and the fused multi-step
   fixed point, with the f32 Krylov operator as a hand-written CUDA band
   kernel;
2. the structured-box path: the assembled block-DIA operator with its CUDA
   kernel, auto-selected for natural-order grids, and the f32 fixed-point
   sweep;
3. the simulation driver path: ``Simulator_M`` / ``Simulator_Mout`` with
   dt-halving retry over any time controller, ``SaveFields`` XDMF output,
   the node/element smoother, ``StepMetrics``, checkpoints, pressure
   schedules, post-processing readers, and the JSON driver
   (``Simulator_GUI``, ``python -m safeincave_torch.app.sim_cli``);
4. the thermal and thermo-mechanical path: ``HeatDiffusion`` with its
   Dirichlet / Neumann / Robin conditions (``HeatBC``), ``Thermoelastic``
   and the thermal strain in the momentum fixed point, ``Simulator_T`` /
   ``Simulator_TM`` over the fused ``solve_tm_time_steps``, checkpoints
   with the heat field, and the remaining mechanisms of the JSON schema
   (pressure-solution and Munson-Dawson creep, Mohr-Coulomb and
   Matsuoka-Nakai viscoplasticity);
5. the solver options and the surfaces around the solver: tangent lagging
   and adaptive inner tolerances with the loose-mode rollback, the bf16
   dense preconditioner, the assembled block-ELL operator, the
   reference-style equation methods (``initialize``, ``compute_CT``,
   ``compute_eps_rhs``, ``compute_stress``, ``solve``), Morton and RCB
   reordering with the native preprocessing library, ``GridBoxRegions``,
   the cavern mesh generator with its catalog (``mesh/cavern_gen.py``,
   reached by ``find_grid``), and the material-point simulators with
   ``calibrate`` on ``torch.autograd``;
6. the parallel layer and the rest of the application layer:
   ``parallel.shard_equation`` (owned-node halo exchange or a summed
   assembly over D parts, all on one device) and ``parallel.shard_tm``, and
   ``app`` (the case builder, the terminal editor, the subprocess runner,
   the script runner and the Tk GUI);
7. the outputs without h5py: ``output/hdf5.py``, the port's own writer and
   reader of the HDF5 subset that ``SaveFields`` needs, and the examples
   tree as ``safeincave_torch/examples/`` (the repository's examples on
   the port, run from a checkout).

Module names follow ``safeincave_tpu`` so each counterpart is easy to find.
Entry points run on the card unless given ``device="cpu"``.  The package
imports torch, numpy and scipy, never jax or h5py.
"""
__version__ = "0.1.0"    # the JAX package's version

from ._device import default_device
from . import utils as Utils  # noqa: N812  (reference-compatible alias)
from .utils import GPa, MPa, kPa, minute, hour, day, year
from .materials import (Material, NonElasticElement, Spring, Thermoelastic,
                        Viscoelastic, DislocationCreep,
                        PressureSolutionCreep, MunsonDawsonCreep,
                        ViscoplasticDesai, MohrCoulombViscoplastic,
                        MatsuokaNakaiViscoplastic)
from .timecontrol import (TimeControllerBase, TimeController,
                          TimeControllerParabolic, TimeControllerFromList,
                          AdaptiveTimeController, build_time_list_by_dp_limit)
from .mesh import Grid, GridHandlerGMSH, GridBox, GridBoxRegions
from .fem import (LinearMomentumBase, LinearMomentum, SolverSettings,
                  HeatDiffusion)
from .bcs import MomentumBC, HeatBC
from .output import SaveFields, ScreenPrinter
from .simulators import (Simulator_M, Simulator_Mout, Simulator_T,
                         Simulator_TM)
from .config import Simulator_GUI, run_from_json
from .matpoint import MaterialPointSimulator, TriaxialSimulator, calibrate
from .checkpoint import save_checkpoint, load_checkpoint
from .metrics import StepMetrics
from . import postproc as PostProcessingTools  # noqa: N812

__all__ = [
    "default_device", "Utils", "GPa", "MPa", "kPa", "minute", "hour", "day",
    "year", "Material", "NonElasticElement", "Spring", "Viscoelastic",
    "DislocationCreep", "ViscoplasticDesai", "Thermoelastic",
    "PressureSolutionCreep", "MunsonDawsonCreep", "MohrCoulombViscoplastic",
    "MatsuokaNakaiViscoplastic", "HeatDiffusion", "HeatBC", "Simulator_T",
    "Simulator_TM",
    "TimeControllerBase", "TimeController", "TimeControllerParabolic",
    "TimeControllerFromList", "AdaptiveTimeController",
    "build_time_list_by_dp_limit",
    "Grid", "GridHandlerGMSH", "GridBox", "GridBoxRegions",
    "MaterialPointSimulator", "TriaxialSimulator", "calibrate",
    "LinearMomentumBase",
    "LinearMomentum", "SolverSettings", "MomentumBC", "SaveFields",
    "ScreenPrinter", "Simulator_M", "Simulator_Mout", "Simulator_GUI",
    "run_from_json", "PostProcessingTools", "save_checkpoint",
    "load_checkpoint", "StepMetrics",
]
