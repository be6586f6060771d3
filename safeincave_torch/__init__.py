"""safeincave_torch - PyTorch/CUDA port of safeincave_tpu.

The port goes slice by slice; three are in:

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
   (``Simulator_GUI``, ``python -m safeincave_torch.app.sim_cli``).

Module names follow ``safeincave_tpu`` so each counterpart is easy to find.
Entry points run on the card unless given ``device="cpu"``.  The package
imports torch, numpy and scipy (h5py where HDF5 files are opened), never
jax.
"""
from ._device import default_device
from . import utils as Utils  # noqa: N812  (reference-compatible alias)
from .utils import GPa, MPa, kPa, minute, hour, day, year
from .materials import (Material, NonElasticElement, Spring, Viscoelastic,
                        DislocationCreep, ViscoplasticDesai)
from .timecontrol import (TimeControllerBase, TimeController,
                          TimeControllerParabolic, TimeControllerFromList,
                          AdaptiveTimeController, build_time_list_by_dp_limit)
from .mesh import Grid, GridHandlerGMSH, GridBox
from .fem import LinearMomentumBase, LinearMomentum, SolverSettings
from .bcs import MomentumBC
from .output import SaveFields, ScreenPrinter
from .simulators import Simulator_M, Simulator_Mout
from .config import Simulator_GUI, run_from_json
from .checkpoint import save_checkpoint, load_checkpoint
from .metrics import StepMetrics
from . import postproc as PostProcessingTools  # noqa: N812

__all__ = [
    "default_device", "Utils", "GPa", "MPa", "kPa", "minute", "hour", "day",
    "year", "Material", "NonElasticElement", "Spring", "Viscoelastic",
    "DislocationCreep", "ViscoplasticDesai",
    "TimeControllerBase", "TimeController", "TimeControllerParabolic",
    "TimeControllerFromList", "AdaptiveTimeController",
    "build_time_list_by_dp_limit",
    "Grid", "GridHandlerGMSH", "GridBox", "LinearMomentumBase",
    "LinearMomentum", "SolverSettings", "MomentumBC", "SaveFields",
    "ScreenPrinter", "Simulator_M", "Simulator_Mout", "Simulator_GUI",
    "run_from_json", "PostProcessingTools", "save_checkpoint",
    "load_checkpoint", "StepMetrics",
]
