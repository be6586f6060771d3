"""Application layer: the JSON driver (``sim_cli``), the case builder and
terminal editor, the GUI and the runners (port of
``safeincave_tpu/app``)."""
from .builder import InputFileBuilder
from .simulator_runner import SimulatorRunner
from .script_runner import run_script


def gui(case_path=None):
    """Launch the Tkinter GUI (reference app/gsapp.py:23); imported lazily
    so headless environments never touch tkinter."""
    from .gsapp import gui as _gui
    _gui(case_path)


__all__ = ["InputFileBuilder", "SimulatorRunner", "run_script", "gui"]
