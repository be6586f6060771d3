"""Out-of-process simulation launcher (port of
``safeincave_tpu/app/simulator_runner.py``).

Behavioral contract (reference safeincave/app/simulator_runner.py:3-50):
run the headless JSON-driven simulation in a separate interpreter so a
solver crash cannot take the GUI down, surface its console output
incrementally, and let the user abort a running case.

The design is this repo's own: ``SimulatorRunner.launch(json_path)`` spawns
one :class:`SimulationHandle` per run (a previous run, if any, is aborted
first).  The handle owns the child process and its output pump; the runner
only remembers the most recent handle so ``abort()``/``wait()`` act on it.

The child is ``python -u -m safeincave_torch.app.sim_cli --json CASE
--device DEVICE``, on the card by default.  A child asked for the card on a
machine without one fails with the port's own error, and its exit code is
what ``wait`` returns: nothing runs the case again on the CPU.
"""
from __future__ import annotations

import os
import subprocess
import sys
import threading
from typing import Callable, Optional


def _cli_command(json_path: str, device: str = "cuda") -> list[str]:
    return [sys.executable, "-u", "-m", "safeincave_torch.app.sim_cli",
            "--json", json_path, "--device", device]


def _child_env() -> dict:
    """Child environment with the package's parent dir on PYTHONPATH, so an
    uninstalled checkout can still ``-m`` itself from any cwd."""
    here = os.path.abspath(__file__)
    pkg_parent = os.path.dirname(os.path.dirname(os.path.dirname(here)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (pkg_parent, env.get("PYTHONPATH")) if p)
    return env


class SimulationHandle:
    """One running (or finished) simulation subprocess."""

    def __init__(self, json_path: str,
                 on_line: Optional[Callable[[str], None]] = None,
                 device: str = "cuda"):
        self.json_path = json_path
        self.on_line = on_line
        self._proc = subprocess.Popen(
            _cli_command(json_path, device),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, bufsize=1, close_fds=True, env=_child_env())
        self._pump = threading.Thread(target=self._drain, daemon=True)
        self._pump.start()

    def _drain(self):
        stream = self._proc.stdout
        try:
            for line in iter(stream.readline, ""):
                if self.on_line is not None:
                    self.on_line(line)
        finally:
            stream.close()

    @property
    def running(self) -> bool:
        return self._proc.poll() is None

    @property
    def returncode(self) -> Optional[int]:
        return self._proc.poll()

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        rc = self._proc.wait(timeout=timeout)
        self._pump.join(timeout=5)
        return rc

    def abort(self, grace_s: float = 5.0) -> None:
        """SIGTERM, escalate to SIGKILL after ``grace_s``."""
        if not self.running:
            return
        self._proc.terminate()
        try:
            self._proc.wait(timeout=grace_s)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()
        if self.on_line is not None:
            self.on_line("\nSimulation terminated by user.\n")


class SimulatorRunner:
    """GUI-facing front: at most one live simulation at a time."""

    def __init__(self, output_callback: Optional[Callable[[str], None]] = None,
                 device: str = "cuda"):
        """``device``: "cuda" (the card) or "cpu", passed to the child's
        ``--device``."""
        self.output_callback = output_callback
        self.device = device
        self.handle: Optional[SimulationHandle] = None

    def launch(self, json_path: str) -> SimulationHandle:
        """Abort any live run, then start ``json_path``."""
        self.stop()
        self.handle = SimulationHandle(json_path, on_line=self.output_callback,
                                       device=self.device)
        return self.handle

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        return self.handle.wait(timeout=timeout) if self.handle else None

    def stop(self) -> None:
        if self.handle is not None:
            self.handle.abort()
            self.handle = None
