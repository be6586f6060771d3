"""Per-step metrics: solver iterations, errors, timings (port of
``safeincave_tpu/metrics.py``; the same record keys and JSONL rows)."""
from __future__ import annotations

import json
import os

from . import tracing
from .utils import is_main_process


class StepMetrics:
    """Accumulates one record per time step; optionally streams JSONL
    (rank 0 of a multi-card run writes the file)."""

    def __init__(self, jsonl_path: str | None = None):
        self.records: list[dict] = []
        self.jsonl_path = jsonl_path
        self._fh = None
        self._t_last = tracing.now()
        if jsonl_path and is_main_process():
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            self._fh = open(jsonl_path, "w")

    def record(self, step: int, t: float, dt: float, fp_iters: int,
               error: float, wall_s: float | None = None, **kw):
        """``wall_s=None`` measures since the previous record on the clock
        of :mod:`~safeincave_torch.tracing` (per-step flow); a fused chunk
        passes each step's own ``step`` span."""
        now = tracing.now()
        rec = {"step": step, "t": t, "dt": dt, "fp_iters": fp_iters,
               "error": error,
               "wall_s": 1e-9 * (now - self._t_last) if wall_s is None
               else wall_s,
               **kw}
        self._t_last = now
        self.records.append(rec)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def summary(self) -> dict:
        if not self.records:
            return {}
        n = len(self.records)
        return {
            "steps": n,
            "total_wall_s": sum(r["wall_s"] for r in self.records),
            "mean_wall_s": sum(r["wall_s"] for r in self.records) / n,
            "mean_fp_iters": sum(r["fp_iters"] for r in self.records) / n,
            "max_error": max(r["error"] for r in self.records),
        }
