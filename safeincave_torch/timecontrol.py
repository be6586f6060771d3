"""Time-stepping controllers (port of ``safeincave_tpu/timecontrol.py``).

Host-side Python: they drive the outer time loop of the simulators.  Every
controller walks the same (t, dt, step_counter) sequence as its JAX-package
counterpart.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Callable

import numpy as np

from .utils import minute, hour, day, year

_UNIT = {"second": 1, "minute": minute, "hour": hour, "day": day, "year": year}

Fn = Callable[[np.ndarray], np.ndarray]


class TimeControllerBase(ABC):
    """Converts user time units to seconds and tracks the loop state."""

    def __init__(self, initial_time: float, final_time: float,
                 time_unit: str = "second"):
        if time_unit not in _UNIT:
            raise ValueError(f"Time unit {time_unit} not supported.")
        self.time_unit = time_unit
        self.time_conversion = _UNIT[time_unit]
        self.t_final = final_time * self.time_conversion
        self.t_initial = initial_time * self.time_conversion
        self.t = initial_time * self.time_conversion
        self.step_counter = 0

    def keep_looping(self) -> bool:
        # a relative tolerance: rounding can leave t a few ulp below t_final,
        # which must not run one extra step
        tol = 1e-12 * max(1.0, abs(self.t_final))
        return self.t < self.t_final - tol

    @abstractmethod
    def advance_time(self) -> None:
        ...


class TimeController(TimeControllerBase):
    """Fixed-step controller."""

    def __init__(self, dt: float, initial_time: float, final_time: float,
                 time_unit: str = "second"):
        super().__init__(initial_time, final_time, time_unit)
        self.dt = dt * self.time_conversion

    def advance_time(self) -> None:
        self.step_counter += 1
        self.t += self.dt


class TimeControllerParabolic(TimeControllerBase):
    """t^2-spaced steps rescaled to [t0, tf]: small steps early."""

    def __init__(self, n_time_steps: int, initial_time: float,
                 final_time: float, time_unit: str = "second"):
        super().__init__(initial_time, final_time, time_unit)
        self.n_time_steps = n_time_steps
        self.time_list = self.calculate_varying_times(self.fun_parabolic)
        self.dt = self.time_list[1] - self.time_list[0]
        self.step_counter = 0

    @staticmethod
    def fun_parabolic(t_array: np.ndarray) -> np.ndarray:
        return t_array ** 2

    def calculate_varying_times(self, fun: Fn) -> np.ndarray:
        t_eq = np.linspace(self.t_initial, self.t_final, self.n_time_steps)
        y = fun(t_eq)
        f_min = np.min(t_eq)
        f_max = np.max(y)
        k = (t_eq.max() - t_eq.min()) / (f_max - f_min)
        return k * (y - f_min) + t_eq.min()

    def keep_looping(self) -> bool:
        # index-based guard: the schedule has exactly n_time_steps points
        return (self.step_counter < len(self.time_list) - 1
                and super().keep_looping())

    def advance_time(self) -> None:
        self.step_counter += 1
        self.t = self.time_list[self.step_counter]
        self.dt = (self.time_list[self.step_counter]
                   - self.time_list[self.step_counter - 1])


class TimeControllerFromList(TimeControllerBase):
    """Controller walking a prescribed strictly increasing time grid
    (seconds), typically one built by :func:`build_time_list_by_dp_limit`."""

    def __init__(self, time_list_seconds, time_unit: str = "second"):
        tl = np.asarray(time_list_seconds, dtype=float)
        if tl.ndim != 1 or tl.size < 2:
            raise ValueError("time_list_seconds needs at least 2 entries")
        if not np.all(np.diff(tl) > 0):
            raise ValueError("time_list_seconds must be strictly increasing")
        super().__init__(tl[0] / _UNIT[time_unit], tl[-1] / _UNIT[time_unit],
                         time_unit)
        self.time_list = tl
        self.dt = float(tl[1] - tl[0])

    def keep_looping(self) -> bool:
        return self.step_counter < self.time_list.size - 1

    def advance_time(self) -> None:
        self.step_counter += 1
        t_prev = self.t
        self.t = float(self.time_list[self.step_counter])
        self.dt = self.t - t_prev


def build_time_list_by_dp_limit(t_final: float, p_of_t, *, dt_min: float,
                                dt_max: float, dp_max: float):
    """Variable time grid with |p(t+dt) - p(t)| <= dp_max per step.

    dt starts at dt_max each step and halves (clamped to dt_min) until the
    load change over the step is within dp_max: small steps through load
    ramps, large steps through plateaus.  Seconds and Pa.
    """
    t = 0.0
    times = [0.0]
    p_prev = float(p_of_t(0.0))
    max_steps = int(np.ceil(t_final / dt_min)) + 50
    for _ in range(max_steps):
        if t >= t_final - 1e-12:
            break
        dt = dt_max
        while True:
            t_try = min(t + dt, t_final)
            p_try = float(p_of_t(t_try))
            if abs(p_try - p_prev) <= dp_max or dt <= dt_min + 1e-12:
                t = t_try
                p_prev = p_try
                times.append(t)
                break
            dt = max(dt * 0.5, dt_min)
    if abs(times[-1] - t_final) > 1e-9:
        times.append(t_final)
    return times


class AdaptiveTimeController(TimeControllerBase):
    """Convergence-adaptive stepping: grow dt on fast convergence, shrink
    on slow steps or dt-retries.

    Simulator_M feeds each converged step's fixed-point iteration count (or
    a fused chunk's mean) and its dt-cuts back through :meth:`feedback`; the
    next step or chunk runs at the adapted dt, clamped to [dt_min, dt_max].
    The last step lands exactly on ``t_final``.
    """

    def __init__(self, dt: float, initial_time: float, final_time: float,
                 time_unit: str = "second", dt_min: float | None = None,
                 dt_max: float | None = None, grow: float = 1.4,
                 shrink: float = 0.5, fast_iters: int = 4,
                 slow_iters: int = 12):
        super().__init__(initial_time, final_time, time_unit)
        conv = self.time_conversion
        self.dt = dt * conv
        self.dt_min = (dt_min * conv) if dt_min is not None else self.dt / 64
        self.dt_max = (dt_max * conv) if dt_max is not None else self.dt * 64
        self.grow = grow
        self.shrink = shrink
        self.fast_iters = fast_iters
        self.slow_iters = slow_iters

    def advance_time(self) -> None:
        self.step_counter += 1
        self.dt = min(self.dt, self.t_final - self.t)
        self.t += self.dt

    def feedback(self, fp_iters: float, dt_cuts: int = 0) -> None:
        """Report a completed step (or a fused chunk's mean) to adapt dt."""
        if dt_cuts > 0:
            self.dt = max(self.dt * self.shrink ** dt_cuts, self.dt_min)
        elif fp_iters <= self.fast_iters:
            self.dt = min(self.dt * self.grow, self.dt_max)
        elif fp_iters >= self.slow_iters:
            self.dt = max(self.dt * self.shrink, self.dt_min)
