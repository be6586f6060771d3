"""Cavern pressure-schedule builders (port of ``safeincave_tpu/schedules.py``,
host numpy, the same outputs).

Every builder returns ``(t_vals, p_vals)`` in seconds / Pa, directly
consumable by ``MomentumBC.NeumannBC(values=p_vals, time_values=t_vals)``
(the BC handler interpolates them linearly in time).
"""
from __future__ import annotations

import csv
import math
import os

import numpy as np

from . import utils as ut


def _sample_at_dt(tc):
    """Time grid aligned with the controller's steps."""
    n_steps = int(math.floor(tc.t_final / tc.dt))
    t_vals = [k * tc.dt for k in range(n_steps + 1)]
    if abs(t_vals[-1] - tc.t_final) > 1e-12:
        t_vals.append(tc.t_final)
    return t_vals


def build_sinus_pressure_schedule(tc, *, p_mean, p_ampl, period_hours,
                                  phase_hours=0.0, clamp_min=None,
                                  clamp_max=None):
    """Sinusoidal schedule sampled at simulation steps."""
    period = period_hours * ut.hour
    phase = phase_hours * ut.hour
    t_vals = _sample_at_dt(tc)
    w = (2.0 * math.pi / period) if period > 0.0 else 0.0
    p_vals = []
    for t in t_vals:
        p = p_mean if period <= 0.0 else \
            p_mean + p_ampl * math.sin(w * (t - phase))
        if clamp_min is not None:
            p = max(p, clamp_min)
        if clamp_max is not None:
            p = min(p, clamp_max)
        p_vals.append(p)
    return t_vals, p_vals


def build_leaching_pressure_schedule(tc, *, p_start_pa, p_end_pa, mode,
                                     n_steps=6):
    """Linear or stepped pressure decline for the leaching phase."""
    t_vals = _sample_at_dt(tc)
    if mode == "linear":
        p_vals = [p_start_pa + (t / tc.t_final if tc.t_final > 0 else 1.0)
                  * (p_end_pa - p_start_pa) for t in t_vals]
    elif mode == "stepped":
        step_duration = tc.t_final / n_steps
        p_steps = np.linspace(p_start_pa, p_end_pa, n_steps + 1)
        p_vals = [p_end_pa if t >= tc.t_final
                  else p_steps[min(int(t / step_duration), n_steps - 1)]
                  for t in t_vals]
    else:
        raise ValueError(f"Unknown leaching mode: {mode}")
    return t_vals, p_vals


def prepend_debrining(t_pressure, p_pressure, *, p_leach_end_pa,
                      debrining_days):
    """Constant-pressure debrining plateau before operation."""
    debrining_s = debrining_days * 24.0 * 3600.0
    if debrining_s <= 0.0:
        return list(t_pressure), list(p_pressure)
    t_shifted = [t + debrining_s for t in t_pressure[1:]]
    p_shifted = list(p_pressure[1:])
    return ([0.0, debrining_s] + t_shifted,
            [p_leach_end_pa, p_leach_end_pa] + p_shifted)


def apply_startup_ramp(t_pressure, p_pressure, *, p_start_pa, ramp_hours,
                       dt_hours):
    """Replace the first part of a schedule with a linear ramp, in
    place."""
    if ramp_hours is None or ramp_hours <= 0.0:
        p_pressure[0] = p_start_pa
        return
    ramp_steps = max(1, int(round(float(ramp_hours) / float(dt_hours))))
    ramp_steps = min(ramp_steps, len(p_pressure) - 1)
    p_target = p_pressure[ramp_steps]
    p_pressure[0] = p_start_pa
    for k in range(1, ramp_steps + 1):
        a = k / float(ramp_steps)
        p_pressure[k] = (1.0 - a) * p_start_pa + a * p_target


def build_power_generation_schedule(tc, *, p_base_pa, n_events,
                                    operation_days,
                                    recovery_tau_hours=48.0, p_min_pa=None,
                                    seed=42):
    """Irregular abrupt-withdrawal events with exponential recovery:
    30-min drop, 2-5 h sustained low, exp return."""
    t_vals_s = _sample_at_dt(tc)
    t_h = [t / ut.hour for t in t_vals_s]
    p_base_mpa = p_base_pa / ut.MPa
    p_mpa = np.full(len(t_h), p_base_mpa)

    rng = np.random.RandomState(seed)
    n_ev = max(1, int(n_events))
    centers_days = np.linspace(1.0, operation_days - 1.0, n_ev)
    centers_days = centers_days + rng.uniform(-0.8, 0.8, size=n_ev)
    tau = max(0.1, float(recovery_tau_hours))

    for day_c in centers_days:
        t_start_h = day_c * 24.0
        duration = rng.uniform(2.0, 5.0)
        depth = rng.uniform(3.5, 6.5)
        for i, t in enumerate(t_h):
            if t < t_start_h:
                continue
            dt_ev = t - t_start_h
            if dt_ev < 0.5:
                drop = depth * (dt_ev / 0.5)
            elif dt_ev < 0.5 + duration:
                drop = depth
            else:
                drop = depth * math.exp(-(dt_ev - 0.5 - duration) / tau)
                if drop < 0.05:
                    break
            p_mpa[i] = min(p_mpa[i], p_base_mpa - drop)

    if p_min_pa is not None:
        p_mpa = np.maximum(p_mpa, p_min_pa / ut.MPa)
    return t_vals_s, (p_mpa * ut.MPa).tolist()


def _parse_float_auto(s):
    """Parse '12,5' or '12.5' (decimal commas)."""
    try:
        return float(str(s).strip().replace(",", "."))
    except ValueError:
        return float("nan")


def read_pressure_csv(csv_file: str) -> np.ndarray:
    """Hourly pressure series (MPa) from an operational-data CSV: prefers
    a 'druk_mpa' column, accepts 'druk_bar'
    (converted), falls back to the most numeric column; tolerant of ; , tab
    delimiters and decimal commas."""
    if not os.path.isfile(csv_file):
        raise FileNotFoundError(f"CSV not found: {csv_file}")
    with open(csv_file, "r", newline="", encoding="utf-8") as f:
        sample = f.read(4096)
        try:
            dialect = csv.Sniffer().sniff(sample, delimiters=";,\t")
        except csv.Error:
            dialect = csv.excel
    with open(csv_file, "r", newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f, dialect))
    if not rows:
        raise ValueError("empty CSV")
    header = [h.strip().lower() for h in rows[0]]
    data = rows[1:]

    idx_mpa = idx_bar = None
    for i, h in enumerate(header):
        if h == "druk_mpa" or h.endswith("druk_mpa"):
            idx_mpa = i
        if h == "druk_bar" or h.endswith("druk_bar"):
            idx_bar = i

    if idx_mpa is not None:
        vals = [_parse_float_auto(r[idx_mpa]) for r in data if idx_mpa < len(r)]
    elif idx_bar is not None:
        vals = [_parse_float_auto(r[idx_bar]) / 10.0 for r in data
                if idx_bar < len(r)]
    else:
        ncols = len(header)
        best_i, best_count = None, -1
        for i in range(ncols):
            v = [_parse_float_auto(r[i]) for r in data if i < len(r)]
            count = int(np.sum(np.isfinite(v)))
            if count > best_count:
                best_count, best_i = count, i
        if best_i is None or best_count < 2:
            raise ValueError("Could not find a numeric pressure column in CSV")
        vals = [_parse_float_auto(r[best_i]) for r in data if best_i < len(r)]

    p = np.asarray(vals, dtype=float)
    p = p[np.isfinite(p)]
    if p.size < 2:
        raise ValueError("Parsed pressure series has <2 numeric values")
    return p


def rescale_pressure_profile(pressures_mpa, new_min, new_max):
    """Linear rescale to [new_min, new_max]."""
    old_min, old_max = pressures_mpa.min(), pressures_mpa.max()
    if old_max - old_min < 1e-9:
        return np.full_like(pressures_mpa, (new_min + new_max) / 2.0)
    frac = (pressures_mpa - old_min) / (old_max - old_min)
    return new_min + frac * (new_max - new_min)


def build_csv_pressure_schedule(tc, csv_file, *, days, mode, total_cycles=1,
                                rescale=False, rescale_min=None,
                                rescale_max=None, resample_at_dt=True):
    """Schedule from an hourly CSV profile.

    mode: 'direct' (hour-for-hour, wrapping), 'stretch' (fit total_cycles
    copies into the horizon), 'repeat' (tile at native speed).
    """
    p_mpa = read_pressure_csv(csv_file)
    if rescale:
        p_mpa = rescale_pressure_profile(p_mpa, rescale_min, rescale_max)
    csv_hours = int(p_mpa.size)
    total_hours = float(days) * 24.0

    if mode == "direct":
        sim_hours = np.arange(0.0, total_hours + 1e-12, 1.0)
        idx = (sim_hours % csv_hours).astype(int)
        times_hours = sim_hours
        pressures_mpa = p_mpa[idx]
    elif mode == "stretch":
        total_cycles = max(1, int(total_cycles))
        cycle_h = total_hours / float(total_cycles)
        scale = cycle_h / float(csv_hours)
        times, pres = [], []
        for k in range(total_cycles):
            off = k * cycle_h
            for i in range(csv_hours):
                if k > 0 and i == 0:
                    continue
                times.append(off + i * scale)
                pres.append(p_mpa[i])
        times_hours = np.asarray(times)
        pressures_mpa = np.asarray(pres)
    elif mode == "repeat":
        n_rep = int(np.ceil(total_hours / float(csv_hours)))
        times, pres = [], []
        for r in range(n_rep):
            off = r * csv_hours
            for i in range(csv_hours):
                if r > 0 and i == 0:
                    continue
                t = off + i
                if t > total_hours:
                    break
                times.append(float(t))
                pres.append(p_mpa[i])
        times_hours = np.asarray(times)
        pressures_mpa = np.asarray(pres)
    else:
        raise ValueError("mode must be 'direct', 'stretch', or 'repeat'")

    times_s = np.asarray(times_hours) * 3600.0
    pressures_mpa = np.asarray(pressures_mpa)
    if times_s[0] > 0.0:
        times_s = np.insert(times_s, 0, 0.0)
        pressures_mpa = np.insert(pressures_mpa, 0, pressures_mpa[0])
    if times_s[-1] < tc.t_final:
        times_s = np.append(times_s, tc.t_final)
        pressures_mpa = np.append(pressures_mpa, pressures_mpa[-1])

    if resample_at_dt:
        t_vals = _sample_at_dt(tc)
        p_vals_mpa = np.interp(t_vals, times_s, pressures_mpa)
    else:
        t_vals = times_s.tolist()
        p_vals_mpa = pressures_mpa
    return t_vals, [float(p) * ut.MPa for p in p_vals_mpa]
