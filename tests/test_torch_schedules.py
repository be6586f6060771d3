"""PyTorch port vs JAX package: pressure-schedule builders.

Each builder of ``schedules`` returns arrays equal to the JAX package's on
the same inputs (host numpy in both, so bitwise).  The CSV profile is made
from a seed with numpy.
"""
import numpy as np
import pytest

import safeincave_tpu as sc
import safeincave_tpu.schedules as jsched
import safeincave_torch.schedules as tsched
import safeincave_torch as st

HOUR = 3600.0


def _tc(pkg, days=4.0, dt_hours=1.0):
    return pkg.TimeController(dt=dt_hours, initial_time=0.0,
                              final_time=days * 24.0, time_unit="hour")


@pytest.fixture(scope="module")
def csv_bar(tmp_path_factory):
    """An hourly profile in bar with decimal commas and ';' delimiters."""
    rng = np.random.default_rng(0)
    p = 80.0 + 20.0 * rng.random(30)
    path = tmp_path_factory.mktemp("csv") / "ops.csv"
    with open(path, "w") as f:
        f.write("uur;druk_bar;debiet\n")
        for i, v in enumerate(p):
            f.write(f"{i};{v:.3f}".replace(".", ",") + f";{i * 2}\n")
    return str(path)


CASES = {
    "sinus": lambda m, pkg, csv: m.build_sinus_pressure_schedule(
        _tc(pkg), p_mean=10e6, p_ampl=3e6, period_hours=24.0,
        phase_hours=2.0, clamp_min=8e6, clamp_max=12.5e6),
    "sinus_flat": lambda m, pkg, csv: m.build_sinus_pressure_schedule(
        _tc(pkg, 1.0), p_mean=9e6, p_ampl=1e6, period_hours=0.0),
    "leaching_linear": lambda m, pkg, csv: m.build_leaching_pressure_schedule(
        _tc(pkg, 2.0, 3.0), p_start_pa=14e6, p_end_pa=7e6, mode="linear"),
    "leaching_stepped": lambda m, pkg, csv:
        m.build_leaching_pressure_schedule(
            _tc(pkg, 2.0, 3.0), p_start_pa=14e6, p_end_pa=7e6,
            mode="stepped", n_steps=5),
    "debrining": lambda m, pkg, csv: m.prepend_debrining(
        [0.0, HOUR, 2 * HOUR], [7e6, 8e6, 9e6], p_leach_end_pa=6.5e6,
        debrining_days=3.0),
    "power_generation": lambda m, pkg, csv:
        m.build_power_generation_schedule(
            _tc(pkg, 10.0), p_base_pa=12e6, n_events=4, operation_days=10,
            recovery_tau_hours=30.0, p_min_pa=7e6, seed=7),
    "csv_direct": lambda m, pkg, csv: m.build_csv_pressure_schedule(
        _tc(pkg, 3.0), csv, days=3, mode="direct"),
    "csv_stretch": lambda m, pkg, csv: m.build_csv_pressure_schedule(
        _tc(pkg, 3.0), csv, days=3, mode="stretch", total_cycles=2,
        rescale=True, rescale_min=6.0, rescale_max=12.0),
    "csv_repeat_raw": lambda m, pkg, csv: m.build_csv_pressure_schedule(
        _tc(pkg, 3.0), csv, days=3, mode="repeat", resample_at_dt=False),
    "read_csv": lambda m, pkg, csv: m.read_pressure_csv(csv),
    "rescale": lambda m, pkg, csv: m.rescale_pressure_profile(
        np.linspace(3.0, 9.0, 13), 6.0, 12.0),
}


@pytest.mark.parametrize("name", list(CASES))
def test_builder_matches_jax(name, csv_bar):
    got = CASES[name](tsched, st, csv_bar)
    want = CASES[name](jsched, sc, csv_bar)
    for g, w in zip(got if isinstance(got, tuple) else [got],
                    want if isinstance(want, tuple) else [want]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("ramp_hours", [None, 5.0], ids=["none", "5h"])
def test_startup_ramp_matches_jax(ramp_hours):
    """The ramp rewrites the pressure list in place."""
    t = [k * HOUR for k in range(12)]
    got = list(np.linspace(10e6, 12e6, 12))
    want = list(got)
    tsched.apply_startup_ramp(t, got, p_start_pa=6e6, ramp_hours=ramp_hours,
                              dt_hours=1.0)
    jsched.apply_startup_ramp(t, want, p_start_pa=6e6, ramp_hours=ramp_hours,
                              dt_hours=1.0)
    assert got == want
    assert got[0] == 6e6


def test_bad_modes_raise_as_jax(csv_bar):
    for m, pkg in ((tsched, st), (jsched, sc)):
        with pytest.raises(ValueError):
            m.build_leaching_pressure_schedule(_tc(pkg), p_start_pa=1.0,
                                               p_end_pa=0.0, mode="cubic")
        with pytest.raises(ValueError):
            m.build_csv_pressure_schedule(_tc(pkg), csv_bar, days=1,
                                          mode="shuffle")
