"""PyTorch port vs JAX package: time controllers.

Every controller walks exactly the JAX controller's (t, dt, step_counter)
sequence, over tests/test_timecontrol.py's cases; the adaptive controller is
fed the same ``feedback`` sequence.  ``build_time_list_by_dp_limit`` returns
an equal grid, and bad inputs raise in both packages.
"""
import numpy as np
import pytest

import safeincave_tpu as sc
import safeincave_torch as st

HOUR = 3600.0


def _p_ramp(t):
    """0 -> 1 MPa over [40, 60] h, flat elsewhere."""
    return 1e6 * min(max((t / HOUR - 40.0) / 20.0, 0.0), 1.0)


CONTROLLERS = {
    "fixed_10h": lambda pkg: pkg.TimeController(
        dt=1.0, initial_time=0.0, final_time=10.0, time_unit="hour"),
    "fixed_0.1h_accumulation": lambda pkg: pkg.TimeController(
        dt=0.1, initial_time=0.0, final_time=1.0, time_unit="hour"),
    "fixed_days": lambda pkg: pkg.TimeController(
        dt=0.5, initial_time=0.0, final_time=2.0, time_unit="day"),
    "fixed_minutes_offset": lambda pkg: pkg.TimeController(
        dt=7.0, initial_time=3.0, final_time=60.0, time_unit="minute"),
    **{f"parabolic_{n}": (lambda n: lambda pkg: pkg.TimeControllerParabolic(
        n_time_steps=n, initial_time=0.0, final_time=5.0,
        time_unit="day"))(n) for n in (2, 3, 7, 20, 100)},
    "from_list": lambda pkg: pkg.TimeControllerFromList(
        [0.0, 10.0, 30.0, 100.0]),
    "from_list_hours": lambda pkg: pkg.TimeControllerFromList(
        [0.0, HOUR, 5 * HOUR], time_unit="hour"),
    "from_dp_limit_grid": lambda pkg: pkg.TimeControllerFromList(
        pkg.build_time_list_by_dp_limit(100 * HOUR, _p_ramp,
                                        dt_min=0.5 * HOUR,
                                        dt_max=8 * HOUR, dp_max=1e5)),
    "adaptive": lambda pkg: pkg.AdaptiveTimeController(
        dt=1.0, initial_time=0.0, final_time=100.0, time_unit="hour",
        dt_min=0.25, dt_max=8.0),
    "adaptive_defaults": lambda pkg: pkg.AdaptiveTimeController(
        dt=3.0, initial_time=0.0, final_time=10.0, time_unit="hour"),
}

# fixed-point iterations and dt-cuts fed back after each adaptive step:
# fast, slow, retried and middling steps in turn
FEEDBACK = [(2, 0), (20, 0), (3, 2), (7, 0), (1, 0), (1, 0), (12, 1)]


def _walk(tc, max_steps=10_000):
    seq = [(tc.t, tc.dt if hasattr(tc, "dt") else None, tc.step_counter)]
    k = 0
    while tc.keep_looping():
        tc.advance_time()
        if hasattr(tc, "feedback"):
            it, cuts = FEEDBACK[k % len(FEEDBACK)]
            tc.feedback(it, dt_cuts=cuts)
        seq.append((tc.t, tc.dt, tc.step_counter))
        k += 1
        assert k <= max_steps, "runaway time loop"
    return seq


@pytest.mark.parametrize("name", list(CONTROLLERS))
def test_controller_sequence_matches_jax(name):
    tc_port, tc_jax = CONTROLLERS[name](st), CONTROLLERS[name](sc)
    for attr in ("time_unit", "time_conversion", "t_initial", "t_final"):
        assert getattr(tc_port, attr) == getattr(tc_jax, attr), attr
    got, want = _walk(tc_port), _walk(tc_jax)
    assert len(got) > 1
    assert got == want


def test_dp_limit_grid_matches_jax():
    args = (100 * HOUR, _p_ramp)
    kw = dict(dt_min=0.5 * HOUR, dt_max=8 * HOUR, dp_max=1e5)
    got = st.build_time_list_by_dp_limit(*args, **kw)
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(sc.build_time_list_by_dp_limit(
                                      *args, **kw)))


@pytest.mark.parametrize("bad", [[0.0], [0.0, 2.0, 1.0]],
                         ids=["too_short", "not_increasing"])
def test_bad_grids_raise_as_jax(bad):
    for pkg in (st, sc):
        with pytest.raises(ValueError):
            pkg.TimeControllerFromList(bad)


def test_unknown_unit_raises():
    with pytest.raises(ValueError):
        st.TimeController(dt=1.0, initial_time=0.0, final_time=1.0,
                          time_unit="fortnight")
