"""Reference side of the regular1200_tm configuration: cavern600_desai's
preparation (the elastic response to the cyclic pressure at t = 0, the
initial rates, the loads), with no warm-up step since episodes start at
t = 0; the episode (reference/episode.py) starts the heat equation there,
as ``Simulator_TM`` starts a stage."""
from .cavern600_desai import prepare  # noqa: F401
