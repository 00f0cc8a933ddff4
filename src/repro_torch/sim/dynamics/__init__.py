"""Fleet dynamics: the time-varying world under the FL round.

  env.py          — EnvState + init/step (draws as arguments)
  channel.py      — Gilbert–Elliott good/bad wireless environments
  battery.py      — diurnal charging sessions, drain, recoverable drop
  availability.py — online/offline churn with diurnal bias
  diurnal.py      — shared sim clock / day-night weighting
  scenarios.py    — named `Scenario` registry (static-paper, …)
"""
from repro_torch.sim.dynamics.channel import effective_rate_mean  # noqa: F401
from repro_torch.sim.dynamics.env import EnvState, init_env_state, step_env  # noqa: F401
from repro_torch.sim.dynamics.scenarios import (SCENARIOS, STATIC_PAPER,  # noqa: F401
                                                Scenario, get_scenario, register)
