"""EnvState: the fleet's environment, evolved between rounds.

Carried through `core.round.make_round_body` and `launch.engine` beside
`FleetState`. Static scenarios carry a constant EnvState (all-good
channel, nobody charging, everyone online) and never call `step_env`.
The port of `repro.sim.dynamics.env`, with the random numbers as
arguments: `init_env_state` takes (4, S) uniforms (the reference's
channel, plug, online and phase draws, in its split order) and
`step_env` (3, S) (channel, plug, online).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.state import FleetState
from repro_torch.sim.devices import DeviceFleet
from repro_torch.sim.dynamics.availability import online_step
from repro_torch.sim.dynamics.battery import (charge_and_drain, plug_step,
                                              recovery_step)
from repro_torch.sim.dynamics.channel import channel_step, effective_rate_mean
from repro_torch.sim.dynamics.diurnal import day_of_week, is_weekend, time_of_day
from repro_torch.sim.dynamics.scenarios import Scenario
from repro_torch.sim.energy import min_round_cost


class EnvState(NamedTuple):
    channel_good: torch.Tensor  # bool (S,) — Gilbert–Elliott env state
    charging: torch.Tensor      # bool (S,) — plugged in this round
    online: torch.Tensor        # bool (S,) — reachable / willing this round
    phase_h: torch.Tensor       # f32 (S,) — per-device diurnal phase (hours)


def init_env_state(fleet: DeviceFleet, scenario: Optional[Scenario] = None,
                   u: Optional[torch.Tensor] = None) -> EnvState:
    """Fresh environment on the fleet's device. Static scenarios need no
    draws; dynamic ones take `u`, (4, S) uniforms in [0, 1): the initial
    channel (read only when `frac_good0` is set; else the fleet's
    build-time high/low assignment), plug, online and phase draws."""
    if scenario is None or scenario.static:
        ones = torch.ones_like(fleet.rate_mean, dtype=torch.bool)
        return EnvState(channel_good=ones, charging=~ones, online=ones,
                        phase_h=torch.zeros_like(fleet.rate_mean))
    if u is None:
        raise ValueError(f"scenario {scenario.name!r} is dynamic: "
                         "init_env_state needs its (4, S) uniform draws")
    good = (fleet.rate_mean >= fleet.rate_high if scenario.frac_good0 is None
            else u[0] < scenario.frac_good0)
    return EnvState(channel_good=good,
                    charging=u[1] < scenario.frac_charging0,
                    online=u[2] < scenario.frac_online0,
                    phase_h=u[3] * scenario.phase_spread_h)


def step_env(scenario: Scenario, fleet: DeviceFleet, env: EnvState,
             state: FleetState, round_idx: int, u: torch.Tensor,
             model_bits: float):
    """One inter-round dynamics transition (dynamic scenarios only), from
    `u`, (3, S) uniforms: channel, plug and online draws.

    Returns (env', state'): Markov-steps channel/plug/online, integrates
    charging + background drain into `state.residual_energy`, and clears
    `state.dropped` for recovered devices, pricing the minimal round at
    the *new* channel state's mean rate."""
    tod = time_of_day(round_idx, scenario.minutes_per_round, env.phase_h)
    weekend = (is_weekend(day_of_week(round_idx, scenario.minutes_per_round,
                                      env.phase_h))
               if scenario.has_weekend else None)
    good = channel_step(u[0], env.channel_good,
                        scenario.p_good_to_bad, scenario.p_bad_to_good)
    charging = plug_step(u[1], env.charging, tod, scenario, weekend)
    online = online_step(u[2], env.online, tod, scenario, weekend)
    energy = charge_and_drain(state.residual_energy, charging, fleet, scenario)
    min_cost = min_round_cost(fleet, model_bits, effective_rate_mean(good, fleet))
    dropped = recovery_step(state.dropped, charging, energy, fleet,
                            min_cost, scenario)
    new_env = EnvState(channel_good=good, charging=charging, online=online,
                       phase_h=env.phase_h)
    return new_env, state._replace(residual_energy=energy, dropped=dropped)
