"""Named fleet-dynamics scenarios.

A `Scenario` is a frozen bundle of transition rates for the three
dynamics processes (wireless channel, charging, availability) plus the
sim clock. `static-paper` is the static fleet: the round skips every
dynamics branch, so it draws and computes exactly what it did before
the scenarios existed. The port's own copy of
`repro.sim.dynamics.scenarios`, with the same seven registered
scenarios and rates.

Adding a scenario: construct a `Scenario` with a new name and `register`
it; `run_fl(scenario=...)` and the CLI's `--scenario` then take it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.sim.faults import FaultCfg


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    # static=True skips every dynamics branch: the seed simulator's
    # semantics, permanent dropout included
    static: bool = False
    minutes_per_round: float = 2.0   # sim-clock advance per FL round
    phase_spread_h: float = 6.0      # per-device diurnal phase offset range

    # --- wireless: Gilbert–Elliott channel (per-round transition probs)
    p_good_to_bad: float = 0.05
    p_bad_to_good: float = 0.10
    # initial good fraction; None inherits the fleet's build-time
    # high/low-rate assignment
    frac_good0: Optional[float] = None

    # --- battery: diurnal charging sessions + background non-FL drain
    charge_c_per_hour: float = 0.5   # capacity fraction gained per hour
    idle_drain_w: float = 0.2        # W, always-on background drain
    plug_on_day: float = 0.02        # per-round plug-in prob (noon)
    plug_on_night: float = 0.25      # per-round plug-in prob (midnight)
    plug_off_day: float = 0.25
    plug_off_night: float = 0.02
    frac_charging0: float = 0.1
    recover_rounds: float = 2.0      # min-round budgets needed to rejoin

    # --- availability churn: diurnal online/offline process
    p_online_day: float = 0.20       # offline->online per-round prob
    p_online_night: float = 0.30
    p_offline_day: float = 0.05      # online->offline per-round prob
    p_offline_night: float = 0.02
    frac_online0: float = 0.9

    # --- weekday/weekend structure (sim clock starts 00:00 Monday):
    # multipliers of the Markov transition probs on weekend days
    # (clipped to [0, 1]); all 1.0 is the pure diurnal chain
    weekend_plug_on_mult: float = 1.0    # scales plug-in prob
    weekend_plug_off_mult: float = 1.0   # scales unplug prob
    weekend_online_on_mult: float = 1.0  # scales offline->online prob
    weekend_online_off_mult: float = 1.0 # scales online->offline prob

    # --- fault injection (sim.faults); all-zero rates inject nothing
    faults: FaultCfg = dataclasses.field(default_factory=FaultCfg)

    @property
    def dynamic(self) -> bool:
        return not self.static

    @property
    def has_weekend(self) -> bool:
        """True when any weekend multiplier deviates from 1: the dynamics
        step then computes the day of the week."""
        return any(m != 1.0 for m in (
            self.weekend_plug_on_mult, self.weekend_plug_off_mult,
            self.weekend_online_on_mult, self.weekend_online_off_mult))


STATIC_PAPER = Scenario(name="static-paper", static=True)

SCENARIOS: Dict[str, Scenario] = {}


def register(sc: Scenario) -> Scenario:
    SCENARIOS[sc.name] = sc
    return sc


register(STATIC_PAPER)

# Defaults above = commuter-diurnal: moderate channel migration, evening
# plug-ins, mild daytime churn. Weekends drop the commute: phones sit on
# home chargers more and their owners are reachable more of the day.
register(Scenario(name="commuter-diurnal",
                  weekend_plug_on_mult=1.6, weekend_plug_off_mult=0.5,
                  weekend_online_on_mult=1.3, weekend_online_off_mult=0.6))

# Dense-city interference: the channel flips fast and is biased bad,
# charging is scarce and drain is high.
register(Scenario(
    name="congested-urban",
    p_good_to_bad=0.25, p_bad_to_good=0.10,
    plug_on_day=0.01, plug_on_night=0.08,
    plug_off_day=0.40, plug_off_night=0.15,
    idle_drain_w=0.5, charge_c_per_hour=0.3, frac_charging0=0.05,
    p_offline_day=0.10, p_offline_night=0.06,
    p_online_day=0.15, p_online_night=0.20, frac_online0=0.8))

# Overnight regime: almost everyone charges at night and is online-idle,
# so depleted devices come back each morning (recoverable dropout).
register(Scenario(
    name="overnight-charging",
    p_good_to_bad=0.02, p_bad_to_good=0.08,
    plug_on_day=0.02, plug_on_night=0.60,
    plug_off_day=0.50, plug_off_night=0.02,
    charge_c_per_hour=0.8, idle_drain_w=0.15, frac_charging0=0.2,
    p_offline_day=0.03, p_offline_night=0.01,
    p_online_day=0.30, p_online_night=0.50, frac_online0=0.95,
    weekend_plug_on_mult=1.3, weekend_plug_off_mult=0.7))

# Aggressive availability churn with little diurnal structure: the
# candidate set is reshuffled under the selector every few rounds.
register(Scenario(
    name="churn-heavy",
    phase_spread_h=24.0,
    p_good_to_bad=0.10, p_bad_to_good=0.15,
    plug_on_day=0.10, plug_on_night=0.15,
    plug_off_day=0.15, plug_off_night=0.10,
    p_offline_day=0.30, p_offline_night=0.25,
    p_online_day=0.35, p_online_night=0.35, frac_online0=0.6))

# Fault scenarios: a lossy, straggling link, and a flaky device fleet.
# The round injects their faults (`sim.faults`) and screens the updates
# (`core.resilience`).
register(Scenario(
    name="lossy-uplink",
    p_good_to_bad=0.30, p_bad_to_good=0.15,
    faults=FaultCfg(loss_rate=0.6, straggler_rate=0.10,
                    straggler_mult=6.0)))

register(Scenario(
    name="flaky-fleet",
    p_good_to_bad=0.10, p_bad_to_good=0.15,
    faults=FaultCfg(abort_rate=0.15, loss_rate=0.20, corrupt_rate=0.10,
                    straggler_rate=0.20, straggler_mult=8.0)))


def get_scenario(name: Optional[str]) -> Scenario:
    """Resolve a scenario by name; None means static-paper."""
    if name is None:
        return STATIC_PAPER
    try:
        return SCENARIOS[name]
    except KeyError:
        raise ValueError(f"unknown scenario {name!r} — "
                         f"choose from {sorted(SCENARIOS)}") from None
