"""Named PS method registry — the paper's five baselines + REWAFL.

| method      | selector (utility)            | local computing policy     |
|-------------|-------------------------------|----------------------------|
| random      | uniform random [33]           | fixed H                    |
| oort        | Eqn (1) + temporal unc. [12]  | fixed H                    |
| autofl      | energy-aware bandit [20]      | fixed H                    |
| reafl       | Eqn (2)                       | fixed H                    |
| reafl_lupa  | Eqn (2)                       | AdaH [23]                  |
| rewafl      | Eqn (2)                       | Eqn (3) + stopping Eqn (4) |

The port's round body (`core.round.make_round_body`) runs all six, and
`core.round.make_async_round_body` their async (FedBuff) variants.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MethodSpec:
    name: str
    selector: str   # random | oort | autofl | rea
    policy: str     # fixed | adah | rewa
    exploration: float = 0.0   # ε-greedy fraction (oort/autofl)
    # aggregation regime: "sync" (FedAvg barrier) or "async" (FedBuff-style
    # buffered aggregation, core.async_agg), whose specs set buffer_m (the
    # M-updates aggregation trigger)
    aggregation: str = "sync"
    buffer_m: Optional[int] = None

    def __post_init__(self):
        if self.aggregation not in ("sync", "async"):
            raise ValueError(f"aggregation must be 'sync' or 'async', "
                             f"got {self.aggregation!r}")
        if self.aggregation == "async" and (self.buffer_m is None
                                            or self.buffer_m < 1):
            raise ValueError("async MethodSpec needs buffer_m >= 1, "
                             f"got {self.buffer_m}")


def async_variant(spec: MethodSpec, buffer_m: int,
                  suffix: str = "_async") -> MethodSpec:
    """The async (FedBuff) counterpart of a sync method spec."""
    return dataclasses.replace(spec, name=spec.name + suffix,
                               aggregation="async", buffer_m=buffer_m)


METHODS = {
    "random": MethodSpec("random", "random", "fixed"),
    "oort": MethodSpec("oort", "oort", "fixed", exploration=0.1),
    "autofl": MethodSpec("autofl", "autofl", "fixed", exploration=0.1),
    "reafl": MethodSpec("reafl", "rea", "fixed"),
    "reafl_lupa": MethodSpec("reafl_lupa", "rea", "adah"),
    "rewafl": MethodSpec("rewafl", "rea", "rewa"),
}
