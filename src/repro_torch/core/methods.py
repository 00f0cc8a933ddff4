"""Named PS method registry — the paper's five baselines + REWAFL.

| method      | selector (utility)            | local computing policy     |
|-------------|-------------------------------|----------------------------|
| random      | uniform random [33]           | fixed H                    |
| oort        | Eqn (1) + temporal unc. [12]  | fixed H                    |
| autofl      | energy-aware bandit [20]      | fixed H                    |
| reafl       | Eqn (2)                       | fixed H                    |
| reafl_lupa  | Eqn (2)                       | AdaH [23]                  |
| rewafl      | Eqn (2)                       | Eqn (3) + stopping Eqn (4) |

The port's round body (`core.round.make_round_body`) runs all six.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MethodSpec:
    name: str
    selector: str   # random | oort | autofl | rea
    policy: str     # fixed | adah | rewa
    exploration: float = 0.0   # ε-greedy fraction (oort/autofl)


METHODS = {
    "random": MethodSpec("random", "random", "fixed"),
    "oort": MethodSpec("oort", "oort", "fixed", exploration=0.1),
    "autofl": MethodSpec("autofl", "autofl", "fixed", exploration=0.1),
    "reafl": MethodSpec("reafl", "rea", "fixed"),
    "reafl_lupa": MethodSpec("reafl_lupa", "rea", "adah"),
    "rewafl": MethodSpec("rewafl", "rea", "rewa"),
}
