"""Named PS method registry — the paper's five baselines + REWAFL.

| method      | selector (utility)            | local computing policy     |
|-------------|-------------------------------|----------------------------|
| random      | uniform random [33]           | fixed H                    |
| oort        | Eqn (1) + temporal unc. [12]  | fixed H                    |
| autofl      | energy-aware bandit [20]      | fixed H                    |
| reafl       | Eqn (2)                       | fixed H                    |
| reafl_lupa  | Eqn (2)                       | AdaH [23]                  |
| rewafl      | Eqn (2)                       | Eqn (3) + stopping Eqn (4) |

Two views of a method:

  MethodSpec   — the static (Python) description: selector and policy
                 names dispatched with Python `if` when the round runs
                 (`core.round.make_round_body` and its async variant).
  MethodParams — the traced description: branch ids and hyperparameters
                 as 0-d tensors. Stacked over cells (`method_params_batch`)
                 they give the leading axis that `launch.engine.
                 run_campaign_grid` vmaps, so one call runs a whole
                 (method × seed) grid; the round (`make_round_body_mp`)
                 computes every selector's scores and every policy's H
                 and picks each cell's with `torch.where`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.common import tree_stack
from repro_torch.sim.faults import FaultCfg, FaultParams, fault_params


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

# branch orders of the traced dispatch (the reference's `lax.switch`
# orders); `core.round` selects among the branches in these orders
SELECTOR_IDS = {"random": 0, "oort": 1, "autofl": 2, "rea": 3}
POLICY_IDS = {"fixed": 0, "adah": 1, "rewa": 2}


def selector_branches(builders: dict) -> tuple:
    """The selector score builders in SELECTOR_IDS order, from a
    name → builder mapping; a missing or extra name raises instead of
    routing a branch id to the wrong selector's scores."""
    if set(builders) != set(SELECTOR_IDS):
        raise ValueError(
            f"selector branch names {sorted(builders)} != registry "
            f"{sorted(SELECTOR_IDS)}")
    return tuple(builders[name]
                 for name in sorted(SELECTOR_IDS, key=SELECTOR_IDS.get))


class MethodParams(NamedTuple):
    """Traced per-method parameters: 0-d tensors, stacked to (C,) leaves
    by `method_params_batch` for the cell-axis vmap.

    `exploration` is the effective ε of the one ε-greedy selection the
    traced round runs for every selector: pure ranking (rea) is ε = 0,
    uniform random ε = 1 (every slot explored by the uniform draw
    `random_select` ranks by)."""
    selector_id: torch.Tensor   # i32 — index in SELECTOR_IDS order
    policy_id: torch.Tensor     # i32 — index in POLICY_IDS order
    exploration: torch.Tensor   # f32 — effective ε (random 1, rea 0)
    alpha: torch.Tensor         # f32 — latency-utility exponent
    beta: torch.Tensor          # f32 — energy-utility exponent
    autofl_eta: torch.Tensor    # f32 — AutoFL reward scale
    autofl_ema: torch.Tensor    # f32 — AutoFL bandit EMA factor
    buffer_m: torch.Tensor      # i32 — async trigger M; 0 is the sync
                                # sentinel (the full K-cohort lands each
                                # round). Read by the async round only.
    faults: FaultParams         # traced fault rates, read only when the
                                # scenario injects faults


def method_params(spec: MethodSpec, *, alpha: float = 1.0, beta: float = 1.0,
                  autofl_eta: float = 1.0, autofl_ema: float = 0.5,
                  fault_cfg: Optional[FaultCfg] = None,
                  device="cpu") -> MethodParams:
    """Lower a static MethodSpec (with the FLConfig's utility and bandit
    hyperparameters and the scenario's FaultCfg) to MethodParams on
    `device`."""
    if spec.selector not in SELECTOR_IDS:
        raise ValueError(f"selector {spec.selector!r} has no traced branch")
    if spec.policy not in POLICY_IDS:
        raise ValueError(f"policy {spec.policy!r} has no traced branch")
    eps_eff = {"random": 1.0, "rea": 0.0}.get(spec.selector, spec.exploration)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    return MethodParams(
        selector_id=i32(SELECTOR_IDS[spec.selector]),
        policy_id=i32(POLICY_IDS[spec.policy]),
        exploration=f32(eps_eff), alpha=f32(alpha), beta=f32(beta),
        autofl_eta=f32(autofl_eta), autofl_ema=f32(autofl_ema),
        buffer_m=i32(spec.buffer_m if spec.aggregation == "async" else 0),
        faults=fault_params(fault_cfg, device=device))


def method_params_batch(specs: Sequence[MethodSpec], **kw) -> MethodParams:
    """Stack specs into (M,)-leaf MethodParams for the cell-axis vmap."""
    return tree_stack([method_params(s, **kw) for s in specs])


def batchable(specs: Sequence[MethodSpec]) -> bool:
    """True when every spec lowers to MethodParams (its selector and
    policy have traced branches); a grid of such specs runs as one
    batched program, any other falls back to one batch a method."""
    return all(s.selector in SELECTOR_IDS and s.policy in POLICY_IDS
               for s in specs)
