"""PS utility functions — Eqn (1) (Oort) and Eqn (2) (REWAFL), + AutoFL.

Eqn (2):
  Util(i,r) = |B_i^r|·sqrt(mean_k Loss(k)^2)                 (statistical)
            × (T^r / t(i,r))^{ I(T^r < t(i,r)) · α }          (latency)
            × ((E_i^r − E0) / e(i,r))^{ U(e < E−E0) · β }     (energy)

with U(x) = 1 if x true else ∞ — i.e. the energy term hard-zeroes a
device whose round energy would dip into its reserve. Every function
mirrors `repro.core.utility` op for op, so f32 results agree bitwise
wherever the elementary operations are correctly rounded.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.common import rdiv


def statistical_utility(data_size: torch.Tensor,
                        loss_sq_mean: torch.Tensor) -> torch.Tensor:
    """|B_i|·sqrt( (1/|B_i|)·Σ Loss(k)² ) with loss_sq_mean the mean of
    squared per-sample losses."""
    return data_size.float() * torch.sqrt(loss_sq_mean.clamp_min(0.0))


def _pow(base: torch.Tensor, exponent) -> torch.Tensor:
    """base**exponent, exactly `base` at exponent 1 (the reference's
    exponent-1 guard). `exponent` is a Python float or a 0-d tensor
    (`MethodParams.alpha` / `beta`), which the guard then picks by
    `torch.where`."""
    if isinstance(exponent, torch.Tensor):
        return torch.where(exponent == 1, base, base ** exponent)
    return base if exponent == 1 else base ** exponent


def latency_utility(t: torch.Tensor, T_round: float, alpha: float) -> torch.Tensor:
    """(T/t)^(I(T<t)·α): penalise only devices slower than the preferred
    round duration T (Oort's global system utility)."""
    ratio = rdiv(T_round, t.clamp_min(1e-9))
    return torch.where(t > T_round, _pow(ratio, alpha), 1.0)


def energy_utility(residual: torch.Tensor, e0: torch.Tensor, e: torch.Tensor,
                   beta: float) -> torch.Tensor:
    """((E−E0)/e)^β when e < E−E0, else exactly 0 (U(x)=∞ branch)."""
    avail = residual - e0
    ratio = avail / e.clamp_min(1e-9)
    return torch.where(e < avail, _pow(ratio.clamp_min(1e-9), beta), 0.0)


def oort_utility(stat: torch.Tensor, t: torch.Tensor, *, T_round: float,
                 alpha: float) -> torch.Tensor:
    """Eqn (1)."""
    return stat * latency_utility(t, T_round, alpha)


def rewafl_utility(stat: torch.Tensor, t: torch.Tensor, e: torch.Tensor,
                   residual: torch.Tensor, e0: torch.Tensor, *, T_round: float,
                   alpha: float, beta: float) -> torch.Tensor:
    """Eqn (2) — the REA PS utility (used by both REAFL and REWAFL)."""
    return (stat
            * latency_utility(t, T_round, alpha)
            * energy_utility(residual, e0, e, beta))


class UtilityInputs(NamedTuple):
    """The FleetState leaves Eqn (2) reads, bundled so the selection
    kernel (`kernels/rewafl_select`) computes the utility from raw leaves
    instead of consuming a materialised (S,) utility. All five (S,) f32."""
    stat: torch.Tensor       # statistical utility |B|·sqrt(mean loss²)
    t: torch.Tensor          # predicted round latency t(i,r)  [s]
    e: torch.Tensor          # predicted round energy  e(i,r)  [J]
    residual: torch.Tensor   # residual battery energy E_i^r   [J]
    e0: torch.Tensor         # reserve threshold E0            [J]


def rewafl_utility_from(ui: UtilityInputs, *, T_round: float,
                        alpha: float, beta: float) -> torch.Tensor:
    """Eqn (2) evaluated from bundled leaves."""
    return rewafl_utility(ui.stat, ui.t, ui.e, ui.residual, ui.e0,
                          T_round=T_round, alpha=alpha, beta=beta)


def autofl_reward(loss_drop: torch.Tensor, e: torch.Tensor, *,
                  eta: float = 1.0) -> torch.Tensor:
    """AutoFL-style per-round reward: learning gain per Joule."""
    return eta * loss_drop / e.clamp_min(1e-9)
