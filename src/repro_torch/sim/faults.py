"""Deterministic fault injection for the FL round (the chaos layer).

The port of `repro.sim.faults`: per-round rates of mid-round compute
aborts (the update is lost, the compute energy that ran is spent), upload
loss on a bad Gilbert–Elliott channel, corrupted updates (NaN, or a norm
blow-up by `corrupt_scale`) and latency spikes. `FaultCfg` is attached to
a fleet-dynamics scenario; when `enabled` is false the round injects
nothing and draws nothing for it. A round's randomness is one (6, S)
uniform draw, `RoundNoise.fault_u` (the reference folds it from the round
key with `FAULT_SALT`), split by `fault_draws`. The resilience screen
that rejects corrupted updates is `core.resilience`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

_RATE_FIELDS = ("abort_rate", "loss_rate", "corrupt_rate",
                "straggler_rate", "corrupt_nan_frac")


@dataclasses.dataclass(frozen=True)
class FaultCfg:
    """Static fault-injection knobs (per scenario; all rates per round).

    abort_rate       — P(mid-round compute abort | participating).
    loss_rate        — P(upload lost | participating ∧ channel bad).
    corrupt_rate     — P(update corrupted | delivered).
    straggler_rate   — P(latency spike | participating).
    straggler_mult   — round-time multiplier for stragglers (≥ 1).
    corrupt_scale    — delta blow-up factor for norm-corruption.
    corrupt_nan_frac — fraction of corruptions that are NaN instead of
                       a norm blow-up (drawn per event).
    """
    abort_rate: float = 0.0
    loss_rate: float = 0.0
    corrupt_rate: float = 0.0
    straggler_rate: float = 0.0
    straggler_mult: float = 8.0
    corrupt_scale: float = 1e8
    corrupt_nan_frac: float = 0.5

    def __post_init__(self):
        for f in _RATE_FIELDS:
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f} must be in [0, 1], got {v}")
        if self.straggler_mult < 1.0:
            raise ValueError("straggler_mult must be >= 1, "
                             f"got {self.straggler_mult}")
        if self.corrupt_scale <= 0.0:
            raise ValueError("corrupt_scale must be > 0, "
                             f"got {self.corrupt_scale}")

    @property
    def enabled(self) -> bool:
        """False when every rate is 0: the round injects nothing."""
        return (self.abort_rate > 0.0 or self.loss_rate > 0.0
                or self.corrupt_rate > 0.0 or self.straggler_rate > 0.0)


class FaultParams(NamedTuple):
    """Traced fault rates (0-d f32 tensors), carried inside
    `core.methods.MethodParams` so each cell of a campaign grid reads its
    own. `corrupt_scale` and `corrupt_nan_frac` stay constants read from
    the scenario's FaultCfg (they shape the corruption, not the
    method)."""
    abort_rate: torch.Tensor
    loss_rate: torch.Tensor
    corrupt_rate: torch.Tensor
    straggler_rate: torch.Tensor
    straggler_mult: torch.Tensor


def fault_params(cfg: Optional[FaultCfg], device="cpu") -> FaultParams:
    """Lower a FaultCfg (None: no faults) to FaultParams on `device`."""
    c = cfg if cfg is not None else FaultCfg()

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    return FaultParams(abort_rate=f32(c.abort_rate), loss_rate=f32(c.loss_rate),
                       corrupt_rate=f32(c.corrupt_rate),
                       straggler_rate=f32(c.straggler_rate),
                       straggler_mult=f32(c.straggler_mult))


class FaultDraws(NamedTuple):
    """One round's per-device U(0,1) fields. `h_frac` is the abort's
    progress fraction (how much of the local compute ran before the
    crash); `u_cmode` picks NaN against blow-up per corruption."""
    u_straggler: torch.Tensor  # (S,)
    u_abort: torch.Tensor      # (S,)
    h_frac: torch.Tensor       # (S,)
    u_loss: torch.Tensor       # (S,)
    u_corrupt: torch.Tensor    # (S,)
    u_cmode: torch.Tensor      # (S,)


def fault_draws(u: torch.Tensor) -> FaultDraws:
    """The six fields of a round's (6, S) fault uniforms, in the
    reference's row order."""
    return FaultDraws(*u.unbind(0))


def corrupt_cohort(client: torch.Tensor, global_flat: torch.Tensor,
                   corrupt_k: torch.Tensor, u_cmode_k: torch.Tensor, *,
                   scale: float, nan_frac: float) -> torch.Tensor:
    """The (K, P) cohort with the marked slots' updates corrupted: a
    corrupted slot's delta θ_k − θ becomes NaN (u_cmode < nan_frac) or is
    scaled by `scale` (a norm blow-up, typically overflowing to ±inf in
    f32). corrupt_k: (K,) bool; u_cmode_k: (K,) uniforms."""
    factor = torch.where(u_cmode_k < nan_frac, torch.nan, scale).to(client.dtype)
    return torch.where(corrupt_k[:, None],
                       global_flat + (client - global_flat) * factor[:, None],
                       client)
