"""Fault-injection settings that a fleet-dynamics scenario carries.

The port of `repro.sim.faults.FaultCfg`: per-round rates of mid-round
compute aborts, upload loss on a bad channel, corrupted updates and
latency spikes. A scenario whose `faults.enabled` is true needs fault
injection and the resilience screen in the round (ROADMAP A11), which
the port does not have yet: `core.round.make_round_body` raises for it.
"""
from __future__ import annotations

import dataclasses

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
