"""Shared diurnal + weekly clock for the fleet-dynamics processes.

Sim time advances `Scenario.minutes_per_round` per FL round; each device
carries a phase offset (commute schedule / timezone), so the fleet's
plug-in and availability waves are staggered. The campaign starts at
00:00 Monday (day 0); scenarios with weekend multipliers reshape the
Markov transition probabilities on days 5 and 6.

Every function mirrors `repro.sim.dynamics.diurnal` op for op in f32.
Divisions by a constant divide by a 0-d tensor on the operand's device:
PyTorch turns division by a Python scalar into a multiplication by its
reciprocal on the card, which is not the reference's correctly rounded
division. The uniform draw of a Markov step is an argument.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """`x / c` as one correctly rounded f32 division on x's device."""
    return x / x.new_full((), c)


def sim_hours(round_idx: int, minutes_per_round: float,
              device) -> torch.Tensor:
    """0-d f32 hours since the campaign start, f32(round)·(minutes/60),
    filled on `device` (no copy from host memory)."""
    r = torch.full((), float(round_idx), dtype=torch.float32, device=device)
    return r * (minutes_per_round / 60.0)


def time_of_day(round_idx: int, minutes_per_round: float,
                phase_h: torch.Tensor) -> torch.Tensor:
    """(S,) hours in [0, 24): global round clock + per-device phase. The
    sum is never negative, so the reference's `mod` is an exact fmod."""
    h = sim_hours(round_idx, minutes_per_round, phase_h.device)
    return torch.fmod(h + phase_h, 24.0)


def day_of_week(round_idx: int, minutes_per_round: float,
                phase_h: torch.Tensor) -> torch.Tensor:
    """(S,) day index in [0, 7): 0 = Monday, 5–6 the weekend; the phase
    shifts the day boundary as it shifts the time of day."""
    h = sim_hours(round_idx, minutes_per_round, phase_h.device)
    return torch.fmod(torch.floor(_div(h + phase_h, 24.0)), 7.0)


def is_weekend(dow: torch.Tensor) -> torch.Tensor:
    """(S,) bool weekend indicator for a `day_of_week` signal."""
    return dow >= 5.0


def night_weight(tod_h: torch.Tensor) -> torch.Tensor:
    """Smooth night indicator in [0, 1]: 1 at midnight, 0 at noon."""
    return 0.5 * (1.0 + torch.cos(_div((2.0 * math.pi) * tod_h, 24.0)))


def diurnal(day_val: float, night_val: float,
            tod_h: torch.Tensor) -> torch.Tensor:
    """Interpolate a per-round probability between its day/night values."""
    w = night_weight(tod_h)
    return day_val + (night_val - day_val) * w


def diurnal_markov_step(u: torch.Tensor, state: torch.Tensor,
                        tod_h: torch.Tensor, p_on_day: float,
                        p_on_night: float, p_off_day: float,
                        p_off_night: float, *,
                        weekend: Optional[torch.Tensor] = None,
                        weekend_on_mult: float = 1.0,
                        weekend_off_mult: float = 1.0) -> torch.Tensor:
    """One transition of a diurnal two-state Markov chain, shared by the
    plug (battery) and online (availability) processes: (S,) bool ->
    (S,) bool, off->on with prob p_on and on->off with prob p_off, each
    interpolated between its day/night value, from the (S,) uniform `u`.

    `weekend` ((S,) bool from `is_weekend`) scales the probabilities by
    the weekend multipliers on weekend devices, clipped back to [0, 1];
    None, or both multipliers 1, is the pure diurnal chain."""
    p_on = diurnal(p_on_day, p_on_night, tod_h)
    p_off = diurnal(p_off_day, p_off_night, tod_h)
    if weekend is not None and (weekend_on_mult != 1.0
                                or weekend_off_mult != 1.0):
        p_on = torch.where(weekend, p_on * weekend_on_mult, p_on).clamp(0.0, 1.0)
        p_off = torch.where(weekend, p_off * weekend_off_mult, p_off).clamp(0.0, 1.0)
    return torch.where(state, u >= p_off, u < p_on)
