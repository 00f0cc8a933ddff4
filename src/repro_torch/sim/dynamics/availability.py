"""Availability churn: per-device online/offline Markov process.

Offline devices are excluded from selection like dropped ones, but the
state is transient: the diurnal chain brings them back. The port of
`repro.sim.dynamics.availability`, with the uniform draw an argument.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.sim.dynamics.diurnal import diurnal_markov_step


def online_step(u: torch.Tensor, online: torch.Tensor, tod_h: torch.Tensor,
                sc, weekend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Diurnal online/offline Markov transition: (S,) bool -> (S,) bool."""
    return diurnal_markov_step(u, online, tod_h,
                               sc.p_online_day, sc.p_online_night,
                               sc.p_offline_day, sc.p_offline_night,
                               weekend=weekend,
                               weekend_on_mult=sc.weekend_online_on_mult,
                               weekend_off_mult=sc.weekend_online_off_mult)
