"""Gilbert–Elliott wireless environment: per-device good/bad Markov state.

Devices migrate between the paper's two rate environments with
per-round transition probabilities; the lognormal fading of
`sim.wireless` rides on whichever mean the channel state selects. The
port of `repro.sim.dynamics.channel`, with the uniform draw an argument.
"""
from __future__ import annotations

import torch

from repro_torch.sim.devices import DeviceFleet


def channel_step(u: torch.Tensor, good: torch.Tensor,
                 p_good_to_bad: float, p_bad_to_good: float) -> torch.Tensor:
    """One Markov transition for every device from the (S,) uniform `u`:
    (S,) bool -> (S,) bool."""
    stay_good = good & (u >= p_good_to_bad)
    recover = ~good & (u < p_bad_to_good)
    return stay_good | recover


def effective_rate_mean(good: torch.Tensor, fleet: DeviceFleet) -> torch.Tensor:
    """(S,) bps mean selected by the current channel state."""
    return torch.where(good, fleet.rate_high, fleet.rate_low)
