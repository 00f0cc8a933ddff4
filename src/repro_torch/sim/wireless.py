"""Wireless uplink model: per-round stochastic rates around each device's
environment mean (lognormal fading), as in the paper's hybrid Wi-Fi 5 / 5G
setup with high/low-rate environments.

The standard-normal draw is an argument, not drawn here: the round takes
its random numbers as `core.round.RoundNoise`, so a test can hand the
port exactly the reference's draws.
"""
from __future__ import annotations

import torch

from repro_torch.sim.devices import DeviceFleet


def lognormal_fading(eps: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """(S,) unit-mean multiplicative fading exp(σ·ε − σ²/2) for a
    standard-normal draw ε."""
    return torch.exp(sigma * eps - 0.5 * (sigma * sigma))


def sample_rates_from_mean(eps: torch.Tensor, mean: torch.Tensor,
                           sigma: torch.Tensor) -> torch.Tensor:
    """(S,) bps around an arbitrary per-round mean."""
    return mean * lognormal_fading(eps, sigma)


def sample_rates(eps: torch.Tensor, fleet: DeviceFleet) -> torch.Tensor:
    """(S,) bps for this round: rate_mean * lognormal(sigma)."""
    return sample_rates_from_mean(eps, fleet.rate_mean, fleet.rate_sigma)
