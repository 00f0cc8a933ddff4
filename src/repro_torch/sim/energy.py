"""Per-round latency / energy model (paper Sec. III-A estimation rules).

Given H(i,r), a device's round cost splits into local computing and uplink
communication (footnote 3: DVFS non-linearity neglected, as in the paper):

  t(i,r)    = H·t_iter + bits/s(i,r)
  e_cp(i,r) = H·t_iter·p_compute
  e_tx(i,r) = p_tx·bits/s(i,r)
  e(i,r)    = e_cp + e_tx
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.common import rdiv
from repro_torch.sim.devices import DeviceFleet


class RoundCosts(NamedTuple):
    t_total: torch.Tensor   # (S,) s
    t_comp: torch.Tensor
    t_comm: torch.Tensor
    e_total: torch.Tensor   # (S,) J
    e_comp: torch.Tensor
    e_comm: torch.Tensor


def min_round_cost(fleet: DeviceFleet, model_bits: float,
                   rate_mean: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(S,) J for the cheapest possible round (H=1, mean-rate uplink) —
    the feasibility floor shared by the drop rule in `core.round` and the
    recovery rule in `sim.dynamics.battery`. `rate_mean` overrides the
    build-time mean (dynamic scenarios pass the channel state's mean)."""
    if rate_mean is None:
        rate_mean = fleet.rate_mean
    return (fleet.t_iter * fleet.p_compute
            + rdiv(model_bits, rate_mean.clamp_min(1.0)) * fleet.p_tx)


def round_costs(fleet: DeviceFleet, H: torch.Tensor, rates: torch.Tensor,
                model_bits: float) -> RoundCosts:
    t_comp = H.float() * fleet.t_iter
    t_comm = rdiv(model_bits, rates.clamp_min(1.0))
    e_comp = t_comp * fleet.p_compute
    e_comm = t_comm * fleet.p_tx
    return RoundCosts(t_comp + t_comm, t_comp, t_comm,
                      e_comp + e_comm, e_comp, e_comm)
