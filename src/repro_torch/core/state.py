"""Fleet state carried across FL rounds (all (S,) tensors)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.sim.devices import DeviceFleet


class FleetState(NamedTuple):
    residual_energy: torch.Tensor   # f32 (S,) — E_i^r, Joules
    H: torch.Tensor                 # i32 — current local-iteration count H(i)
    u: torch.Tensor                 # i32 — rounds since last participation
    last_round: torch.Tensor        # i32 — last participating round (-1 = never)
    last_stat: torch.Tensor         # f32 — cached statistical utility
    last_local_loss: torch.Tensor   # f32 — Loss(θ_i) at last participation
    last_ecp: torch.Tensor          # f32 — e_cp(i, last participation)
    last_energy: torch.Tensor       # f32 — E_i at last participation
    dropped: torch.Tensor           # bool — battery below feasibility forever
    q_value: torch.Tensor           # f32 — AutoFL bandit value estimate
    n_participations: torch.Tensor  # i32
    n_selected: torch.Tensor        # i32 — times selected (incl. failed)
    g_loss: torch.Tensor            # f32 — last probed global-model loss per
                                    # device (round 0 always probes, so the
                                    # init value is never consumed)


def init_fleet_state(fleet: DeviceFleet, *, H0: int = 5,
                     optimistic_stat: float = 1e4) -> FleetState:
    """Fresh state: optimistic statistical utility (Oort-style — unexplored
    devices rank high), energy at the simulated initial battery level."""
    e = fleet.init_energy

    def full(v, dtype):
        return torch.full_like(e, v, dtype=dtype)

    return FleetState(
        residual_energy=e.clone(),
        H=full(H0, torch.int32),
        u=full(0, torch.int32),
        last_round=full(-1, torch.int32),
        last_stat=full(optimistic_stat, torch.float32),
        last_local_loss=full(10.0, torch.float32),
        last_ecp=full(1.0, torch.float32),
        last_energy=e.clone(),
        dropped=full(False, torch.bool),
        q_value=full(1e3, torch.float32),
        n_participations=full(0, torch.int32),
        n_selected=full(0, torch.int32),
        g_loss=full(0.0, torch.float32),
    )
