"""Charging sessions and background drain.

The plug state is a diurnal two-state Markov process (plug-in peaks at
night; weekend multipliers reshape it); while plugged, a device gains
`charge_c_per_hour` of its capacity per hour, and every device pays a
background drain. A dropped device rejoins once it is charging and holds
`recover_rounds` minimal-round budgets above its reserve. The port of
`repro.sim.dynamics.battery`, op for op in f32, with the uniform draw an
argument.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.sim.devices import DeviceFleet
from repro_torch.sim.dynamics.diurnal import diurnal_markov_step


def plug_step(u: torch.Tensor, charging: torch.Tensor, tod_h: torch.Tensor,
              sc, weekend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Diurnal plug-in/unplug Markov transition: (S,) bool -> (S,) bool."""
    return diurnal_markov_step(u, charging, tod_h,
                               sc.plug_on_day, sc.plug_on_night,
                               sc.plug_off_day, sc.plug_off_night,
                               weekend=weekend,
                               weekend_on_mult=sc.weekend_plug_on_mult,
                               weekend_off_mult=sc.weekend_plug_off_mult)


def charge_and_drain(energy: torch.Tensor, charging: torch.Tensor,
                     fleet: DeviceFleet, sc) -> torch.Tensor:
    """One round of charging + background drain, clipped to [0,
    capacity]: (S,) J -> (S,) J.

    The reference writes the gain (c·capacity)·(dt/3600); compiled, XLA
    folds its two constants into one f32 product first, so the gain is
    capacity·f32(f32(c)·f32(dt/3600)), and that is what the port
    computes. The drain is one Python float, as in the reference."""
    dt_s = sc.minutes_per_round * 60.0
    rate = float(np.float32(sc.charge_c_per_hour) * np.float32(dt_s / 3600.0))
    gain = torch.where(charging, fleet.battery_j * rate, 0.0)
    return (energy + gain - sc.idle_drain_w * dt_s).clamp_min(0.0).minimum(
        fleet.battery_j)


def recovery_step(dropped: torch.Tensor, charging: torch.Tensor,
                  energy: torch.Tensor, fleet: DeviceFleet,
                  min_cost: torch.Tensor, sc) -> torch.Tensor:
    """Clear `dropped` for charging devices holding strictly more than
    `recover_rounds` minimal-round budgets above reserve."""
    funded = energy - fleet.e0_reserve > sc.recover_rounds * min_cost
    return dropped & ~(charging & funded)
