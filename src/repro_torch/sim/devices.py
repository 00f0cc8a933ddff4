"""Device fleet simulation replacing the paper's physical testbed.

The paper's testbed (Sec. IV-A): 100 mobile devices, 20 of each of five
types, hybrid Wi-Fi 5 / 5G links, Monsoon-measured power. Each type
carries measured-scale constants calibrated to the paper's published
numbers (see `repro.sim.devices`, whose catalog and draws this module
reproduces: the same seed gives bitwise-equal fleet arrays).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.common import resolve_device


@dataclasses.dataclass(frozen=True)
class DeviceType:
    name: str
    t_iter: float       # s per local iteration
    p_compute: float    # W during local training
    p_tx: float         # W during uplink transmission
    battery_j: float    # full battery capacity, Joules
    link: str           # "5g" | "wifi5"
    rate_high: float    # bps — good transmission environment
    rate_low: float     # bps — poor transmission environment


# Calibrated to the paper's hardware list (Sec. IV-A) and quoted rates.
DEVICE_CATALOG: Dict[str, DeviceType] = {
    # Snapdragon 8+ Gen1 / Adreno 730, 4500 mAh ~ 62 kJ
    "xiaomi_12s": DeviceType("xiaomi_12s", 1.0, 6.5, 2.5, 62e3,
                             "5g", 79.60e6, 0.64e6),
    # Snapdragon 778G+ / Adreno 642L, 5000 mAh ~ 69 kJ
    "honor_70": DeviceType("honor_70", 1.8, 5.5, 2.5, 69e3,
                           "5g", 45.0e6, 0.64e6),
    # Dimensity 700 / Mali-G57 MC2, 5000 mAh ~ 69 kJ
    "honor_play_6t": DeviceType("honor_play_6t", 3.5, 4.5, 2.5, 69e3,
                                "5g", 12.0e6, 0.64e6),
    # Unisoc T618 tablet, 7000 mAh ~ 97 kJ
    "teclast_m40": DeviceType("teclast_m40", 3.0, 5.0, 1.8, 97e3,
                              "wifi5", 40.0e6, 2.0e6),
    # Intel i5-8259U laptop, 58 Wh ~ 208.8 kJ
    "macbook_pro_2018": DeviceType("macbook_pro_2018", 0.6, 22.0, 1.2,
                                   208.8e3, "wifi5", 60.0e6, 4.0e6),
}

TYPE_ORDER = list(DEVICE_CATALOG)


class DeviceFleet(NamedTuple):
    """Static per-device attributes, all (S,) tensors on one device."""
    type_id: torch.Tensor       # int32 index into TYPE_ORDER
    t_iter: torch.Tensor        # f32 s/iteration
    p_compute: torch.Tensor     # f32 W
    p_tx: torch.Tensor          # f32 W
    battery_j: torch.Tensor     # f32 capacity
    init_energy: torch.Tensor   # f32 initial residual energy (J)
    rate_mean: torch.Tensor     # f32 mean uplink bps (build-time env)
    rate_sigma: torch.Tensor    # f32 lognormal sigma of per-round fading
    rate_high: torch.Tensor     # f32 bps — good-environment mean
    rate_low: torch.Tensor      # f32 bps — poor-environment mean
    e0_reserve: torch.Tensor    # f32 reserve energy threshold E0 (J)
    data_size: torch.Tensor     # int32 |B_i|

    @property
    def n(self) -> int:
        return self.type_id.shape[0]


def build_fleet(n_devices: int = 100, *, seed: int = 0,
                frac_low_rate: float = 0.5,
                e0_frac: float = 0.05,
                init_energy_mean: float = 0.5,
                init_energy_std: float = 0.25,
                data_size: int = 500,
                rate_sigma: float = 0.3,
                device="cuda") -> DeviceFleet:
    """Paper fleet: n/5 of each type (a remainder round-robins over the
    catalog); initial battery ~ clipped normal over the capacity range;
    half the devices in a poor transmission env. Drawn with numpy's
    `RandomState(seed)` exactly as the reference, then placed on
    `device`."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    n_types = len(TYPE_ORDER)
    per, rem = divmod(n_devices, n_types)
    type_id = np.concatenate([np.repeat(np.arange(n_types), per),
                              np.arange(rem)])

    def gather(attr):
        return np.array([getattr(DEVICE_CATALOG[TYPE_ORDER[t]], attr)
                         for t in type_id], np.float32)

    battery = gather("battery_j")
    init_frac = np.clip(rng.normal(init_energy_mean, init_energy_std,
                                   n_devices), 0.10, 1.0)
    low = rng.rand(n_devices) < frac_low_rate
    rate = np.where(low, gather("rate_low"), gather("rate_high"))
    sizes = np.maximum(1, rng.poisson(data_size, n_devices)).astype(np.int32)

    def t(x, dtype=np.float32):
        return torch.as_tensor(np.asarray(x, dtype), device=dev)

    return DeviceFleet(
        type_id=t(type_id, np.int32),
        t_iter=t(gather("t_iter")),
        p_compute=t(gather("p_compute")),
        p_tx=t(gather("p_tx")),
        battery_j=t(battery),
        init_energy=t(battery * init_frac),
        rate_mean=t(rate),
        rate_sigma=t(np.full((n_devices,), rate_sigma)),
        rate_high=t(gather("rate_high")),
        rate_low=t(gather("rate_low")),
        e0_reserve=t(battery * e0_frac),
        data_size=t(sizes, np.int32),
    )


def build_fleet_batch(seeds: Sequence[int], n_devices: int = 100,
                      **kwargs) -> DeviceFleet:
    """Per-seed fleets stacked into a DeviceFleet of (B, S) leaves, B =
    len(seeds), for a campaign batch with `per_seed_fleets=True`: seed s
    draws exactly `build_fleet(n_devices, seed=s, **kwargs)`, the fleet
    `launch.fl_run.run_fl(seed=s)` builds. The batch's `.n` reports B:
    read `type_id.shape[-1]` for the fleet size."""
    fleets = [build_fleet(n_devices, seed=s, **kwargs) for s in seeds]
    return DeviceFleet(*(torch.stack(xs) for xs in zip(*fleets)))
