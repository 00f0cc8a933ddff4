"""Fleet state carried across FL rounds (all (S,) tensors), the async
mode's virtual clock and pending-update buffer, and the streaming
telemetry's reducer states."""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from repro_torch.common import tree_map
from repro_torch.sim.devices import DeviceFleet


class TelemetryCarry(NamedTuple):
    """Streaming-telemetry reducer states, carried across rounds and
    chunks beside FleetState when `TelemetryCfg(mode="streaming")` is on.

    `reducers` maps a `core.metrics.MetricSpec.state_key` to that
    reducer's state on the run's device (running sums, Welford moments,
    ring snapshot buffers, fixed-bin quantile histograms, ...): O(S) (or
    O(bins) for the p50/p95 tails) per per-device metric instead of an
    O(R·S) dense history. Built, folded and drained by
    `core.metrics.init_telemetry / update_telemetry /
    finalize_telemetry`."""
    reducers: Dict[str, Any]


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


class AsyncState(NamedTuple):
    """Virtual clock + fixed-capacity pending-update buffer carried across
    rounds in the async (FedBuff-style) mode (`core.async_agg`). Slot
    tensors have leading axis P_slots (`AsyncCfg.slots(K)`); `slot_delta`
    is one contiguous (P_slots, P) buffer of θ_k − θ(dispatch) in the
    model's flat layout (`models.fl_models.ParamLayout`), so a land is one
    `fedavg` launch. Dead slots are masked by `slot_live`."""
    t_now: torch.Tensor             # f32 () — virtual wall clock (s)
    server_version: torch.Tensor    # i32 () — aggregations applied so far
    slot_live: torch.Tensor         # bool (P_slots,) — holds an in-flight update
    slot_device: torch.Tensor       # i32 — dispatching device index
    slot_arrival: torch.Tensor      # f32 — virtual arrival time
    slot_version: torch.Tensor      # i32 — server_version at dispatch
    slot_weight: torch.Tensor       # f32 — FedAvg weight (0 = failed)
    slot_delta: torch.Tensor        # f32 (P_slots, P) — θ_k − θ(dispatch)
    slot_retry: torch.Tensor        # i32 — TTL re-dispatch attempts so far
    n_dispatched: torch.Tensor      # i32 () — updates pushed (ever)
    n_landed: torch.Tensor          # i32 () — updates aggregated (ever)
    n_expired: torch.Tensor         # i32 () — updates dropped by the slot TTL
    update_staleness: torch.Tensor  # i32 (S,) — staleness of each device's
                                    # most recently landed update


def replicate_state(state, n: int):
    """Stack `n` copies of a state tree (FleetState, EnvState,
    AsyncState, TelemetryCarry or MethodParams) into (n, ...) leaves for
    a campaign batch's vmap: fresh init states are deterministic, so the
    cells share them by copy."""
    return tree_map(lambda x: x.unsqueeze(0).expand((n,) + x.shape).clone(), state)


def init_async_state(params_flat: torch.Tensor, n_devices: int,
                     capacity: int) -> AsyncState:
    """Empty buffer at virtual time zero, on `params_flat`'s device, for a
    model of `params_flat.numel()` parameters; `capacity` is the slot
    count P_slots (`core.async_agg.AsyncCfg.slots(K)`)."""
    dev = params_flat.device

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return AsyncState(
        t_now=zeros(dtype=torch.float32),
        server_version=zeros(),
        slot_live=zeros(capacity, dtype=torch.bool),
        slot_device=zeros(capacity),
        slot_arrival=zeros(capacity, dtype=torch.float32),
        slot_version=zeros(capacity),
        slot_weight=zeros(capacity, dtype=torch.float32),
        slot_delta=zeros(capacity, params_flat.numel(), dtype=params_flat.dtype),
        slot_retry=zeros(capacity),
        n_dispatched=zeros(),
        n_landed=zeros(),
        n_expired=zeros(),
        update_staleness=zeros(n_devices),
    )


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
