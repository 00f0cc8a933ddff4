"""FedBuff-style async buffered aggregation — buffer and clock ops.

The port of `repro.core.async_agg`. Selected devices snapshot the global
params at dispatch; their updates land on a virtual wall clock after a
per-device delay (the wireless/compute cost model's round time, or one
clock unit), and the server aggregates once M updates have arrived,
each staleness-weighted by γ = (1 + staleness)^(−staleness_power).

Everything is fixed-shape and mask-based, with no host sync: the
pending-update buffer is a static (P_slots, ...) slot array
(`core.state.AsyncState`), pushes scatter into free slots, and each land
step aggregates the arrivals up to the M-th smallest arrival time with
one `fedavg` launch over the (P_slots, P) delta buffer. Where the
reference takes a branch with `lax.cond`, both sides are computed and
`torch.where` picks.

Buffer invariants (tests/test_torch_async.py):

  * a slot lands at most once per push (landing frees it);
  * landed-update staleness = server_version − snapshot_version ≥ 0;
  * live occupancy at step end never reaches M;
  * device-rounds are conserved: n_dispatched = n_landed + n_expired +
    live slots.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.common import scatter_drop
from repro_torch.core.state import AsyncState
from repro_torch.kernels.fedavg import ops as fedavg_ops

DELAY_MODES = ("wall", "unit")


@dataclasses.dataclass(frozen=True)
class AsyncCfg:
    """Static configuration of the async aggregation mode.

    buffer_m          — aggregate once M live updates have arrived.
    delay             — "wall": an update's delay is the device's round
                        time t_total (straggler-inflated under faults);
                        "unit": every update takes one clock unit.
    delay_jitter      — lognormal sigma multiplied onto the delay (0 =
                        deterministic; the round then draws nothing for it).
    staleness_power   — a in γ = (1 + staleness)^(−a); 0 disables
                        down-weighting.
    server_lr         — scale on the aggregated delta. The bitwise sync
                        fast path only arms at 1.0.
    capacity          — slot count P_slots (None → buffer_m + K).
    n_lands           — land attempts per round (None → ceil(K / buffer_m),
                        enough to drain a full dispatch).
    ttl               — slot time-to-live in virtual seconds (None = off):
                        an in-flight update whose remaining delay exceeds
                        it is re-dispatched, its remaining delay times
                        `retry_backoff`, up to `max_retries` times, then
                        dropped and counted in `AsyncState.n_expired`.
    max_retries       — bounded re-dispatch attempts per slot (≥ 0).
    retry_backoff     — remaining-delay multiplier per retry, in (0, 1).
    """
    buffer_m: int = 10
    delay: str = "wall"
    delay_jitter: float = 0.0
    staleness_power: float = 0.5
    server_lr: float = 1.0
    capacity: Optional[int] = None
    n_lands: Optional[int] = None
    ttl: Optional[float] = None
    max_retries: int = 2
    retry_backoff: float = 0.5

    def __post_init__(self):
        if self.buffer_m < 1:
            raise ValueError(f"buffer_m must be >= 1, got {self.buffer_m}")
        if self.delay not in DELAY_MODES:
            raise ValueError(f"delay must be one of {DELAY_MODES}, "
                             f"got {self.delay!r}")
        if self.delay_jitter < 0:
            raise ValueError("delay_jitter must be >= 0")
        if self.staleness_power < 0:
            raise ValueError("staleness_power must be >= 0")
        if self.ttl is not None and self.ttl <= 0:
            raise ValueError(f"ttl must be > 0, got {self.ttl}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, "
                             f"got {self.max_retries}")
        if not 0.0 < self.retry_backoff < 1.0:
            raise ValueError("retry_backoff must be in (0, 1), "
                             f"got {self.retry_backoff}")

    def slots(self, k: int) -> int:
        """Static pending-buffer capacity P_slots for a K-slot dispatch."""
        p = self.capacity if self.capacity is not None else self.buffer_m + k
        if p < max(self.buffer_m, k):
            raise ValueError(f"capacity {p} < max(buffer_m, K) "
                             f"= {max(self.buffer_m, k)}")
        return p

    def lands(self, k: int) -> int:
        """Static land attempts per round: enough that a K-slot dispatch
        always drains back below M before the next dispatch."""
        if self.n_lands is not None:
            return max(1, self.n_lands)
        return max(1, -(-k // self.buffer_m))  # ceil(K / M)


def push_cohort(st: AsyncState, deltas: torch.Tensor, device_idx: torch.Tensor,
                live: torch.Tensor, weights: torch.Tensor,
                delays: torch.Tensor) -> Tuple[AsyncState, torch.Tensor]:
    """Dispatch a K-slot cohort into free pending slots.

    deltas: (K, P) θ_k − θ at dispatch; device_idx/live/weights/delays:
    (K,). Cohort slot i goes to the i-th free buffer slot whether or not
    it is live; dead cohort slots are not written, so a dead slot still
    uses up its free-slot index (the reference's `nonzero(~slot_live,
    size=K, fill_value=P_slots)`, here a sort). Pushes beyond capacity
    drop. Returns (state', n_pushed)."""
    P = st.slot_live.shape[0]
    k = device_idx.shape[0]
    ar = torch.arange(P, device=st.slot_live.device)
    free = torch.sort(torch.where(st.slot_live, P, ar)).values[:k]
    if free.shape[0] < k:
        free = torch.cat([free, free.new_full((k - free.shape[0],), P)])
    written = live & (free < P)
    target = torch.where(written, free, P)
    n_pushed = written.sum(dtype=torch.int32)
    # src[j]: the cohort slot written into buffer slot j (−1: none); live
    # targets are distinct, the dropped ones all go to the sliced-off P
    src = scatter_drop(torch.full_like(ar, -1), target,
                   torch.arange(k, device=ar.device))
    take, si = src >= 0, src.clamp_min(0)
    new = st._replace(
        slot_live=st.slot_live | take,
        slot_device=torch.where(take, device_idx.int()[si], st.slot_device),
        slot_arrival=torch.where(take, (st.t_now + delays.float())[si],
                                 st.slot_arrival),
        slot_version=torch.where(take, st.server_version, st.slot_version),
        slot_weight=torch.where(take, weights.float()[si], st.slot_weight),
        slot_delta=torch.where(take[:, None], deltas.to(st.slot_delta.dtype)[si],
                               st.slot_delta),
        slot_retry=torch.where(take, 0, st.slot_retry),
        n_dispatched=st.n_dispatched + n_pushed,
    )
    return new, n_pushed


def expire_and_retry(st: AsyncState, *, ttl: float, max_retries: int,
                     retry_backoff: float
                     ) -> Tuple[AsyncState, Dict[str, torch.Tensor]]:
    """Slot TTL with bounded re-dispatch (deterministic). A live slot
    whose remaining delay `slot_arrival − t_now` exceeds `ttl` is
    re-dispatched (remaining delay × `retry_backoff`, `slot_retry` + 1)
    while it has retries left, else dropped and counted in `n_expired`.
    Returns (state', {"n_retried", "n_expired"}) with per-call counts."""
    remaining = st.slot_arrival - st.t_now
    overdue = st.slot_live & (remaining > ttl)
    can_retry = overdue & (st.slot_retry < max_retries)
    give_up = overdue & ~can_retry
    n_retried = can_retry.sum(dtype=torch.int32)
    n_expired = give_up.sum(dtype=torch.int32)
    new = st._replace(
        slot_live=st.slot_live & ~give_up,
        slot_arrival=torch.where(can_retry, st.t_now + remaining * retry_backoff,
                                 st.slot_arrival),
        slot_retry=st.slot_retry + can_retry.int(),
        n_expired=st.n_expired + n_expired,
    )
    return new, {"n_retried": n_retried, "n_expired": n_expired}


def land_once(params_flat: torch.Tensor, st: AsyncState, m_eff, *,
              staleness_power: float, server_lr: float = 1.0,
              sync_aggregate: Optional[torch.Tensor] = None,
              sync_pred=None) -> Tuple[torch.Tensor, AsyncState, Dict[str, torch.Tensor]]:
    """One buffered-aggregation attempt on the virtual clock.

    If at least `m_eff` (an int or a 0-d tensor) live updates are
    pending, the clock advances to the m_eff-th smallest arrival t_agg
    and every live update with arrival ≤ t_agg lands: θ' = θ + server_lr
    · Σ c̃_j Δ_j with c̃ ∝ weight·γ(staleness), one `fedavg` launch over
    the whole delta buffer (unlanded rows at weight 0); server_version
    bumps and the landed slots free. Otherwise the state passes through.

    `sync_aggregate` / `sync_pred`: the bitwise sync fast path. When
    `can & sync_pred(n_landed)` holds (the caller passes "buffer was
    empty before dispatch" ∧ "landed count equals cohort size"), the
    result is `sync_aggregate`, the literal sync FedAvg of the cohort.
    Only armed when server_lr == 1.

    Two slots of one device that land together both write its
    `update_staleness`; the highest slot index wins, as in the
    reference's XLA scatter on the CPU."""
    S = st.update_staleness.shape[0]
    P = st.slot_live.shape[0]
    arr = torch.where(st.slot_live, st.slot_arrival, torch.inf)
    n_pend = st.slot_live.sum(dtype=torch.int32)
    m_eff = torch.as_tensor(m_eff, dtype=torch.int32, device=arr.device)
    can = n_pend >= m_eff
    t_agg = torch.sort(arr).values.gather(0, (m_eff - 1).clamp_min(0).long().view(1))[0]
    landed = st.slot_live & (arr <= t_agg) & can
    n_landed = landed.sum(dtype=torch.int32)
    stale = st.server_version - st.slot_version   # (P_slots,) i32, >= 0 for live
    if staleness_power > 0.0:
        gamma = (1.0 + stale.float()) ** (-staleness_power)
    else:
        gamma = torch.ones_like(stale, dtype=torch.float32)
    coef = torch.where(landed, st.slot_weight * gamma, 0.0)
    csum = coef.sum()
    wn = coef / csum.clamp_min(1e-9)
    agg = fedavg_ops.weighted_aggregate(st.slot_delta, wn)
    new_params = torch.where(csum > 0, params_flat + server_lr * agg, params_flat)
    if sync_aggregate is not None and server_lr == 1.0:
        pred = can if sync_pred is None else can & sync_pred(n_landed)
        new_params = torch.where(pred, sync_aggregate, new_params)

    # per-device staleness: of a device's landed slots, the highest wins
    slot = torch.arange(P, device=arr.device)
    dev_idx = torch.where(landed, st.slot_device.long(), S)
    top = torch.full((S + 1,), -1, dtype=torch.int64, device=arr.device)
    top = top.scatter_reduce(0, dev_idx, slot, "amax")
    keep = landed & (top[dev_idx] == slot)
    new_st = st._replace(
        slot_live=st.slot_live & ~landed,
        t_now=torch.where(can, torch.maximum(st.t_now, t_agg), st.t_now),
        server_version=st.server_version + can.int(),
        n_landed=st.n_landed + n_landed,
        update_staleness=scatter_drop(st.update_staleness,
                                  torch.where(keep, dev_idx, S), stale),
    )
    info = {
        "did_aggregate": can.int(),
        "n_landed": n_landed,
        "landed": landed,
        "stale_sum": torch.where(landed, stale, 0).sum(dtype=torch.int32),
    }
    return new_params, new_st, info
