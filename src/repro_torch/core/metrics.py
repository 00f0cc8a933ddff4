"""Streaming telemetry: declarative per-device metric reducers on the device.

The port of `repro.core.metrics`. REWAFL's evaluation tracks per-device
signals — residual battery energy, staleness, adaptive H — across every
round. The dense way to keep them is an (R, S) host buffer per metric;
most consumers only need per-device aggregates (selection counts,
mean/peak energy, final H), so this module folds those reductions on the
run's device, once a round, into O(S) reducer states carried across
rounds and chunks, and drains them once at the end of the run.

A `MetricSpec` names one (metric, reducer) pair; a `TelemetryCfg`
bundles the specs with the dense/streaming switch `launch.engine` takes.
Reducers:

  last    — the metric's final value
  sum     — running float32 sum over rounds
  mean    — Welford running mean (float32)
  std     — Welford running population std (ddof=0, as np.std)
  max     — running max (native dtype; bool promotes to int32)
  count   — rounds where the value was nonzero (selection counts)
  ring    — the value of every `every`-th round in a (cap, ...) ring;
            `ring(every=1, cap=R)` reproduces the dense trace
  p50/p95 — quantiles from a fixed-bin histogram over [`lo`, `hi`):
            every element of every round's value is one sample
            (out-of-range samples clip into the end bins); p50 and p95
            of one (metric, bins, lo, hi) share one histogram state

Every state is a tensor (or a NamedTuple of tensors) shaped like the
metric (a `cap` axis for rings, (bins,) for histograms), on the device
of the metric it folds. `update_telemetry` issues only device ops: no
`.item()`, no copy to the host and none from it, so a round stays free
of host syncs. The keys are the reference's (`tel/<metric>/<reducer>`,
`<metric>/welford`, `<metric>/ring{every}x{cap}`,
`<metric>/hist{bins}@{lo}:{hi}`).

The histogram's bin index is computed as the compiled reference computes
it: XLA folds `(x - lo) / (hi - lo) * bins` into one product
`(x - lo) * c` with `c = f32(f32(1 / f32(hi - lo)) * bins)`, and
converts to int32 saturating, NaN to 0. PyTorch on the CPU converts NaN,
±inf and values beyond int32 to INT_MIN, so the index is clamped in
float first (NaN to 0), which gives XLA's bins on both devices.

Op for op this is the reference's f32 math, so it is bitwise with the
reference's update run op by op. Inside its compiled scan XLA fuses the
Welford update and contracts `m2 + d * (x - mean)` into a fused
multiply-add, so `std` there can differ in the last bits (2 ulp after 12
rounds in tests/test_torch_metrics.py).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.state import TelemetryCarry

# The per-device (S,) leaves the round emits every round. Dense history
# keeps only DENSE_PER_DEVICE as (R, S) traces; the rest exist for the
# reducers to fold and never reach the history.
PER_DEVICE_METRICS = ("selected", "H", "residual_energy", "staleness",
                      "update_staleness")
DENSE_PER_DEVICE = ("selected", "H")

QUANTILE_REDUCERS = ("p50", "p95")
QUANTILE_Q = {"p50": 0.50, "p95": 0.95}
REDUCERS = ("last", "sum", "mean", "std", "max", "count",
            "ring") + QUANTILE_REDUCERS


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One (metric, reducer) pair. `metric` is a key of the round's
    metrics dict (a per-device leaf of PER_DEVICE_METRICS or any scalar
    metric); `every`/`cap` apply to `ring` only, and `bins`/`lo`/`hi` to
    the histogram quantile reducers (p50/p95)."""
    metric: str
    reducer: str
    every: int = 1    # ring: snapshot every N rounds
    cap: int = 16     # ring: snapshot buffer capacity
    bins: int = 64    # p50/p95: histogram bin count
    lo: float = 0.0   # p50/p95: histogram range [lo, hi)
    hi: float = 1.0

    def __post_init__(self):
        if self.reducer not in REDUCERS:
            raise ValueError(f"unknown reducer {self.reducer!r} — "
                             f"choose from {REDUCERS}")
        if self.reducer == "ring" and (self.every < 1 or self.cap < 1):
            raise ValueError(f"ring needs every >= 1 and cap >= 1, got "
                             f"every={self.every} cap={self.cap}")
        if self.reducer in QUANTILE_REDUCERS:
            if self.bins < 1:
                raise ValueError(f"quantile reducer needs bins >= 1, "
                                 f"got {self.bins}")
            if not self.hi > self.lo:
                raise ValueError(f"quantile reducer needs hi > lo, got "
                                 f"lo={self.lo} hi={self.hi}")

    @property
    def out_key(self) -> str:
        """History key of the finalized output."""
        return f"tel/{self.metric}/{self.reducer}"

    @property
    def state_key(self) -> str:
        """Carry key of the reducer state: mean/std share one Welford
        accumulator, quantiles of one (bins, lo, hi) histogram share one
        count vector, rings of different strides stay apart."""
        if self.reducer in ("mean", "std"):
            return f"{self.metric}/welford"
        if self.reducer == "ring":
            return f"{self.metric}/ring{self.every}x{self.cap}"
        if self.reducer in QUANTILE_REDUCERS:
            return f"{self.metric}/hist{self.bins}@{self.lo}:{self.hi}"
        return f"{self.metric}/{self.reducer}"


# Per-device aggregates the paper's tables and run_fl's summary read:
# selection counts, the residual-energy profile, staleness, H.
DEFAULT_SPECS: Tuple[MetricSpec, ...] = (
    MetricSpec("selected", "count"),
    MetricSpec("residual_energy", "mean"),
    MetricSpec("residual_energy", "std"),
    MetricSpec("residual_energy", "max"),
    MetricSpec("staleness", "mean"),
    MetricSpec("staleness", "max"),
    MetricSpec("H", "mean"),
    MetricSpec("H", "last"),
)

# The async round's own metrics: the virtual wall clock and the
# per-device staleness of landed updates (only async runs emit them).
ASYNC_SPECS: Tuple[MetricSpec, ...] = DEFAULT_SPECS + (
    MetricSpec("wall_clock", "last"),
    MetricSpec("update_staleness", "mean"),
    MetricSpec("update_staleness", "max"),
)

# Whole-run totals of the chaos counters (sim.faults), for runs whose
# metrics carry them (a fault scenario): append them by hand;
# init_telemetry raises on a metric the round does not emit.
FAULT_SPECS: Tuple[MetricSpec, ...] = (
    MetricSpec("n_aborted", "sum"),
    MetricSpec("n_lost", "sum"),
    MetricSpec("n_corrupted", "sum"),
    MetricSpec("n_straggler", "sum"),
)


@dataclasses.dataclass(frozen=True)
class TelemetryCfg:
    """Telemetry regime of an engine run.

    mode="dense" (default): per-device history as (R, S) host arrays of
    `selected` and `H`, no reducers.
    mode="streaming": no per-device leaf reaches the history; `specs`
    are folded every round and drained once at the end as O(S) arrays
    under their `tel/<metric>/<reducer>` keys. The per-round scalars go
    to the history either way."""
    mode: str = "dense"
    specs: Tuple[MetricSpec, ...] = DEFAULT_SPECS

    def __post_init__(self):
        if self.mode not in ("dense", "streaming"):
            raise ValueError(f"telemetry mode must be 'dense' or "
                             f"'streaming', got {self.mode!r}")
        keys = [s.out_key for s in self.specs]
        if len(set(keys)) != len(keys):
            raise ValueError(f"duplicate telemetry specs: {keys}")

    @property
    def streaming(self) -> bool:
        return self.mode == "streaming"


class Welford(NamedTuple):
    """Running mean/variance accumulator (a count per element, so the
    state has the metric's shape)."""
    n: torch.Tensor      # f32, the metric's shape
    mean: torch.Tensor   # f32
    m2: torch.Tensor     # f32 — sum of squared deviations


class Ring(NamedTuple):
    buf: torch.Tensor    # (cap, ...) snapshots, the metric's dtype
    n: torch.Tensor      # i32 () — snapshots taken (wraps past cap)


class Hist(NamedTuple):
    """Fixed-bin histogram over [lo, hi), the shared state of p50/p95:
    every element of every round's value is one sample; a quantile is
    read off the cumulative counts, to half a bin width. The counts are
    f32 sums of 1.0, exact up to 2**24 samples a bin in any order."""
    counts: torch.Tensor  # f32 (bins,)


def _bin_scale(spec: MetricSpec) -> float:
    """The compiled reference's bin factor: f32(f32(1 / f32(hi - lo)) *
    bins), one f32 product in place of the division and the product."""
    inv = np.float32(1.0) / np.float32(spec.hi - spec.lo)
    return float(np.float32(inv * np.float32(spec.bins)))


def _init(spec: MetricSpec, sd, device) -> Any:
    """Fresh reducer state for a metric of `sd`'s shape and dtype."""
    shape, dtype = tuple(sd.shape), sd.dtype
    r = spec.reducer

    def full(v, dt, sh=shape):
        return torch.full(sh, v, dtype=dt, device=device)

    if r == "last":
        return full(0, dtype)
    if r == "sum":
        return full(0.0, torch.float32)
    if r in ("mean", "std"):
        return Welford(n=full(0.0, torch.float32),
                       mean=full(0.0, torch.float32),
                       m2=full(0.0, torch.float32))
    if r == "max":
        if dtype.is_floating_point:
            return full(-float("inf"), dtype)
        if dtype == torch.bool:
            return full(0, torch.int32)
        return full(torch.iinfo(dtype).min, dtype)
    if r == "count":
        return full(0, torch.int32)
    if r in QUANTILE_REDUCERS:
        return Hist(counts=full(0.0, torch.float32, (spec.bins,)))
    # ring
    return Ring(buf=full(0, dtype, (spec.cap,) + shape),
                n=full(0, torch.int32, ()))


def _update(spec: MetricSpec, st, v: torch.Tensor, round_idx: int):
    """Fold one round's value into the reducer state."""
    r = spec.reducer
    if r == "last":
        return v
    if r == "sum":
        return st + v.to(torch.float32)
    if r in ("mean", "std"):
        x = v.to(torch.float32)
        n = st.n + 1.0
        d = x - st.mean
        mean = st.mean + d / n
        return Welford(n=n, mean=mean, m2=st.m2 + d * (x - mean))
    if r == "max":
        return torch.maximum(st, v.to(st.dtype))
    if r == "count":
        return st + (v != 0).to(torch.int32)
    if r in QUANTILE_REDUCERS:
        # every element is one sample; out-of-range clips into end bins
        x = v.to(torch.float32).reshape(-1)
        t = (x - spec.lo) * _bin_scale(spec)
        idx = torch.nan_to_num(t, nan=0.0).clamp(0, spec.bins - 1).to(torch.int32)
        return Hist(counts=st.counts.index_add(0, idx, torch.ones_like(x)))
    # ring: a host-side round index, so the off-stride rounds write nothing
    if round_idx % spec.every:
        return st
    # out of place, so a cell-batched carry folds under vmap too
    buf = torch.select_scatter(st.buf, v.to(st.buf.dtype), 0,
                               (round_idx // spec.every) % spec.cap)
    return Ring(buf=buf, n=st.n + 1)


def _finalize(spec: MetricSpec, st) -> Dict[str, torch.Tensor]:
    """Reducer state -> output tensor(s) under the spec's out_key."""
    r = spec.reducer
    if r == "mean":
        return {spec.out_key: st.mean}
    if r == "std":
        # the square root in f64 and rounded once: correctly rounded f32,
        # as XLA's (PyTorch's vectorised f32 sqrt on the CPU is not)
        var = st.m2.clamp_min(0.0) / st.n.clamp_min(1.0)
        return {spec.out_key: torch.sqrt(var.double()).float()}
    if r == "ring":
        return {spec.out_key: st.buf, spec.out_key + "/n": st.n}
    if r in QUANTILE_REDUCERS:
        # over the last axis, so (B, bins) counts of batched carries
        # finalize as well: the first bin whose cumulative count reaches
        # q·total
        q = QUANTILE_Q[r]
        c = torch.cumsum(st.counts, dim=-1)
        total = c[..., -1]
        i = (c < q * total[..., None]).sum(-1).clamp(0, spec.bins - 1)
        width = (spec.hi - spec.lo) / spec.bins
        val = spec.lo + (i.to(torch.float32) + 0.5) * width
        return {spec.out_key: torch.where(total > 0, val,
                                          torch.full_like(val, spec.lo))}
    return {spec.out_key: st}


def init_telemetry(cfg: TelemetryCfg, shapes: Dict[str, Any]) -> TelemetryCarry:
    """Fresh reducer carry for the metrics described by `shapes`: a
    metrics dict of tensors (the engine passes its first round's) or of
    anything with `shape`, `dtype` and `device`. Each state goes on its
    metric's device."""
    states: Dict[str, Any] = {}
    for spec in cfg.specs:
        if spec.metric not in shapes:
            raise KeyError(f"telemetry spec {spec.out_key!r}: metric "
                           f"{spec.metric!r} not in the round metrics "
                           f"dict ({sorted(shapes)})")
        if spec.state_key not in states:
            sd = shapes[spec.metric]
            states[spec.state_key] = _init(spec, sd, sd.device)
    return TelemetryCarry(reducers=states)


def update_telemetry(cfg: TelemetryCfg, carry: TelemetryCarry,
                     metrics: Dict[str, torch.Tensor],
                     round_idx: int) -> TelemetryCarry:
    """Fold one round's metrics dict into every reducer state."""
    states = dict(carry.reducers)
    done = set()
    for spec in cfg.specs:
        sk = spec.state_key
        if sk in done:
            continue  # mean/std share one Welford update
        done.add(sk)
        states[sk] = _update(spec, states[sk], metrics[spec.metric],
                             round_idx)
    return TelemetryCarry(reducers=states)


def finalize_telemetry(cfg: TelemetryCfg,
                       carry: TelemetryCarry) -> Dict[str, torch.Tensor]:
    """Drain the carry into `{out_key: tensor}` outputs. Elementwise in
    the reducer states, so (B, ...)-batched carries drain unchanged."""
    out: Dict[str, torch.Tensor] = {}
    for spec in cfg.specs:
        out.update(_finalize(spec, carry.reducers[spec.state_key]))
    return out
