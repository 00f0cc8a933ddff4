"""Fleet-health monitors: flat batteries, staleness tails, fairness.

The port of `repro.obs.health`. REWAFL's central claim is that
residual-energy-aware selection avoids flat batteries while keeping the
wall clock to accuracy low, but a fleet mean hides the devices that
matter. These monitors watch the tails:

  flat-battery counter      devices at/below the depletion floor
                            (residual energy <= the e0 reserve)
  near-depletion watermark  devices within `near_margin` × reserve of
                            the floor
  selection-count Gini      inequality of per-device selection counts
                            (0: every device selected equally; -> 1: a
                            few devices do all the work)
  staleness / energy tails  P50/P95 over every (round, device) sample,
                            from the `core.metrics` histogram reducers
                            of a streaming run; a dense run reads the
                            end state's exact percentiles instead

`launch.engine.run_rounds(health=HealthCfg(...))` samples them at chunk
boundaries, logs each violated threshold as a WARNING through
`repro_torch.obs.log`, and returns a `HealthReport` in
`EngineResult.health` / `RunResult.health`; `run_fl --health-strict`
turns a failing report into exit code 3. The monitors read the state to
the host at chunk boundaries only.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.metrics import MetricSpec, TelemetryCfg

# The per-round chaos counters (sim.faults, core.resilience, the async
# slot TTL): whichever the run's gates emitted are totalled into
# HealthReport.metrics as `<name>_total`. Report-only: injected faults
# are the experiment, not a fleet malfunction, so they never flip `ok`.
FAULT_COUNTERS = ("n_aborted", "n_lost", "n_corrupted", "n_straggler",
                  "n_deadline_cut", "n_rejected", "n_retried", "n_expired")


def _host(x, dtype=np.float64) -> np.ndarray:
    """A tensor (on any device) or array as a host array of `dtype`."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def gini(counts) -> float:
    """Gini coefficient of a non-negative count vector (0 = perfectly
    even, -> 1 = maximally concentrated). All-zero counts -> 0."""
    x = np.sort(_host(counts))
    n = x.size
    total = x.sum()
    if n == 0 or total <= 0:
        return 0.0
    i = np.arange(1, n + 1, dtype=np.float64)
    return float(((2.0 * i - n - 1.0) * x).sum() / (n * total))


@dataclasses.dataclass(frozen=True)
class HealthCfg:
    """Fleet-health thresholds.

    A device is *flat* when its residual energy is at/below the depletion
    floor `e0_reserve`, and *near depletion* when within
    `near_margin × e0_reserve` above it. Fractions are of the fleet size
    S. `None` turns a check off."""
    max_flat_frac: Optional[float] = 0.10     # flat devices / S
    max_near_frac: Optional[float] = 0.50     # near-depletion devices / S
    max_gini: Optional[float] = 0.85          # selection-count Gini
    max_staleness_p95: Optional[float] = None  # rounds (None: report only)
    near_margin: float = 0.5
    # bin count of the streaming quantile histograms (core.metrics
    # "p50"/"p95") of staleness and residual energy
    quantile_bins: int = 64

    def quantile_specs(self, rounds: int,
                       energy_hi: float) -> Tuple[MetricSpec, ...]:
        """The streaming P50/P95 specs the monitors read: staleness
        binned over [0, rounds], residual energy over [0, energy_hi]
        (the fleet's largest initial battery)."""
        hi_r = float(max(rounds, 1))
        hi_e = float(max(energy_hi, 1e-9))
        b = self.quantile_bins
        return (MetricSpec("staleness", "p50", bins=b, lo=0.0, hi=hi_r),
                MetricSpec("staleness", "p95", bins=b, lo=0.0, hi=hi_r),
                MetricSpec("residual_energy", "p50", bins=b, lo=0.0,
                           hi=hi_e),
                MetricSpec("residual_energy", "p95", bins=b, lo=0.0,
                           hi=hi_e))


def with_health_specs(tcfg: TelemetryCfg, cfg: HealthCfg, rounds: int,
                      fleet) -> TelemetryCfg:
    """Extend a streaming TelemetryCfg with the health quantile specs
    (skipping any out_key the caller already declared)."""
    have = {s.out_key for s in tcfg.specs}
    energy_hi = float(np.max(_host(fleet.init_energy, np.float32)))
    extra = tuple(s for s in cfg.quantile_specs(rounds, energy_hi)
                  if s.out_key not in have)
    if not extra:
        return tcfg
    return dataclasses.replace(tcfg, specs=tcfg.specs + extra)


def chunk_sample(cfg: HealthCfg, state, fleet,
                 round_idx: int) -> Tuple[Dict[str, float], List[str]]:
    """One chunk-boundary health sample from the live FleetState.

    Copies only the (S,) leaves the monitors need to the host (a sync on
    the chunk just run, like the accuracy eval). Returns (sample,
    warnings): the sample dict, and a warning string for each threshold
    the fleet now violates."""
    energy = _host(state.residual_energy)
    reserve = _host(fleet.e0_reserve)
    S = energy.size
    flat = energy <= reserve
    near = ~flat & (energy <= reserve * (1.0 + cfg.near_margin))
    n_dropped = int(_host(state.dropped, bool).sum())
    sample = {
        "round": int(round_idx),
        "flat_battery": int(flat.sum()),
        "flat_frac": float(flat.sum()) / max(S, 1),
        "near_depletion": int(near.sum()),
        "near_frac": float(near.sum()) / max(S, 1),
        "n_dropped": n_dropped,
    }
    warnings: List[str] = []
    if (cfg.max_flat_frac is not None
            and sample["flat_frac"] > cfg.max_flat_frac):
        warnings.append(
            f"health[r={round_idx}]: flat-battery alarm — "
            f"{sample['flat_battery']}/{S} devices "
            f"({sample['flat_frac']:.1%}) at/below the depletion floor "
            f"(threshold {cfg.max_flat_frac:.1%})")
    if (cfg.max_near_frac is not None
            and sample["near_frac"] > cfg.max_near_frac):
        warnings.append(
            f"health[r={round_idx}]: near-depletion watermark — "
            f"{sample['near_depletion']}/{S} devices "
            f"({sample['near_frac']:.1%}) within "
            f"{cfg.near_margin:.0%} of the floor "
            f"(threshold {cfg.max_near_frac:.1%})")
    return sample, warnings


@dataclasses.dataclass
class HealthReport:
    """End-of-run fleet-health verdict: `ok` is False when any chunk
    boundary or final check tripped a `HealthCfg` threshold. `metrics`
    holds the final monitor values (flat/near counts, selection Gini,
    staleness / residual-energy P50/P95, fault totals); `samples` the
    chunk-boundary trajectory."""
    ok: bool
    warnings: List[str]
    metrics: Dict[str, float]
    samples: List[Dict[str, float]]

    def to_json(self) -> Dict:
        return {"ok": self.ok, "warnings": list(self.warnings),
                "metrics": dict(self.metrics),
                "samples": [dict(s) for s in self.samples]}


def finalize_report(cfg: HealthCfg, samples: List[Dict[str, float]],
                    warnings: List[str], *, state, fleet,
                    telemetry: Optional[Dict] = None,
                    rounds_run: int = 0,
                    history: Optional[Dict] = None) -> HealthReport:
    """Fold the chunk-boundary samples and the final state into a
    HealthReport.

    Staleness / residual-energy quantiles come from the streaming
    reducers' outputs (`tel/<metric>/p50|p95`, every (round, device)
    sample of the run) when present; a dense run falls back to the exact
    end-state percentiles of `state.u` / `state.residual_energy`. A
    `history` of per-round scalars adds whole-run `FAULT_COUNTERS` totals
    to `metrics` (report-only, never a threshold)."""
    warnings = list(warnings)
    metrics: Dict[str, float] = {}
    if samples:
        last = samples[-1]
        for k in ("flat_battery", "flat_frac", "near_depletion",
                  "near_frac", "n_dropped"):
            metrics[k] = last[k]
    metrics["sel_gini"] = gini(state.n_selected)
    if cfg.max_gini is not None and metrics["sel_gini"] > cfg.max_gini:
        warnings.append(
            f"health[final]: selection-count Gini "
            f"{metrics['sel_gini']:.3f} exceeds {cfg.max_gini:.3f} — "
            f"selection is concentrating on few devices (staleness risk)")
    tel = telemetry or {}
    for metric, leaf in (("staleness", state.u),
                         ("residual_energy", state.residual_energy)):
        arr = _host(leaf)
        for q, qk in ((50, "p50"), (95, "p95")):
            key = f"tel/{metric}/{qk}"
            if key in tel:  # streaming: the whole run's sample quantile
                metrics[f"{metric}_{qk}"] = float(_host(tel[key]))
            elif rounds_run:  # dense: exact end-state percentile
                metrics[f"{metric}_{qk}"] = float(np.percentile(arr, q))
    for k in FAULT_COUNTERS:
        if history is not None and k in history:
            metrics[f"{k}_total"] = float(np.sum(_host(history[k])))
    p95 = metrics.get("staleness_p95")
    if (cfg.max_staleness_p95 is not None and p95 is not None
            and p95 > cfg.max_staleness_p95):
        warnings.append(
            f"health[final]: staleness P95 {p95:.1f} rounds exceeds "
            f"{cfg.max_staleness_p95:.1f}")
    return HealthReport(ok=not warnings, warnings=warnings,
                        metrics=metrics, samples=samples)


def format_health_table(report: HealthReport) -> str:
    """Fixed-width terminal summary of a HealthReport."""
    lines = [f"fleet health: {'OK' if report.ok else 'ALARM'}"]
    w = max((len(k) for k in report.metrics), default=6)
    for k in sorted(report.metrics):
        v = report.metrics[k]
        if isinstance(v, float) and not float(v).is_integer():
            lines.append(f"  {k:<{w}}  {v:.4f}")
        else:
            lines.append(f"  {k:<{w}}  {v:g}")
    for msg in report.warnings:
        lines.append(f"  ! {msg}")
    return "\n".join(lines)
