"""Resilience half of the chaos layer: round deadlines + robust screen.

The port of `repro.core.resilience`. `sim.faults` injects failures; this
module keeps them from hurting the global model:

  deadline  — a per-round wall-clock cutoff (`ResilienceCfg.deadline_s`):
              participants whose (possibly straggler-inflated) round
              time exceeds it are cut from aggregation, and the FedAvg
              weights renormalise over the survivors. The cut device
              still spent its round energy. In async mode the
              counterpart is the slot TTL (`core.async_agg.AsyncCfg.ttl`).

  screen    — before any update lands, its delta norm is checked against
              the cohort. Non-finite deltas and norm outliers (norm >
              `norm_mult` × the masked median of the cohort's finite
              candidate norms) are rejected: their FedAvg weight is
              zeroed and their rows replaced by θ, so a NaN cannot reach
              the aggregation kernel (0 · NaN = NaN would poison the
              sum). Known limit, kept from the reference: the median is
              an anchor only while honest updates are a majority — a
              cohort mostly corrupted can shift it and a blow-up then
              passes (the non-finite rejection holds regardless).

The screen turns on by itself when the scenario injects faults
(`screen="auto"`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

SCREEN_MODES = ("auto", "on", "off")


@dataclasses.dataclass(frozen=True)
class ResilienceCfg:
    """Static resilience knobs, attached to `core.round.FLConfig`.

    deadline_s — sync-round straggler cutoff in seconds (None = none).
                 Applies to the dispatch cohort in async mode too (a cut
                 update is never pushed).
    screen     — "auto": screen iff the scenario injects faults;
                 "on"/"off": force.
    norm_mult  — outlier threshold: reject deltas with
                 ‖Δ‖ > norm_mult · median(candidate finite ‖Δ‖).
    """
    deadline_s: Optional[float] = None
    screen: str = "auto"
    norm_mult: float = 10.0

    def __post_init__(self):
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {self.deadline_s}")
        if self.screen not in SCREEN_MODES:
            raise ValueError(f"screen must be one of {SCREEN_MODES}, "
                             f"got {self.screen!r}")
        if self.norm_mult <= 1.0:
            raise ValueError(f"norm_mult must be > 1, got {self.norm_mult}")

    def screen_on(self, faults_enabled: bool) -> bool:
        """Resolution of the "auto" mode."""
        if self.screen == "auto":
            return faults_enabled
        return self.screen == "on"


def delta_norms(global_flat: torch.Tensor, client: torch.Tensor) -> torch.Tensor:
    """(K,) L2 norms of the cohort's update deltas θ_k − θ, one sum over
    each flat row (the reference sums each leaf, then the leaves: the
    same terms in another order)."""
    d = (client - global_flat).float()
    return (d * d).sum(1).sqrt()


def masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of `values[mask]` with static shapes: sort with +inf fill
    and take the ((count − 1) // 2)-th element; 0 when the mask is empty."""
    srt = torch.sort(torch.where(mask, values, torch.inf)).values
    cnt = mask.sum()
    med = srt.gather(0, ((cnt - 1) // 2).clamp_min(0).view(1))[0]
    return torch.where(cnt > 0, med, 0.0)


def screen_updates(global_flat: torch.Tensor, client: torch.Tensor,
                   weights: torch.Tensor, *, norm_mult: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reject non-finite and norm-outlier cohort updates before they land.

    weights: (K,) FedAvg weights; a 0 marks a slot already excluded (dead
    pad, non-participant, aborted, lost or cut device), which is never a
    candidate and so never a rejection. Returns (clean (K, P) cohort with
    rejected rows replaced by θ, weights with rejected slots zeroed,
    reject_k (K,) bool)."""
    norm = delta_norms(global_flat, client)
    cand = weights > 0
    finite = torch.isfinite(norm)
    med = masked_median(norm, cand & finite)
    outlier = norm > norm_mult * med.clamp_min(1e-12)
    reject = cand & (~finite | outlier)
    new_w = torch.where(reject, 0.0, weights)
    clean = torch.where(reject[:, None], global_flat.to(client.dtype), client)
    return clean, new_w, reject
