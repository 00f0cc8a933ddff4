"""REWA local computing policy — Eqns (3)–(4) — and its baselines.

Eqn (3): H(i,r) = ⌈H(i, r−u−1) + ψ(s(i,r))·ΔH⌉ when selected (V=1);
          unchanged otherwise. ψ(·) ≥ 0 and decreasing in the uplink rate.

Eqn (4): ε_i^r = |Loss(θ_i^{last}) − Loss(θ^{r−1})| · (E_i^{last} − E0)
                 / e_cp(i, last); stop growing H when ε < ε_th.

AdaH (REAFL+LUPA baseline, [23]): H(r) = ⌈H0 + Σ_{l≤r} ψ·ΔH⌉ — grows
every round for every device, selection-independent, no stopping.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.common import rdiv


@dataclasses.dataclass(frozen=True)
class PolicyCfg:
    H0: int = 5
    H_max: int = 30            # static loop bound for the masked local SGD
    dH: float = 2.0            # ΔH increment unit
    psi0: float = 1.0          # ψ scale
    s_ref: float = 20e6        # bps — rate normalisation in ψ
    psi_fixed: float = 0.3     # AdaH's constant ψ
    eps_th: float = 4.0        # ε threshold of Eqn (4)


def psi(rates: torch.Tensor, cfg: PolicyCfg) -> torch.Tensor:
    """Non-negative, decreasing in the transmission rate: fast uplinks get
    small H increments (their comm latency/energy is already low)."""
    return rdiv(cfg.psi0 * cfg.s_ref, cfg.s_ref + rates.clamp_min(0.0))


def stopping_eps(last_local_loss: torch.Tensor, global_loss: torch.Tensor,
                 last_energy: torch.Tensor, e0: torch.Tensor,
                 last_ecp: torch.Tensor) -> torch.Tensor:
    """Eqn (4)."""
    return (torch.abs(last_local_loss - global_loss)
            * (last_energy - e0).clamp_min(0.0)
            / last_ecp.clamp_min(1e-9))


def h_rewa(H: torch.Tensor, rates: torch.Tensor, eps: torch.Tensor,
           cfg: PolicyCfg) -> torch.Tensor:
    """Candidate H for this round under REWA (applied if selected):
    grow by ψ(s)·ΔH unless the energy-utility stopping criterion fires."""
    Hf = H.float()
    grown = torch.ceil(Hf + psi(rates, cfg) * cfg.dH)
    out = torch.where(eps >= cfg.eps_th, grown, Hf)
    return out.clamp(1, cfg.H_max).to(torch.int32)


def h_adah(round_idx: int, S: int, cfg: PolicyCfg, device) -> torch.Tensor:
    """AdaH [23]: selection-independent global schedule, in f32 like the
    reference."""
    r = torch.full((S,), float(round_idx), device=device)
    h = torch.ceil(cfg.H0 + (r + 1.0) * cfg.psi_fixed * cfg.dH)
    return h.clamp(1, cfg.H_max).to(torch.int32)


def h_fixed(S: int, cfg: PolicyCfg, device) -> torch.Tensor:
    return torch.full((S,), cfg.H0, dtype=torch.int32, device=device)
