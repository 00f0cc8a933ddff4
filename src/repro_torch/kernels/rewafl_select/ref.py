"""Plain PyTorch version of the fused REWAFL selection kernel.

Same function as `csrc/rewafl_select.cu`, computed the unfused way:
materialise the (S,) Eqn-2 utility (`core.utility`, op for op), rank it
in descending IEEE total order (`core.selection.desc_order`), and resolve the ε-greedy explore slots
from a second ranking of the uniform draw. It returns what the kernel
returns — (K,) device indices and live flags, exploit slots first, each
half in rank order, dead slots as (index 0, live 0) — so the two compare
bitwise on the card, and masks built from it equal the reference's
`select_ref` masks.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import utility as util
from repro_torch.core.selection import _explore_slots, desc_order

NEG = -1e30       # masking value for unavailable devices
# candidate values at or below this came from an unavailable device; a NaN
# utility (of an available device: ranked last) is live, as `lax.top_k`
# ranks and selects it
LIVE_THR = -1e29


def _ranked(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """First k (value, index) pairs in (value desc in the IEEE total order,
    index asc) order."""
    i = desc_order(values)[:k]
    return values[i], i


def select_topk(available: torch.Tensor, ui: util.UtilityInputs,
                rnd: Optional[torch.Tensor], *, k_exploit: int, k_explore: int,
                T_round: float, alpha: float, beta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """((K,) int32 idx, (K,) int32 live), K = k_exploit + k_explore ≤ S.
    `rnd` (the ε-greedy uniform draw) is read only when k_explore > 0."""
    utils = torch.where(available, util.rewafl_utility_from(
        ui, T_round=T_round, alpha=alpha, beta=beta), NEG)
    xv, xi = _ranked(utils, k_exploit)
    x_live = ~(xv <= LIVE_THR)
    idx, live = [torch.where(x_live, xi, 0)], [x_live]
    if k_explore > 0:
        rv, ri = _ranked(torch.where(available, rnd, NEG), k_exploit + k_explore)
        taken = ((ri[:, None] == xi[None, :]) & x_live[None, :]).any(1)
        pick = ~(rv <= LIVE_THR) & ~taken
        # the first k_explore picked candidates, in rank order
        order = torch.sort((~pick).to(torch.uint8), stable=True).indices[:k_explore]
        r_live = pick[order]
        idx.append(torch.where(r_live, ri[order], 0))
        live.append(r_live)
    return (torch.cat(idx).to(torch.int32), torch.cat(live).to(torch.int32))


def select_topk_batched(available: torch.Tensor, ui: util.UtilityInputs,
                        rnd: Optional[torch.Tensor], *, k_exploit: int,
                        k_explore: int, T_round: float, alpha: float,
                        beta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """`select_topk` of each of B selections over (B, S) leaves:
    ((B, K) idx, (B, K) live), bitwise the single selections'."""
    out = [select_topk(available[b], util.UtilityInputs(*(x[b] for x in ui)),
                       None if rnd is None else rnd[b], k_exploit=k_exploit,
                       k_explore=k_explore, T_round=T_round, alpha=alpha,
                       beta=beta) for b in range(available.shape[0])]
    return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])


def mask_from_slots(idx: torch.Tensor, live: torch.Tensor, S: int) -> torch.Tensor:
    """(S,) bool mask of the live slots. Dead slots scatter to the extra
    index S, which is sliced off. `index_fill` takes its value as a
    kernel argument, so the mask can be built inside a CUDA graph; it is
    out of place, so the mask can be built under `torch.func.vmap` too."""
    m = torch.zeros(S + 1, dtype=torch.bool, device=idx.device)
    return m.index_fill(0, torch.where(live > 0, idx, S).long(), True)[:S]


def select_aggregate(u: Optional[torch.Tensor], k: int, available: torch.Tensor,
                     eps: float, ui: util.UtilityInputs, deltas: torch.Tensor,
                     weights: torch.Tensor, *, T_round: float, alpha: float,
                     beta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `ops.select_aggregate`, the unfused way of the
    reference's `select_aggregate_ref`: the (S,) mask from `select_topk`,
    then a weighted sum over all S rows of `deltas` with the unselected
    weights zeroed and the rest normalised by max(Σw, 1e-9). Returns
    ((S,) bool mask, (P,) f32 aggregate)."""
    S = available.shape[-1]
    k_eff = min(k, S)
    mask = torch.zeros_like(available)
    if k_eff > 0:
        k_explore = _explore_slots(eps, k_eff)
        mask = mask_from_slots(*select_topk(
            available, ui, u, k_exploit=k_eff - k_explore, k_explore=k_explore,
            T_round=T_round, alpha=alpha, beta=beta), S)
    coef = torch.where(mask, weights, 0.0).float()
    wn = coef / coef.sum().clamp_min(1e-9)
    return mask, (deltas.float() * wn[:, None]).sum(0)
