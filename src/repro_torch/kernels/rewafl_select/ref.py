"""Plain PyTorch version of the fused REWAFL selection kernel.

Same function as `csrc/rewafl_select.cu`, computed the unfused way:
materialise the (S,) Eqn-2 utility (`core.utility`, op for op), rank it
with a stable descending sort, and resolve the ε-greedy explore slots
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

NEG = -1e30       # masking value for unavailable devices
LIVE_THR = -1e29  # candidate values above this came from an available device


def _ranked(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """First k (value, index) pairs in (value desc, index asc) order."""
    v, i = torch.sort(values, descending=True, stable=True)
    return v[:k], i[:k]


def select_topk(available: torch.Tensor, ui: util.UtilityInputs,
                rnd: Optional[torch.Tensor], *, k_exploit: int, k_explore: int,
                T_round: float, alpha: float, beta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """((K,) int32 idx, (K,) int32 live), K = k_exploit + k_explore ≤ S.
    `rnd` (the ε-greedy uniform draw) is read only when k_explore > 0."""
    utils = torch.where(available, util.rewafl_utility_from(
        ui, T_round=T_round, alpha=alpha, beta=beta), NEG)
    xv, xi = _ranked(utils, k_exploit)
    x_live = xv > LIVE_THR
    idx, live = [torch.where(x_live, xi, 0)], [x_live]
    if k_explore > 0:
        rv, ri = _ranked(torch.where(available, rnd, NEG), k_exploit + k_explore)
        taken = ((ri[:, None] == xi[None, :]) & x_live[None, :]).any(1)
        pick = (rv > LIVE_THR) & ~taken
        # the first k_explore picked candidates, in rank order
        order = torch.sort((~pick).to(torch.uint8), stable=True).indices[:k_explore]
        r_live = pick[order]
        idx.append(torch.where(r_live, ri[order], 0))
        live.append(r_live)
    return (torch.cat(idx).to(torch.int32), torch.cat(live).to(torch.int32))
