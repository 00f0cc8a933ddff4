"""Participant selection: top-K ranking + baseline selection mechanisms.

Ranking semantics match `repro.core.selection`'s `lax.top_k`: descending
in the IEEE total order (+0 above -0), ties between equal values broken
toward the lower device index. A NaN of either sign ranks below every
number, where `lax.top_k` puts the negative NaN that x86 arithmetic makes
(it would put a positive one first: which sign a NaN carries depends on
each library's ops, so the port does not follow it). That is a stable
descending `torch.sort` of an integer key of the bits (`desc_order`),
never `torch.topk`, which promises no order among ties, nor a sort of the
floats, which puts every NaN first and ties ±0. The random draws are
arguments (the round's `RoundNoise`), not drawn here.
"""
from __future__ import annotations

import torch

NEG = -1e30


def desc_order(values: torch.Tensor) -> torch.Tensor:
    """Indices of f32 `values` in descending IEEE total order, every NaN
    last, equal keys in ascending index order: the bits as int32, with a
    negative float's lower 31 bits flipped, sort as the floats do."""
    b = values.float().view(torch.int32)
    key = torch.where(values.isnan(), torch.iinfo(torch.int32).min,
                      b ^ ((b >> 31) & 0x7FFFFFFF))
    return torch.sort(key, descending=True, stable=True).indices


def top_k_select(utils: torch.Tensor, k: int,
                 available: torch.Tensor) -> torch.Tensor:
    """Boolean (S,) mask of the top-k available devices (Algorithm 1,
    line 15: RankingDevice). k beyond the fleet size selects every
    available device."""
    k = min(k, utils.shape[-1])
    if k <= 0:
        return torch.zeros_like(available)
    idx = desc_order(torch.where(available, utils, NEG))[:k]
    sel = torch.zeros_like(available)
    sel[idx] = True
    return sel & available


def random_select(u: torch.Tensor, k: int, available: torch.Tensor) -> torch.Tensor:
    """Uniform-random K among available devices, ranked by the uniform
    draw `u` (S,)."""
    return top_k_select(u, k, available)


def _explore_slots(eps: float, k: int) -> int:
    """ε-greedy exploration quota: round(ε·K), at least one slot for any
    positive ε and exactly zero for ε ≤ 0."""
    if eps <= 0:
        return 0
    return min(k, max(1, int(round(eps * k))))


def epsilon_greedy(u: torch.Tensor, utils: torch.Tensor, k: int,
                   available: torch.Tensor, eps: float = 0.1) -> torch.Tensor:
    """Oort's exploit/explore split: (1−ε)K by utility, εK by the uniform
    draw `u` among the rest."""
    k = min(k, available.shape[-1])
    if k <= 0:
        return torch.zeros_like(available)
    k_explore = _explore_slots(eps, k)
    sel_x = top_k_select(utils, k - k_explore, available)
    sel_r = random_select(u, k_explore, available & ~sel_x)
    return sel_x | sel_r


def temporal_uncertainty(stat: torch.Tensor, round_idx: int,
                         last_round: torch.Tensor) -> torch.Tensor:
    """Oort's staleness bonus: a device's statistical utility inflated by
    sqrt(0.1·Δr), Δr the rounds since it last took part (never: since
    round 0), in f32."""
    dr = (round_idx - last_round.clamp_min(0)).clamp_min(0)
    return stat * (1.0 + torch.sqrt(0.1 * dr.float()))
