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

Every mechanism has two flavours with one ranking semantics:

  static k / ε — `top_k_select` / `epsilon_greedy`: k and ε are Python
                 values (the per-method round).
  traced ε     — `epsilon_greedy_traced`: ε is a 0-d tensor
                 (`core.methods.MethodParams.exploration`), so one
                 selection serves every cell of a campaign grid under
                 `torch.func.vmap`; masks are bitwise the static
                 version's at equal ε. The `_fused` forms emit the first
                 k of a static k_cap ranked candidates instead of a rank
                 array: the same masks.
"""
from __future__ import annotations

import torch

NEG = -1e30


# f64 stand-ins that order -0 below +0, -inf above NaN: no f32 value lies
# strictly between -DBL_MIN (the smallest normal f64) and 0, nor below
# -DBL_MAX
_DBL_MIN, _DBL_MAX = 2.2250738585072014e-308, 1.7976931348623157e308


def desc_order(values: torch.Tensor) -> torch.Tensor:
    """Indices of f32 `values` in descending IEEE total order, every NaN
    last, equal values in ascending index order: a stable descending sort
    of an f64 key equal to the value, except -0 (just below +0), -inf
    (-DBL_MAX) and NaN (-inf). Arithmetic only (no reinterpretation of
    the bits), so it runs under `torch.func.vmap`."""
    v = values.float()
    key = v.double()
    key = torch.where((v == 0) & torch.signbit(v), -_DBL_MIN, key)
    key = torch.where(v == -torch.inf, -_DBL_MAX, key)
    key = torch.where(v.isnan(), -torch.inf, key)
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


# ------------------------------------------------ traced ε (MethodParams)

def _desc_rank(scores: torch.Tensor) -> torch.Tensor:
    """rank[i]: device i's position in `desc_order(scores)` (out of
    place, so it runs under vmap)."""
    order = desc_order(scores)
    S = scores.shape[-1]
    ar = torch.arange(S, dtype=torch.int32, device=scores.device)
    return torch.zeros_like(ar).scatter(0, order, ar)


def top_k_select_traced(utils: torch.Tensor, k: torch.Tensor,
                        available: torch.Tensor) -> torch.Tensor:
    """`top_k_select` with a tensor k: the available devices whose rank
    (unavailable ones masked to NEG) is below k; the static version's
    mask for any 0 ≤ k ≤ S."""
    masked = torch.where(available, utils, NEG)
    return (_desc_rank(masked) < k) & available


def _explore_slots_traced(eps: torch.Tensor, k: int) -> torch.Tensor:
    """`_explore_slots` for a tensor ε: round-half-even of the f32
    product ε·k (as the reference's `jnp.round`), clipped to [0, k], at
    least one slot for any positive ε and none for ε ≤ 0."""
    q = torch.round(eps * k).to(torch.int32).clamp(0, k)
    return torch.where(eps > 0, q.clamp_min(1), 0)


def epsilon_greedy_traced(u: torch.Tensor, utils: torch.Tensor, k: int,
                          available: torch.Tensor,
                          eps: torch.Tensor) -> torch.Tensor:
    """`epsilon_greedy` with a tensor ε (static k): both sub-selections
    rank in rank space; the explore half ranks the uniform draw `u`."""
    k = min(k, available.shape[-1])
    if k <= 0:
        return torch.zeros_like(available)
    k_explore = _explore_slots_traced(eps, k)
    sel_x = top_k_select_traced(utils, k - k_explore, available)
    sel_r = top_k_select_traced(u, k_explore, available & ~sel_x)
    return sel_x | sel_r


def topk_rank_mask(scores: torch.Tensor, k_live: torch.Tensor,
                   k_cap: int) -> torch.Tensor:
    """Mask of the first `k_live` of the `k_cap` best-ranked devices:
    `_desc_rank(scores) < k_live` for 0 ≤ k_live ≤ k_cap, without a rank
    array. Dead candidates scatter to the extra index S, sliced off."""
    S = scores.shape[-1]
    if k_cap <= 0:
        return torch.zeros(S, dtype=torch.bool, device=scores.device)
    idx = desc_order(scores)[:k_cap]
    live = torch.arange(idx.shape[-1], device=scores.device) < k_live
    m = torch.zeros(S + 1, dtype=torch.bool, device=scores.device)
    return m.index_fill(0, torch.where(live, idx, S), True)[:S]


def top_k_select_traced_fused(utils: torch.Tensor, k: torch.Tensor,
                              available: torch.Tensor,
                              k_cap: int) -> torch.Tensor:
    """`top_k_select_traced` by the fused emission, for 0 ≤ k ≤ k_cap."""
    masked = torch.where(available, utils, NEG)
    return topk_rank_mask(masked, k, k_cap) & available


def epsilon_greedy_traced_fused(u: torch.Tensor, utils: torch.Tensor, k: int,
                                available: torch.Tensor,
                                eps: torch.Tensor) -> torch.Tensor:
    """`epsilon_greedy_traced` with both rank queries by the fused
    emission (k_cap = k bounds both quotas): the same masks."""
    k = min(k, available.shape[-1])
    if k <= 0:
        return torch.zeros_like(available)
    k_explore = _explore_slots_traced(eps, k)
    sel_x = top_k_select_traced_fused(utils, k - k_explore, available, k)
    sel_r = top_k_select_traced_fused(u, k_explore, available & ~sel_x, k)
    return sel_x | sel_r
