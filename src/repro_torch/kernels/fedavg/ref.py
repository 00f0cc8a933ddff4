"""Plain PyTorch version of the weighted FedAvg aggregation kernel."""
from __future__ import annotations

import torch


def weighted_aggregate(stack: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """out = Σ_k w_k · stack[k] for stack (K, ...) f32 or bf16, weights
    (K,); f32 accumulation, output in the stack's dtype — the kernel's
    arithmetic (a weighted sum over K), not a matrix-product call."""
    w = weights.float().reshape((-1,) + (1,) * (stack.dim() - 1))
    return (stack.float() * w).sum(0).to(stack.dtype)


def weighted_aggregate_batched(stack: torch.Tensor,
                               weights: torch.Tensor) -> torch.Tensor:
    """out[c] = Σ_k w[c, k] · stack[c, k] for stack (C, K, ...), weights
    (C, K): `weighted_aggregate` of each cell, so bitwise its results."""
    return torch.stack([weighted_aggregate(s, w) for s, w in zip(stack, weights)])


def weighted_aggregate_indexed(stack: torch.Tensor, idx: torch.Tensor,
                               live: torch.Tensor, weights: torch.Tensor
                               ) -> torch.Tensor:
    """The FedAvg of the K rows `idx` of an (S, ...) stack, f32: the
    rows' weights times their live flags (a dead slot is row 0 at weight
    0), normalised by max(Σ, 1e-9), then Σ_k wn_k · stack[idx_k] cast to
    f32 — op for op the reference's fused `select_aggregate` after its
    selection. Returns an f32 tensor of the stack's row shape."""
    rows = idx.long()
    w = weights[rows].float() * (live > 0)
    wn = w / w.sum().clamp_min(1e-9)
    return weighted_aggregate(stack[rows].float(), wn)
