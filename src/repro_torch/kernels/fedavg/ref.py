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
