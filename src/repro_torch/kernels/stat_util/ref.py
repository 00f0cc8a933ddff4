"""Plain PyTorch version of the statistical-utility kernel."""
from __future__ import annotations

import torch


def stat_utility(losses: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """losses (S, n) per-sample losses, sizes (S,) |B_i| -> (S,) f32
    |B_i|·sqrt(max(mean_k loss², 0)), squared and averaged in f32."""
    msq = (losses.float() ** 2).mean(-1)
    return sizes.float() * torch.sqrt(msq.clamp_min(0.0))
