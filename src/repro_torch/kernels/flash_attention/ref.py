"""Plain PyTorch version of the flash-attention kernel (GQA, causal,
sliding window, logit softcap). Materialises the full f32 scores — what a
CPU tensor runs, and what the kernel is held against on the card."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              logit_softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, n_kv, hd) -> (B, Sq, H, hd) in q's
    dtype. Query i sits at position i and key j at position j; query head
    h reads KV head h // (H / n_kv). Scores are scaled by 1/√hd."""
    B, Sq, H, hd = q.shape
    Sk, n_kv = k.shape[1], k.shape[2]
    G = H // n_kv
    kr = k.float().repeat_interleave(G, dim=2)
    vr = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * (1.0 / math.sqrt(hd))
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    d = (torch.arange(Sq, device=q.device)[:, None]
         - torch.arange(Sk, device=q.device)[None, :])
    keep = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        keep &= d >= 0
    if window is not None:
        keep &= d < window
    s = torch.where(keep, s, NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vr)
    return o.to(q.dtype)
