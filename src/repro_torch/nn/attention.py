"""GQA attention with RoPE, sliding windows, logit soft-capping, KV caches.

Layout: activations (B, S, D); heads (B, S, H, hd), as in the reference.

Two execution paths, as in the reference:
  * ``attend`` — plain PyTorch attention with query and key positions, a
    validity length and the reference's dtype rule, in one block. It
    serves decode against the ring cache (one query, the cache's own
    positions), which the reference also computes outside any kernel.
  * ``repro_torch.kernels.flash_attention.ops.flash_attention`` — the
    hand-written CUDA kernel (positions ``arange``), which prefill calls.

GQA is computed without materialising repeated KV heads: q is reshaped to
(B, S, n_kv, group, hd) and contracted against (B, S_k, n_kv, hd).

The ring cache is updated in place (`cache_update_decode`): the caller's
cache tensors are written and returned, where the reference returns new
arrays. A full-width cache is a gigabyte; a copy per token would move it
twice.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.nn import layers

NEG_INF = -1e30


# ----------------------------------------------------------------- RoPE --

def rope(x: torch.Tensor, positions: torch.Tensor, *,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding in f32, cast back. x: (B, S, H, hd); positions:
    (B, S) or (S,)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device)
                      / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs          # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------- projections --

def mha_init(gen: torch.Generator, d_model: int, n_heads: int, n_kv: int,
             head_dim: int, *, bias: bool = False, dtype=torch.float32):
    return {
        "wq": layers.dense_init(gen, d_model, n_heads * head_dim, bias=bias, dtype=dtype),
        "wk": layers.dense_init(gen, d_model, n_kv * head_dim, bias=bias, dtype=dtype),
        "wv": layers.dense_init(gen, d_model, n_kv * head_dim, bias=bias, dtype=dtype),
        "wo": layers.dense_init(gen, n_heads * head_dim, d_model, bias=bias, dtype=dtype),
    }


def qkv(params, x: torch.Tensor, n_heads: int, n_kv: int, head_dim: int):
    B, S, _ = x.shape
    q = layers.dense(params["wq"], x).reshape(B, S, n_heads, head_dim)
    k = layers.dense(params["wk"], x).reshape(B, S, n_kv, head_dim)
    v = layers.dense(params["wv"], x).reshape(B, S, n_kv, head_dim)
    return q, k, v


# ----------------------------------------------------------- core attend --

def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    """(Sq, Sk) boolean keep-mask from position vectors."""
    d = q_pos[:, None].long() - k_pos[None, :].long()
    keep = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        keep &= d >= 0
    if window is not None:
        keep &= d < window
    return keep


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True,
           window: Optional[int] = None,
           logit_softcap: Optional[float] = None,
           q_positions: Optional[torch.Tensor] = None,
           k_positions: Optional[torch.Tensor] = None,
           kv_valid_len: Optional[int] = None) -> torch.Tensor:
    """GQA attention, the reference's XLA path in plain PyTorch.

    q: (B, Sq, H, hd); k, v: (B, Sk, n_kv, hd); positions 1-D. Returns
    (B, Sq, H, hd) in q's dtype. ``kv_valid_len`` masks out unwritten
    cache slots. Products run on operands in ``cdt`` (q's dtype if bf16 or
    f16, else f32) and sum in f32: the operands are upcast to f32, which
    is exact, so the f32 product equals the reference's low-precision
    product with f32 accumulation up to the order of the sum. One block:
    the reference chunks the queries, and decode has a single one."""
    B, Sq, H, hd = q.shape
    Sk, n_kv = k.shape[1], k.shape[2]
    G = H // n_kv
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(Sq, device=dev)
    if k_positions is None:
        k_positions = torch.arange(Sk, device=dev)
    q_positions = q_positions.reshape(-1).expand(Sq)
    k_positions = k_positions.reshape(-1).expand(Sk)

    cdt = q.dtype if q.dtype in (torch.bfloat16, torch.float16) else torch.float32
    qg = (q.reshape(B, Sq, n_kv, G, hd).float() * scale).to(cdt).float()
    kf = k.to(cdt).float()
    vf = v.to(cdt).float()

    s = torch.einsum("bcngh,bsnh->bncgs", qg, kf)
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    keep = _mask(q_positions, k_positions, causal=causal, window=window)
    if kv_valid_len is not None:
        keep &= (k_positions < kv_valid_len)[None, :]
    s = torch.where(keep[None, None, :, None, :], s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    denom = p.sum(-1, keepdim=True)
    out = torch.einsum("bncgs,bsnh->bcngh", p.to(cdt).float(), vf)
    out = out / denom.clamp_min(1e-30).transpose(1, 2).reshape(B, Sq, n_kv, G, 1)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


# ------------------------------------------------------------- KV cache --

POS_SENTINEL = (2**31 - 1) // 2   # unwritten-slot marker (int32 max // 2)


class KVCache(NamedTuple):
    """Ring-buffer KV cache.

    Slot capacity W may be < the logical sequence length. ``pos`` stores
    each slot's absolute position; unwritten slots hold POS_SENTINEL, which
    the causal mask (d = q_pos − k_pos ≥ 0) rejects. ``length`` is a Python
    int (the reference's int32 scalar): the tokens written so far.
    """

    k: torch.Tensor     # (B, W, n_kv, hd) — RoPE already applied at write
    v: torch.Tensor     # (B, W, n_kv, hd)
    pos: torch.Tensor   # (W,) int32 absolute positions (POS_SENTINEL = empty)
    length: int


def init_cache(batch: int, s_max: int, n_kv: int, head_dim: int,
               dtype=torch.bfloat16, *, length: int = 0, device) -> KVCache:
    """s_max zeroed slots; with `length`, a post-prefill cache whose slots
    hold the last s_max positions below `length`, the others empty."""
    k = torch.zeros((batch, s_max, n_kv, head_dim), dtype=dtype, device=device)
    pos = torch.arange(s_max, device=device) + max(0, length - s_max)
    pos = torch.where(pos < length, pos, POS_SENTINEL)
    return KVCache(k, torch.zeros_like(k), pos.to(torch.int32), int(length))


def cache_update_decode(cache: KVCache, k_new: torch.Tensor,
                        v_new: torch.Tensor) -> KVCache:
    """Write one token (B, 1, n_kv, hd) at ring slot length % W, in place;
    returns the cache with its length advanced."""
    idx = cache.length % cache.k.shape[1]
    cache.k[:, idx] = k_new[:, 0]
    cache.v[:, idx] = v_new[:, 0]
    cache.pos[idx] = cache.length
    return KVCache(cache.k, cache.v, cache.pos, cache.length + 1)


# ------------------------------------------------------- full layer apply --

def self_attention_decode(params, x: torch.Tensor, cache: KVCache, *,
                          n_heads: int, n_kv: int, head_dim: int,
                          window: Optional[int] = None,
                          logit_softcap: Optional[float] = None,
                          rope_theta: Optional[float] = 10000.0):
    """One-token decode. x: (B, 1, D). Returns (out, cache), the cache
    written in place.

    Causality and validity fall out of the ring cache's ``pos``: empty
    slots carry POS_SENTINEL ≫ q_pos, so the causal mask drops them."""
    B = x.shape[0]
    q, k, v = qkv(params, x, n_heads, n_kv, head_dim)
    pos = torch.full((1,), cache.length, dtype=torch.int32, device=x.device)
    if rope_theta is not None:
        q = rope(q, pos, theta=rope_theta)
        k = rope(k, pos, theta=rope_theta)
    new_cache = cache_update_decode(cache, k, v)
    o = attend(q, new_cache.k, new_cache.v, causal=True, window=window,
               logit_softcap=logit_softcap, q_positions=pos,
               k_positions=new_cache.pos)
    return (layers.dense(params["wo"], o.reshape(B, 1, n_heads * head_dim)),
            new_cache)
