"""Transformer blocks and layer stacks for the dense and MoE LLMs: prefill
and decode.

A "block" = pre-norm attention + pre-norm FFN (a GLU FFN, or the MoE of
`nn/moe` in a moe block), with optional gemma2 post-norms / softcaps /
alternating windows. Per-layer parameters are stacked along a leading
layer axis, as the reference's ``stack_init`` leaves them; where the
reference scans over that axis, the port runs a Python loop, so each
layer's window is a Python int (or None) — what the
flash-attention kernel takes.

Two execution modes per stack:
  * prefill — full-sequence forward that also emits per-layer KV caches;
    its attention is the flash-attention kernel on positions ``arange(S)``
  * decode  — one token against the stacked ring KV caches (written in
    place)
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchCfg
from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.nn import attention as attn
from repro_torch.nn import layers
from repro_torch.nn import moe as moe_lib

GLOBAL_WINDOW = 2**30   # the window a global layer attends with (d < 2**30)


# ------------------------------------------------------------------ FFN --

def ffn_init(gen: torch.Generator, cfg: ArchCfg, *, dtype):
    """The GLU FFN (silu or gelu gate); whisper's biased non-GLU FFN waits
    for the audio family."""
    D, F_ = cfg.d_model, cfg.d_ff
    return {"w_gate": layers.dense_init(gen, D, F_, bias=False, dtype=dtype),
            "w_up": layers.dense_init(gen, D, F_, bias=False, dtype=dtype),
            "w_down": layers.dense_init(gen, F_, D, bias=False, dtype=dtype)}


def ffn_apply(params, x: torch.Tensor, cfg: ArchCfg) -> torch.Tensor:
    act = F.silu if cfg.mlp_act == "silu" else layers.gelu_tanh
    g = layers.dense(params["w_gate"], x)
    u = layers.dense(params["w_up"], x)
    return layers.dense(params["w_down"], act(g) * u)


# ---------------------------------------------------------------- block --

def block_init(gen: torch.Generator, cfg: ArchCfg, *, use_moe: bool, dtype):
    """A block's parameters; a moe block holds "moe" in place of "ffn"."""
    p = {
        "ln1": layers.rmsnorm_init(gen, cfg.d_model, dtype),
        "attn": attn.mha_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd,
                              bias=cfg.qkv_bias, dtype=dtype),
        "ln2": layers.rmsnorm_init(gen, cfg.d_model, dtype),
    }
    if use_moe:
        p["moe"] = moe_lib.moe_init(gen, _moe_cfg(cfg), dtype=dtype)
    else:
        p["ffn"] = ffn_init(gen, cfg, dtype=dtype)
    if cfg.post_norm:
        p["post_ln1"] = layers.rmsnorm_init(gen, cfg.d_model, dtype)
        p["post_ln2"] = layers.rmsnorm_init(gen, cfg.d_model, dtype)
    return p


def _moe_cfg(cfg: ArchCfg) -> moe_lib.MoECfg:
    m = cfg.moe
    return moe_lib.MoECfg(cfg.d_model, cfg.d_ff, m.n_experts, m.top_k,
                          shared_d_ff=m.shared_d_ff)


def _norm(p, x, cfg: ArchCfg):
    return layers.rmsnorm(p, x, scale_plus_one=cfg.embed_scale)


def _ffn(p_l, h: torch.Tensor, cfg: ArchCfg, use_moe: bool) -> torch.Tensor:
    """The block's FFN on the normed h: the MoE (its aux dropped, as the
    reference's serving path drops it) or the GLU FFN."""
    if use_moe:
        return moe_lib.moe_forward(p_l["moe"], h, _moe_cfg(cfg))[0]
    return ffn_apply(p_l["ffn"], h, cfg)


def block_decode(params, x: torch.Tensor, cache: attn.KVCache, cfg: ArchCfg, *,
                 window: Optional[int], use_moe: bool = False):
    """One-token block step. x: (B, 1, D). Returns (x, cache)."""
    h = _norm(params["ln1"], x, cfg)
    a, cache = attn.self_attention_decode(
        params["attn"], h, cache, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        head_dim=cfg.hd, window=window, logit_softcap=cfg.attn_softcap,
        rope_theta=cfg.rope_theta)
    if cfg.post_norm:
        a = _norm(params["post_ln1"], a, cfg)
    x = x + a
    f = _ffn(params, _norm(params["ln2"], x, cfg), cfg, use_moe)
    if cfg.post_norm:
        f = _norm(params["post_ln2"], f, cfg)
    return x + f, cache


# ---------------------------------------------------------------- stack --

def layer_params(params, i: int):
    """Layer i's parameters: the stacked leaves indexed along axis 0."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in params.items()}


def n_layers_of(params) -> int:
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params.shape[0]


def stack_trees(trees):
    """Same-shaped trees → one tree whose leaves are stacked on axis 0."""
    if isinstance(trees[0], dict):
        return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def stack_init(gen: torch.Generator, cfg: ArchCfg, n_layers: int, *,
               use_moe: bool, dtype):
    """n_layers blocks, each leaf stacked along a leading layer axis."""
    return stack_trees([block_init(gen, cfg, use_moe=use_moe, dtype=dtype)
                   for _ in range(n_layers)])


def layer_windows(cfg: ArchCfg, n_layers: int) -> Optional[List[int]]:
    """Per-layer window sizes (0 = global). None if all-global."""
    if cfg.window is None:
        return None
    if cfg.alt_window:
        return [cfg.window if i % 2 == 0 else 0 for i in range(n_layers)]
    return [cfg.window] * n_layers


def _window_arg(w: Optional[int]) -> Optional[int]:
    """A layer's window -> the attention's window arg: 0 means global,
    attended as a window of 2**30 (the reference's d < window mask)."""
    if w is None:
        return None
    return w if w > 0 else GLOBAL_WINDOW


def stack_decode(params, x: torch.Tensor, caches: attn.KVCache, cfg: ArchCfg, *,
                 use_moe: bool = False, windows: Optional[List[int]]):
    """One-token decode through the L blocks with stacked ring caches
    (k/v/pos with a leading layer axis, a shared length), written in
    place."""
    n_layers = n_layers_of(params)
    for i in range(n_layers):
        cache_i = attn.KVCache(caches.k[i], caches.v[i], caches.pos[i],
                               caches.length)
        x, _ = block_decode(layer_params(params, i), x, cache_i, cfg,
                            window=None if windows is None else _window_arg(windows[i]),
                            use_moe=use_moe)
    return x, attn.KVCache(caches.k, caches.v, caches.pos, caches.length + 1)


def init_stack_cache(cfg: ArchCfg, n_layers: int, batch: int, s_max: int, *,
                     length: int, dtype=torch.bfloat16, device) -> attn.KVCache:
    """Stacked ring caches (layer-leading) of s_max slots in every layer."""
    one = attn.init_cache(batch, s_max, cfg.n_kv, cfg.hd, dtype, length=length,
                          device=device)
    k = one.k.new_zeros((n_layers,) + tuple(one.k.shape))
    pos = one.pos[None].repeat(n_layers, 1)
    return attn.KVCache(k, torch.zeros_like(k), pos, one.length)


def stack_prefill(params, x: torch.Tensor, cfg: ArchCfg, *, use_moe: bool = False,
                  windows: Optional[List[int]],
                  cache_dtype=torch.bfloat16):
    """Full-sequence forward that also emits stacked KV caches of S slots,
    in ``cache_dtype`` (bf16, as the reference, whatever the model's
    dtype). Attention is the flash-attention kernel (the plain version for
    tensors on the CPU)."""
    B, S, _ = x.shape
    n_layers = n_layers_of(params)
    pos = torch.arange(S, device=x.device)
    ks = x.new_empty((n_layers, B, S, cfg.n_kv, cfg.hd), dtype=cache_dtype)
    vs = torch.empty_like(ks)
    for i in range(n_layers):
        p_l = layer_params(params, i)
        hn = _norm(p_l["ln1"], x, cfg)
        q, k, v = attn.qkv(p_l["attn"], hn, cfg.n_heads, cfg.n_kv, cfg.hd)
        if cfg.rope_theta is not None:
            q = attn.rope(q, pos, theta=cfg.rope_theta)
            k = attn.rope(k, pos, theta=cfg.rope_theta)
        o = flash.flash_attention(
            q, k, v, causal=True,
            window=None if windows is None else _window_arg(windows[i]),
            softcap=cfg.attn_softcap)
        a = layers.dense(p_l["attn"]["wo"], o.reshape(B, S, cfg.n_heads * cfg.hd))
        if cfg.post_norm:
            a = _norm(p_l["post_ln1"], a, cfg)
        x = x + a
        f = _ffn(p_l, _norm(p_l["ln2"], x, cfg), cfg, use_moe)
        if cfg.post_norm:
            f = _norm(p_l["post_ln2"], f, cfg)
        x = x + f
        ks[i] = k     # cast to cache_dtype on the copy
        vs[i] = v
    poss = torch.arange(S, dtype=torch.int32, device=x.device)[None].repeat(n_layers, 1)
    return x, attn.KVCache(ks, vs, poss, S)
