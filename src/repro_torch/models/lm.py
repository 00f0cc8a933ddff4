"""Decoder language models for serving: the dense family (llama /
deepseek / granite / gemma2), the vlm family's language tower, the moe
family (olmoe / kimi-k2), the ssm family (xlstm) and the hybrid family
(zamba2).

Per-family API (see ``repro_torch.models.api``), the reference's without
its sharding argument:
  init_params(gen, cfg)                   -> params (nested dict)
  prefill(params, batch, cfg)             -> (last_logits, state)
  decode_step(params, batch, state, cfg)  -> (logits, state)
  init_decode_state(cfg, batch, kv_len, *, device) -> state

Decode-state convention: a "KV cache of seq_len" holds seq_len−1 prior
tokens; decode_step writes token seq_len−1 (0-based) and attends the full
seq_len context. The dense state is a ring cache of KV slots, the moe
state a dict of them (one for the MoE stack, one for a dense prefix
stack), the xlstm state the recurrent states of every layer, the hybrid
state the Mamba2 caches of every layer and a ring cache for each
application of the shared attention block; decode_step writes each in
place and returns it.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.configs.base import ArchCfg
from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.nn import attention as attn
from repro_torch.nn import layers, ssm, xlstm
from repro_torch.nn import transformer as tf


def _dtype(cfg: ArchCfg):
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def _embed(params, tokens, cfg: ArchCfg):
    x = layers.embedding(params["embed"], tokens)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _final_logits(x_last: torch.Tensor, params, cfg: ArchCfg) -> torch.Tensor:
    """Tied readout against the embedding table, then the final softcap."""
    logits = x_last @ params["embed"]["table"].T
    return layers.softcap(logits, cfg.final_softcap)


# =================================================== dense / vlm families

def dense_init(gen: torch.Generator, cfg: ArchCfg):
    """Random parameters drawn from `gen` on its device, in the
    reference's tree: embed table (vocab, d), stacked layer leaves, final
    norm."""
    dt = _dtype(cfg)
    return {
        "embed": layers.embedding_init(gen, cfg.vocab, cfg.d_model, dtype=dt,
                                       scale=1.0 / math.sqrt(cfg.d_model)
                                       if cfg.embed_scale else None),
        "stack": tf.stack_init(gen, cfg, cfg.n_layers, use_moe=False, dtype=dt),
        "final_ln": layers.rmsnorm_init(gen, cfg.d_model, dt),
    }


def _vlm_concat(params, batch, cfg: ArchCfg):
    x_txt = _embed(params, batch["tokens"], cfg)
    img = batch["image_embeds"].to(x_txt.dtype)
    return torch.cat([img, x_txt], dim=1)


def dense_loss(params, batch, cfg: ArchCfg):
    raise NotImplementedError("dense training (dense_loss, chunked_ce) waits "
                              "for the training slice (ROADMAP A16)")


def dense_prefill(params, batch, cfg: ArchCfg):
    """Prefill the prompt (plus image embeddings for vlm). Returns the last
    position's logits (B, 1, V) and bf16 ring caches of S slots."""
    if cfg.family == "vlm":
        x = _vlm_concat(params, batch, cfg)
    else:
        x = _embed(params, batch["tokens"], cfg)
    windows = tf.layer_windows(cfg, cfg.n_layers)
    x, caches = tf.stack_prefill(params["stack"], x, cfg, use_moe=False,
                                 windows=windows)
    x = layers.rmsnorm(params["final_ln"], x[:, -1:, :],
                       scale_plus_one=cfg.embed_scale)
    return _final_logits(x, params, cfg), caches


def dense_init_decode_state(cfg: ArchCfg, batch: int, kv_len: int, *,
                            device="cuda"):
    """Empty stacked ring caches of kv_len slots in the model's dtype, with
    kv_len − 1 prior tokens, on `device` (the card unless asked)."""
    return tf.init_stack_cache(cfg, cfg.n_layers, batch, kv_len,
                               length=kv_len - 1, dtype=_dtype(cfg),
                               device=resolve_device(device))


def dense_decode_step(params, batch, state, cfg: ArchCfg):
    """One greedy-decode step: batch["tokens"] (B, 1) → logits (B, 1, V);
    the state's caches are written in place."""
    x = _embed(params, batch["tokens"], cfg)
    x, state = tf.stack_decode(params["stack"], x, state, cfg, use_moe=False,
                               windows=tf.layer_windows(cfg, cfg.n_layers))
    x = layers.rmsnorm(params["final_ln"], x, scale_plus_one=cfg.embed_scale)
    return _final_logits(x, params, cfg), state


# ============================================================ moe family
#
# A stack of MoE blocks ("moe_stack"), after a stack of dense blocks
# ("prefix_stack", kimi-k2's first layer) where the config has one.

def moe_init(gen: torch.Generator, cfg: ArchCfg):
    """Random parameters drawn from `gen` on its device, in the
    reference's tree (the routers f32 whatever the model's dtype)."""
    dt = _dtype(cfg)
    m = cfg.moe
    p = {
        "embed": layers.embedding_init(gen, cfg.vocab, cfg.d_model, dtype=dt),
        "moe_stack": tf.stack_init(gen, cfg, cfg.n_layers - m.n_dense_prefix,
                                   use_moe=True, dtype=dt),
        "final_ln": layers.rmsnorm_init(gen, cfg.d_model, dt),
    }
    if m.n_dense_prefix:
        p["prefix_stack"] = tf.stack_init(gen, cfg, m.n_dense_prefix,
                                          use_moe=False, dtype=dt)
    return p


def moe_loss(params, batch, cfg: ArchCfg):
    raise NotImplementedError("moe training (moe_loss, chunked_ce and the "
                              "router's auxiliaries) waits for the training "
                              "slice (ROADMAP A16)")


def moe_prefill(params, batch, cfg: ArchCfg):
    """Prefill the prompt. Returns the last position's logits (B, 1, V) and
    {"prefix": the dense prefix's caches or None, "moe": the MoE stack's},
    bf16 ring caches of S slots."""
    x = _embed(params, batch["tokens"], cfg)
    pre_caches = None
    if "prefix_stack" in params:
        x, pre_caches = tf.stack_prefill(params["prefix_stack"], x, cfg,
                                         use_moe=False, windows=None)
    x, caches = tf.stack_prefill(params["moe_stack"], x, cfg, use_moe=True,
                                 windows=None)
    x = layers.rmsnorm(params["final_ln"], x[:, -1:, :])
    return _final_logits(x, params, cfg), {"prefix": pre_caches, "moe": caches}


def moe_init_decode_state(cfg: ArchCfg, batch: int, kv_len: int, *,
                          device="cuda"):
    """Empty stacked ring caches of kv_len slots in the model's dtype, with
    kv_len − 1 prior tokens, on `device` (the card unless asked): "moe",
    and "prefix" where the config has a dense prefix."""
    dev = resolve_device(device)
    m = cfg.moe
    st = {"moe": tf.init_stack_cache(cfg, cfg.n_layers - m.n_dense_prefix, batch,
                                     kv_len, length=kv_len - 1, dtype=_dtype(cfg),
                                     device=dev)}
    if m.n_dense_prefix:
        st["prefix"] = tf.init_stack_cache(cfg, m.n_dense_prefix, batch, kv_len,
                                           length=kv_len - 1, dtype=_dtype(cfg),
                                           device=dev)
    return st


def moe_decode_step(params, batch, state, cfg: ArchCfg):
    """One greedy-decode step: batch["tokens"] (B, 1) → logits (B, 1, V);
    the state's caches are written in place."""
    x = _embed(params, batch["tokens"], cfg)
    new_state = dict(state)
    if "prefix_stack" in params:
        x, new_state["prefix"] = tf.stack_decode(params["prefix_stack"], x,
                                                 state["prefix"], cfg,
                                                 use_moe=False, windows=None)
    x, new_state["moe"] = tf.stack_decode(params["moe_stack"], x, state["moe"],
                                          cfg, use_moe=True, windows=None)
    x = layers.rmsnorm(params["final_ln"], x)
    return _final_logits(x, params, cfg), new_state


# ============================================================ ssm (xlstm)
#
# The layers come in G = n_layers / g groups of 1 sLSTM + (g − 1) mLSTM
# blocks, each a pre-norm residual block. Stacked leaves: slstm_stack
# (G, …), mlstm_stack_inner (G, g − 1, …); where the reference scans over
# them, the port loops.

def _xlstm_dims(cfg: ArchCfg):
    return (xlstm.mlstm_dims(cfg.d_model, cfg.n_heads),
            xlstm.slstm_dims(cfg.d_model, cfg.n_heads))


def _with_ln(gen: torch.Generator, core, cfg: ArchCfg, dt):
    return {"ln": layers.rmsnorm_init(gen, cfg.d_model, dt), "core": core}


def xlstm_init(gen: torch.Generator, cfg: ArchCfg):
    """Random parameters drawn from `gen` on its device, in the reference's
    tree."""
    dt = _dtype(cfg)
    md, sd = _xlstm_dims(cfg)
    g = cfg.slstm_group
    G = cfg.n_layers // g

    def mlstm_layer():
        return _with_ln(gen, xlstm.mlstm_init(gen, md, dtype=dt), cfg, dt)

    return {
        "embed": layers.embedding_init(gen, cfg.vocab, cfg.d_model, dtype=dt),
        "slstm_stack": tf.stack_trees([
            _with_ln(gen, xlstm.slstm_init(gen, sd, dtype=dt), cfg, dt)
            for _ in range(G)]),
        "mlstm_stack_inner": tf.stack_trees([
            tf.stack_trees([mlstm_layer() for _ in range(g - 1)]) for _ in range(G)]),
        "final_ln": layers.rmsnorm_init(gen, cfg.d_model, dt),
    }


def xlstm_loss(params, batch, cfg: ArchCfg):
    raise NotImplementedError("xlstm training waits for the training slice "
                              "(ROADMAP A16)")


def _xlstm_states(cfg: ArchCfg, batch: int, device):
    """Stacked initial states: sLSTM (G, B, NH, hd) leaves, mLSTM caches
    (G, g − 1, …) with zero conv buffers in the model's dtype."""
    md, sd = _xlstm_dims(cfg)
    g = cfg.slstm_group
    G = cfg.n_layers // g
    sst = xlstm.init_slstm_state(batch, sd, device=device)
    mst = xlstm.init_mlstm_cache(batch, md, _dtype(cfg), device=device)

    def rep(t, *lead):
        return t.expand(*lead, *t.shape).clone()
    return (xlstm.SLSTMState(*(rep(t, G) for t in sst)),
            xlstm.MLSTMCache(xlstm.MLSTMState(*(rep(t, G, g - 1) for t in mst.state)),
                             rep(mst.conv_buf, G, g - 1)))


def _xlstm_backbone(params, x, cfg: ArchCfg):
    """G × (1 sLSTM + (g − 1) mLSTM) from zero states. Returns (x after the
    final norm, (stacked sLSTM states, stacked mLSTM caches)), the caches'
    conv buffers zero."""
    md, sd = _xlstm_dims(cfg)
    sst, mst = _xlstm_states(cfg, x.shape[0], x.device)
    for gi in range(cfg.n_layers // cfg.slstm_group):
        slp = tf.layer_params(params["slstm_stack"], gi)
        out, st = xlstm.slstm_forward(slp["core"], layers.rmsnorm(slp["ln"], x), sd,
                                      return_state=True)
        x = x + out
        for leaf, new in zip(sst, st):
            leaf[gi] = new
        group = tf.layer_params(params["mlstm_stack_inner"], gi)
        for li in range(cfg.slstm_group - 1):
            p = tf.layer_params(group, li)
            out, st = xlstm.mlstm_forward(p["core"], layers.rmsnorm(p["ln"], x), md,
                                          return_state=True)
            x = x + out
            for leaf, new in zip(mst.state, st):
                leaf[gi, li] = new
    return layers.rmsnorm(params["final_ln"], x), (sst, mst)


def xlstm_prefill(params, batch, cfg: ArchCfg):
    """Prefill the prompt. Returns the last position's logits (B, 1, V) and
    the recurrent state: the final sLSTM and mLSTM states of every layer.
    Decode continues with the conv buffers reset to zeros, as the reference
    documents (the window of 3 tokens is ≪ the context)."""
    x = _embed(params, batch["tokens"], cfg)
    x, state = _xlstm_backbone(params, x, cfg)
    return _final_logits(x[:, -1:, :], params, cfg), state


def xlstm_init_decode_state(cfg: ArchCfg, batch: int, kv_len: int, *,
                            device="cuda"):
    """Zero recurrent states for `batch` sequences on `device` (the card
    unless asked); `kv_len` is unused: the state is O(1) in the context."""
    return _xlstm_states(cfg, batch, resolve_device(device))


def xlstm_decode_step(params, batch, state, cfg: ArchCfg):
    """One greedy-decode step: batch["tokens"] (B, 1) → logits (B, 1, V);
    every layer's state is written in place."""
    md, sd = _xlstm_dims(cfg)
    x = _embed(params, batch["tokens"], cfg)
    sst, mst = state
    for gi in range(cfg.n_layers // cfg.slstm_group):
        slp = tf.layer_params(params["slstm_stack"], gi)
        out, st = xlstm.slstm_decode_step(
            slp["core"], layers.rmsnorm(slp["ln"], x),
            xlstm.SLSTMState(*(t[gi] for t in sst)), sd)
        x = x + out
        for leaf, new in zip(sst, st):
            leaf[gi] = new
        group = tf.layer_params(params["mlstm_stack_inner"], gi)
        for li in range(cfg.slstm_group - 1):
            p = tf.layer_params(group, li)
            cache = xlstm.MLSTMCache(xlstm.MLSTMState(*(t[gi, li] for t in mst.state)),
                                     mst.conv_buf[gi, li])
            out, new = xlstm.mlstm_decode_step(p["core"], layers.rmsnorm(p["ln"], x),
                                               cache, md)
            x = x + out
            for leaf, t in zip(mst.state, new.state):
                leaf[gi, li] = t
            mst.conv_buf[gi, li] = new.conv_buf
    x = layers.rmsnorm(params["final_ln"], x)
    return _final_logits(x, params, cfg), state


# ===================================================== hybrid (zamba2)
#
# G groups of g Mamba2 layers, each group followed by one shared-weight
# attention + MLP block, then `tail` Mamba2 layers without attention
# (zamba2-7b: 81 = 13 × 6 + 3). Stacked leaves: mamba_groups_inner
# (G, g, …), mamba_tail (tail, …); where the reference scans over them,
# the port loops. Each group has its own ring cache of the shared block.

def _zamba_dims(cfg: ArchCfg) -> ssm.Mamba2Dims:
    return ssm.dims_for(cfg.d_model, cfg.ssm_state, head_dim=cfg.ssm_head_dim)


def _zamba_layout(cfg: ArchCfg):
    """(n_groups, group_size, n_tail)."""
    g = cfg.attn_every
    return cfg.n_layers // g, g, cfg.n_layers % g


def zamba_init(gen: torch.Generator, cfg: ArchCfg):
    """Random parameters drawn from `gen` on its device, in the reference's
    tree (A_log, D and dt_bias f32 whatever the model's dtype)."""
    dt = _dtype(cfg)
    dims = _zamba_dims(cfg)
    G, g, tail = _zamba_layout(cfg)

    def mamba_layer():
        return _with_ln(gen, ssm.mamba2_init(gen, dims, dtype=dt), cfg, dt)

    p = {
        "embed": layers.embedding_init(gen, cfg.vocab, cfg.d_model, dtype=dt),
        "mamba_groups_inner": tf.stack_trees([
            tf.stack_trees([mamba_layer() for _ in range(g)]) for _ in range(G)]),
        "shared_attn": tf.block_init(gen, cfg, use_moe=False, dtype=dt),
        "final_ln": layers.rmsnorm_init(gen, cfg.d_model, dt),
    }
    if tail:
        p["mamba_tail"] = tf.stack_trees([mamba_layer() for _ in range(tail)])
    return p


def zamba_loss(params, batch, cfg: ArchCfg):
    raise NotImplementedError("zamba2 training (zamba_loss, chunked_ce) waits for "
                              "the training slice (ROADMAP A16)")


def _zamba_mamba_prefill(stacked, x, dims: ssm.Mamba2Dims, dt):
    """The stacked Mamba2 layers over the sequence. Returns (x, their
    caches: the final states, and zero conv buffers in the model's dtype,
    as the reference hands decode)."""
    B = x.shape[0]
    states = []
    for i in range(tf.n_layers_of(stacked)):
        p = tf.layer_params(stacked, i)
        out, st = ssm.mamba2_forward(p["core"], layers.rmsnorm(p["ln"], x), dims,
                                     return_state=True)
        x = x + out
        states.append(st)
    buf = x.new_zeros((len(states), B, dims.d_conv - 1,
                       dims.d_inner + 2 * dims.d_state), dtype=dt)
    return x, ssm.Mamba2Cache(torch.stack(states), buf)


def _zamba_mamba_decode(stacked, x, caches: ssm.Mamba2Cache, dims: ssm.Mamba2Dims):
    """One token through the stacked Mamba2 layers; their caches (leading
    layer axis) are written in place."""
    for i in range(tf.n_layers_of(stacked)):
        p = tf.layer_params(stacked, i)
        out, mc = ssm.mamba2_decode_step(
            p["core"], layers.rmsnorm(p["ln"], x),
            ssm.Mamba2Cache(caches.state[i], caches.conv_buf[i]), dims)
        x = x + out
        caches.state[i] = mc.state
        caches.conv_buf[i] = mc.conv_buf
    return x


def zamba_prefill(params, batch, cfg: ArchCfg):
    """Prefill the prompt. Returns the last position's logits (B, 1, V) and
    {"mamba_groups": (G, g, …) Mamba2 caches, "attn": the G ring caches
    of the shared block, "mamba_tail": (tail, …) where the config has a
    tail}. A ring cache holds W = min(S + 1, window) slots in the model's
    dtype: the last W positions, right-padded with empty slots."""
    dims = _zamba_dims(cfg)
    G, g, tail = _zamba_layout(cfg)
    dt = _dtype(cfg)
    x = _embed(params, batch["tokens"], cfg)
    B, S, _ = x.shape
    shared = params["shared_attn"]
    W = min(S + 1, cfg.window) if cfg.window else S + 1
    pos = torch.arange(S, device=x.device)
    kv_shape = (G, B, W, cfg.n_kv, cfg.hd)
    ks, vs = x.new_zeros(kv_shape, dtype=dt), x.new_zeros(kv_shape, dtype=dt)
    n_kept = min(S, W)
    kpos = torch.full((W,), attn.POS_SENTINEL, dtype=torch.int32, device=x.device)
    kpos[:n_kept] = pos[S - n_kept:].to(torch.int32)
    states, bufs = [], []
    for gi in range(G):
        x, mc = _zamba_mamba_prefill(tf.layer_params(params["mamba_groups_inner"], gi),
                                     x, dims, dt)
        states.append(mc.state)
        bufs.append(mc.conv_buf)
        hn = layers.rmsnorm(shared["ln1"], x)
        q, k, v = attn.qkv(shared["attn"], hn, cfg.n_heads, cfg.n_kv, cfg.hd)
        q = attn.rope(q, pos, theta=cfg.rope_theta)
        k = attn.rope(k, pos, theta=cfg.rope_theta)
        o = flash.flash_attention(q, k, v, causal=True, window=cfg.window)
        x = x + layers.dense(shared["attn"]["wo"], o.reshape(B, S, cfg.n_heads * cfg.hd))
        x = x + tf.ffn_apply(shared["ffn"], layers.rmsnorm(shared["ln2"], x), cfg)
        ks[gi, :, :n_kept] = k[:, S - n_kept:]
        vs[gi, :, :n_kept] = v[:, S - n_kept:]
    st = {"mamba_groups": ssm.Mamba2Cache(torch.stack(states), torch.stack(bufs)),
          "attn": attn.KVCache(ks, vs, kpos[None].repeat(G, 1), S)}
    if tail:
        x, st["mamba_tail"] = _zamba_mamba_prefill(params["mamba_tail"], x, dims, dt)
    x = layers.rmsnorm(params["final_ln"], x[:, -1:, :])
    return _final_logits(x, params, cfg), st


def zamba_init_decode_state(cfg: ArchCfg, batch: int, kv_len: int, *,
                            device="cuda"):
    """Zero Mamba2 caches and G ring caches of min(kv_len, window) slots in
    the model's dtype, with kv_len − 1 prior tokens, on `device` (the card
    unless asked)."""
    dev = resolve_device(device)
    dims = _zamba_dims(cfg)
    dt = _dtype(cfg)
    G, g, tail = _zamba_layout(cfg)

    def caches(*lead):
        one = ssm.init_mamba2_cache(batch, dims, dt, device=dev)
        return ssm.Mamba2Cache(*(t.expand(*lead, *t.shape).clone() for t in one))

    w = min(kv_len, cfg.window) if cfg.window else kv_len
    one = attn.init_cache(batch, w, cfg.n_kv, cfg.hd, dt, length=kv_len - 1, device=dev)
    akv = attn.KVCache(one.k.expand(G, *one.k.shape).clone(),
                       one.v.expand(G, *one.v.shape).clone(),
                       one.pos.expand(G, *one.pos.shape).clone(), one.length)
    st = {"mamba_groups": caches(G, g), "attn": akv}
    if tail:
        st["mamba_tail"] = caches(tail)
    return st


def zamba_decode_step(params, batch, state, cfg: ArchCfg):
    """One greedy-decode step: batch["tokens"] (B, 1) → logits (B, 1, V);
    every Mamba2 cache and ring cache is written in place."""
    dims = _zamba_dims(cfg)
    G, g, tail = _zamba_layout(cfg)
    x = _embed(params, batch["tokens"], cfg)
    shared = params["shared_attn"]
    state = dict(state)
    mg, akv = state["mamba_groups"], state["attn"]
    for gi in range(G):
        x = _zamba_mamba_decode(tf.layer_params(params["mamba_groups_inner"], gi), x,
                                ssm.Mamba2Cache(mg.state[gi], mg.conv_buf[gi]), dims)
        cache = attn.KVCache(akv.k[gi], akv.v[gi], akv.pos[gi], akv.length)
        x, _ = tf.block_decode(shared, x, cache, cfg, window=cfg.window)
    state["attn"] = attn.KVCache(akv.k, akv.v, akv.pos, akv.length + 1)
    if tail:
        x = _zamba_mamba_decode(params["mamba_tail"], x, state["mamba_tail"], dims)
    x = layers.rmsnorm(params["final_ln"], x)
    return _final_logits(x, params, cfg), state


# ============================================================ conversion

def _to_tensor(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes bf16: through f32, exactly
        return torch.from_numpy(a.astype(np.float32)).to(dev).to(torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(dev)   # a writable copy


def params_from_jax(tree, device="cuda"):
    """A reference parameter tree (nested dicts of arrays, stacked layer
    leaves) → the port's nested dict of tensors on `device`, leaf for
    leaf, dtypes kept."""
    dev = resolve_device(device)
    return {k: params_from_jax(v, dev) if isinstance(v, dict) else _to_tensor(v, dev)
            for k, v in tree.items()}
