"""Decoder language models: the dense family (llama / deepseek / granite /
gemma2) and the vlm family's language tower, for serving.

Per-family API (see ``repro_torch.models.api``), the reference's without
its sharding argument:
  init_params(gen, cfg)                   -> params (nested dict)
  prefill(params, batch, cfg)             -> (last_logits, state)
  decode_step(params, batch, state, cfg)  -> (logits, state)
  init_decode_state(cfg, batch, kv_len, *, device) -> state

Decode-state convention: a "KV cache of seq_len" holds seq_len−1 prior
tokens; decode_step writes token seq_len−1 (0-based) and attends the full
seq_len context. The state is a ring cache of KV slots that decode_step
writes in place and returns.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.configs.base import ArchCfg
from repro_torch.nn import layers
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
