"""Uniform per-architecture model API: the reference's `ModelAPI` without
its sharding argument."""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ArchCfg
from repro_torch.models import lm


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    init_params: Callable        # (gen, cfg) -> params
    loss_fn: Callable            # (params, batch, cfg) -> (loss, metrics)
    prefill: Callable            # (params, batch, cfg) -> (logits, state)
    decode_step: Callable        # (params, batch, state, cfg) -> (logits, state)
    init_decode_state: Callable  # (cfg, batch, kv_len, *, device) -> state


_NOT_PORTED = {
    "audio": "the audio family (whisper) waits for models/whisper (ROADMAP A16)",
}


def get_model_api(cfg: ArchCfg) -> ModelAPI:
    fam = cfg.family
    if fam in ("dense", "vlm"):
        return ModelAPI(lm.dense_init, lm.dense_loss, lm.dense_prefill,
                        lm.dense_decode_step, lm.dense_init_decode_state)
    if fam == "moe":
        return ModelAPI(lm.moe_init, lm.moe_loss, lm.moe_prefill,
                        lm.moe_decode_step, lm.moe_init_decode_state)
    if fam == "ssm":
        return ModelAPI(lm.xlstm_init, lm.xlstm_loss, lm.xlstm_prefill,
                        lm.xlstm_decode_step, lm.xlstm_init_decode_state)
    if fam == "hybrid":
        return ModelAPI(lm.zamba_init, lm.zamba_loss, lm.zamba_prefill,
                        lm.zamba_decode_step, lm.zamba_init_decode_state)
    if fam in _NOT_PORTED:
        raise NotImplementedError(f"{cfg.name}: {_NOT_PORTED[fam]}")
    raise ValueError(f"unknown family {fam}")
