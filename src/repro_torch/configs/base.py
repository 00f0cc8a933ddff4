"""ArchCfg dataclass, registry, input shapes, analytic FLOP/param counts.

The port's copy of the JAX package's `configs/base.py`: every assigned
architecture lives in its own module (``repro_torch/configs/<id>.py``,
data only) and registers here; source citations are kept in those
modules. The reference's ``input_specs`` (shape stand-ins for its
dry-run) has no counterpart here; its ``INPUT_SHAPES`` table is kept.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple



@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    shared_d_ff: int = 0       # always-on shared expert hidden dim
    n_dense_prefix: int = 0    # leading dense layers (Kimi K2: 1)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ArchCfg:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    moe: Optional[MoESpec] = None
    # attention flavour
    window: Optional[int] = None     # sliding-window size (local layers)
    alt_window: bool = False         # gemma2: alternate local/global
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    rope_theta: float = 10000.0
    post_norm: bool = False          # gemma2 post-block norms
    embed_scale: bool = False        # gemma: embeddings * sqrt(d)
    mlp_act: str = "silu"            # silu (swiglu) | gelu (geglu)
    qkv_bias: bool = False
    # ssm / hybrid / xlstm
    ssm_state: int = 0
    ssm_head_dim: int = 64
    attn_every: int = 0              # zamba2: shared attn block cadence
    slstm_group: int = 0             # xlstm: group size (1 sLSTM + g-1 mLSTM)
    # vlm / audio frontends (stubs -> embeddings via input_specs)
    n_img_tokens: int = 0            # llava anyres patch tokens
    enc_layers: int = 0              # whisper encoder depth
    enc_seq: int = 0                 # whisper encoder frames (1500)
    # numerics / training
    param_dtype: str = "bfloat16"
    optimizer: str = "adam"          # adam | momentum (big models)
    sub_quadratic: bool = False      # eligible for long_500k
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def reduced(self) -> "ArchCfg":
        """CPU smoke-test variant: ≤2 layers, d_model ≤ 512, ≤4 experts."""
        d = min(self.d_model, 256)
        heads = max(1, min(self.n_heads, 4))
        n_kv = max(1, min(self.n_kv, heads))
        while heads % n_kv:
            n_kv -= 1
        moe = None
        if self.moe is not None:
            moe = MoESpec(n_experts=4, top_k=2,
                          shared_d_ff=64 if self.moe.shared_d_ff else 0,
                          n_dense_prefix=min(self.moe.n_dense_prefix, 1),
                          capacity_factor=2.0)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=2 if self.family != "ssm" else max(2, self.slstm_group or 2),
            d_model=d, n_heads=heads, n_kv=n_kv,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            head_dim=d // heads,
            moe=moe,
            window=min(self.window, 8) if self.window else None,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=min(self.ssm_head_dim, 32) if self.ssm_state else 64,
            attn_every=2 if self.attn_every else 0,
            slstm_group=2 if self.slstm_group else 0,
            n_img_tokens=16 if self.n_img_tokens else 0,
            enc_layers=2 if self.enc_layers else 0,
            enc_seq=32 if self.enc_seq else 0,
            param_dtype="float32",
        )


# ------------------------------------------------------------ registry --

_ARCH_MODULES = [
    "olmoe_1b_7b", "xlstm_1_3b", "gemma2_27b", "kimi_k2_1t_a32b",
    "llava_next_34b", "llama3_2_3b", "whisper_base", "zamba2_7b",
    "deepseek_7b", "granite_34b",
]

ARCH_REGISTRY: Dict[str, ArchCfg] = {}


def register(cfg: ArchCfg) -> ArchCfg:
    ARCH_REGISTRY[cfg.name] = cfg
    return cfg


def _load_all() -> None:
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


def get_config(name: str, *, reduced: bool = False) -> ArchCfg:
    if not ARCH_REGISTRY:
        _load_all()
    cfg = ARCH_REGISTRY[name]
    return cfg.reduced() if reduced else cfg


def list_archs():
    if not ARCH_REGISTRY:
        _load_all()
    return sorted(ARCH_REGISTRY)


# --------------------------------------------------------- input shapes --

# name -> (seq_len, global_batch, kind)
INPUT_SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


# ----------------------------------------------------- analytic counting --

def param_count(cfg: ArchCfg) -> int:
    """Analytic parameter count (matches init_params; verified in tests)."""
    D, F, L, V, hd = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab, cfg.hd
    emb = V * D
    if cfg.family in ("dense", "vlm", "moe"):
        attn = D * cfg.n_heads * hd + 2 * D * cfg.n_kv * hd + cfg.n_heads * hd * D
        norms = (4 if cfg.post_norm else 2) * D
        if cfg.family == "moe" and cfg.moe is not None:
            m = cfg.moe
            moe_ffn = m.n_experts * 3 * D * F + D * m.n_experts
            if m.shared_d_ff:
                moe_ffn += 3 * D * m.shared_d_ff
            dense_ffn = 3 * D * F  # prefix layers reuse d_ff
            n_moe = L - m.n_dense_prefix
            return (emb + n_moe * (attn + moe_ffn + norms)
                    + m.n_dense_prefix * (attn + dense_ffn + norms) + D)
        ffn = 3 * D * F
        return emb + L * (attn + ffn + norms) + D
    if cfg.family == "ssm":  # xlstm groups
        g = cfg.slstm_group
        n_groups = L // g
        n_mlstm = L - n_groups
        din = 2 * D
        hd_m = din // cfg.n_heads
        # up(D→2din) + conv + block-diag qkv (3·NH·hd²) + if gates + norm
        # + down(din→D) + pre-LN
        mlstm = (D * 2 * din + 4 * din + din +
                 3 * cfg.n_heads * hd_m * hd_m +
                 din * (2 * cfg.n_heads) + 2 * cfg.n_heads + din + din * D + D)
        hd_s = D // cfg.n_heads
        slstm = (D * 4 * D + 4 * D + cfg.n_heads * hd_s * 4 * hd_s + D
                 + D * 2 * D + D * D + D)
        return emb + n_mlstm * mlstm + n_groups * slstm + D
    if cfg.family == "hybrid":  # zamba2
        din = 2 * D
        H = din // cfg.ssm_head_dim
        N = cfg.ssm_state
        conv_ch = din + 2 * N
        mamba = (D * (2 * din + 2 * N + H) + 4 * conv_ch + conv_ch +
                 3 * H + din + din * D + D)
        attn = D * cfg.n_heads * hd + 2 * D * cfg.n_kv * hd + cfg.n_heads * hd * D
        shared = attn + 3 * D * cfg.d_ff + 2 * D
        return emb + L * (mamba + D) + shared + D
    if cfg.family == "audio":
        attn = D * cfg.n_heads * hd + 2 * D * cfg.n_kv * hd + cfg.n_heads * hd * D
        ffn = 2 * D * F + D + F  # whisper mlp (gelu, biased, non-glu)
        enc = cfg.enc_layers * (attn + ffn + 2 * D) + cfg.enc_seq * D
        dec = cfg.n_layers * (2 * attn + ffn + 3 * D)
        return emb + enc + dec + D
    raise ValueError(cfg.family)


def model_flops(cfg: ArchCfg, shape_name: str) -> float:
    """MODEL_FLOPS = 6·N·D_tokens (dense) / 6·N_active·D_tokens (MoE).

    For decode shapes, tokens = global_batch (one token each).
    """
    S, B, kind = INPUT_SHAPES[shape_name]
    tokens = B * S if kind != "decode" else B
    n = active_param_count(cfg)
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens


def active_param_count(cfg: ArchCfg) -> int:
    """Params touched per token (MoE: top_k of n_experts)."""
    n = param_count(cfg)
    if cfg.family == "moe" and cfg.moe is not None:
        m = cfg.moe
        D, F, L = cfg.d_model, cfg.d_ff, cfg.n_layers
        n_moe = L - m.n_dense_prefix
        all_experts = n_moe * m.n_experts * 3 * D * F
        active = n_moe * m.top_k * 3 * D * F
        n = n - all_experts + active
    return n
