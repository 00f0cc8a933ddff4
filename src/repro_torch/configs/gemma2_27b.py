"""Gemma-2 27B — local/global alternating attention, logit softcaps
[arXiv:2408.00118]."""
from repro_torch.configs.base import ArchCfg, register

register(ArchCfg(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv=16, d_ff=36864, vocab=256000,
    head_dim=128,
    window=4096, alt_window=True,          # even layers local-4096, odd global
    attn_softcap=50.0, final_softcap=30.0,
    post_norm=True, embed_scale=True, mlp_act="gelu",
    sub_quadratic=True,  # long_500k served with the windowed variant (all
                         # layers local-4096) — documented in DESIGN.md
    optimizer="momentum",
    notes="[arXiv:2408.00118]",
))
