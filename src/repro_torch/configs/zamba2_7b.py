"""Zamba2-7B — Mamba2 backbone + shared attention block [arXiv:2411.15242]."""
from repro_torch.configs.base import ArchCfg, register

register(ArchCfg(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv=32, d_ff=14336, vocab=32000,
    ssm_state=64, ssm_head_dim=64,
    attn_every=6,    # one *shared-weight* attention(+MLP) block every 6 mamba
    window=4096,     # shared attention is windowed -> long_500k eligible
    sub_quadratic=True, optimizer="adam",
    notes="Mamba2 + shared attn blocks [arXiv:2411.15242]",
))
