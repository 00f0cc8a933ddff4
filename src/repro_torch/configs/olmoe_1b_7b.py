"""OLMoE-1B-7B — 64-expert top-8 MoE [arXiv:2409.02060]."""
from repro_torch.configs.base import ArchCfg, MoESpec, register

register(ArchCfg(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv=16, d_ff=1024, vocab=50304,
    moe=MoESpec(n_experts=64, top_k=8),
    rope_theta=10000.0, optimizer="adam",
    notes="64 experts, top-8, 1B active / 7B total [arXiv:2409.02060]",
))
