"""Kimi K2 — trillion-param MoE, 384 experts top-8 + shared expert
[arXiv:2501.kimi2] (paper-table spec)."""
from repro_torch.configs.base import ArchCfg, MoESpec, register

register(ArchCfg(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv=8, d_ff=2048, vocab=163840,
    moe=MoESpec(n_experts=384, top_k=8, shared_d_ff=2048, n_dense_prefix=1),
    rope_theta=50000.0, optimizer="momentum",
    notes="assigned spec uses GQA kv=8 (not MLA); 1 dense prefix layer "
          "[arXiv:2501.kimi2]",
))
