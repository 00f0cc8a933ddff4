"""Llama-3.2 3B [hf:meta-llama/Llama-3.2-1B family]."""
from repro_torch.configs.base import ArchCfg, register

register(ArchCfg(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv=8, d_ff=8192, vocab=128256,
    head_dim=128, rope_theta=500000.0, optimizer="adam",
    notes="[hf:meta-llama/Llama-3.2-1B]",
))
