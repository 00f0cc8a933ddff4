"""DeepSeek-7B — llama-arch dense [arXiv:2401.02954]."""
from repro_torch.configs.base import ArchCfg, register

register(ArchCfg(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv=32, d_ff=11008, vocab=102400,
    rope_theta=10000.0, optimizer="adam",
    notes="[arXiv:2401.02954]",
))
