"""Granite-34B-Code — llama-arch, MQA (kv=1) [arXiv:2405.04324]."""
from repro_torch.configs.base import ArchCfg, register

register(ArchCfg(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv=1, d_ff=24576, vocab=49152,
    rope_theta=10000.0, optimizer="momentum",
    notes="MQA kv=1: KV replicated over model axis, batch-sharded only "
          "[arXiv:2405.04324]",
))
