"""Whisper-base — encoder-decoder; mel+conv frontend is a stub
(input_specs supplies frame embeddings) [arXiv:2212.04356]."""
from repro_torch.configs.base import ArchCfg, register

register(ArchCfg(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv=8, d_ff=2048, vocab=51865,
    enc_layers=6, enc_seq=1500,
    mlp_act="gelu", qkv_bias=True, rope_theta=10000.0,
    optimizer="adam",
    notes="enc-dec; conv frontend stubbed (carve-out). decode_32k is a "
          "mechanical stress shape (real max positions 448) — DESIGN.md. "
          "[arXiv:2212.04356]",
))
