"""xLSTM-1.3B — sLSTM + mLSTM blocks [arXiv:2405.04517]."""
from repro_torch.configs.base import ArchCfg, register

register(ArchCfg(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv=4, d_ff=0, vocab=50304,
    slstm_group=8,  # 48 layers = 6 groups x (1 sLSTM + 7 mLSTM) — 7:1 ratio
    sub_quadratic=True, optimizer="adam",
    notes="recurrent state -> O(1)/token decode; long_500k eligible "
          "[arXiv:2405.04517]",
))
