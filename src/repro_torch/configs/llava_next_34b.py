"""LLaVA-NeXT 34B — VLM backbone; anyres vision tiling is a frontend stub
(input_specs supplies patch embeddings) [hf:llava-hf/llava-v1.6]."""
from repro_torch.configs.base import ArchCfg, register

register(ArchCfg(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv=8, d_ff=20480, vocab=64000,
    head_dim=128,
    n_img_tokens=576,  # one anyres base tile; embeddings provided pre-projected
    rope_theta=5000000.0, optimizer="momentum",
    notes="language tower only (carve-out): ViT+projector stubbed via "
          "input_specs [hf:llava-hf/llava-v1.6-mistral-7b-hf]",
))
