"""Flash-attention forward (GQA, causal, sliding window, logit softcap)."""
