"""Serve a dense, vlm, moe, ssm (xlstm) or hybrid (zamba2) architecture:
batched prefill + greedy decode through the serving stack (ring KV caches
or recurrent states, prefill/decode steps), on a CUDA device by default.
The port of `examples/serve_llm.py`.

CLI:  PYTHONPATH=src python -m repro_torch.launch.serve \
          --arch llama3.2-3b --batch 4 --prompt-len 2048 --tokens 32
      (or --arch olmoe-1b-7b, the moe family at its published widths,
      ~13.6 GB of bf16 weights; kimi-k2-1t-a32b, ~1 T parameters, fits
      no single card and serves `--reduced` only; or --arch xlstm-1.3b,
      whose prompt length must be a multiple of 64, or at most 64: the
      mLSTM's chunk rule; or --arch zamba2-7b, 81 Mamba2 layers and a
      shared attention block after every 6, ~13.3 GB of bf16 weights,
      under the same rule for the SSD chunk of 64)
(`--reduced` serves the CPU-sized variant, in f32 unless
`--param-dtype bfloat16`; `--device cpu` runs on the CPU; without a GPU
the default raises.) Weights are random, drawn from
`--seed`; so is the prompt.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional

import torch

from repro_torch.common import resolve_device
from repro_torch.configs.base import get_config, param_count
from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.kernels.slstm import ops as slstm
from repro_torch.models.api import get_model_api


@dataclasses.dataclass
class ServeResult:
    arch: str
    ids: torch.Tensor          # (B, tokens + 1) int64 on the CPU: greedy ids
    last_logits: torch.Tensor  # (B, V) f32 on the CPU: the last step's logits
    prefill_s: float           # prefill + first argmax, ends in a device sync
    decode_s: float            # all decode steps, ends in a device sync
    flash_launches: int        # flash-attention kernel launches in this call
                               # (one a dense layer, one a zamba2 group)
    slstm_launches: int        # sLSTM kernel launches in this call
    n_params: int
    batch: int
    prompt_len: int
    tokens: int


def make_batch(cfg, batch: int, prompt_len: int, seed: int, device) -> dict:
    """The prompt (and, for vlm, stub image embeddings) drawn from a CPU
    generator seeded with `seed`, so every device serves the same one."""
    gen = torch.Generator().manual_seed(seed)
    out = {"tokens": torch.randint(0, cfg.vocab, (batch, prompt_len),
                                   generator=gen).to(device)}
    if cfg.family == "vlm":
        out["image_embeds"] = torch.randn(
            (batch, cfg.n_img_tokens, cfg.d_model), generator=gen).to(device)
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str, *, reduced: bool = False, batch: int = 4,
          prompt_len: int = 16, tokens: int = 16, seed: int = 0,
          device="cuda", params=None,
          param_dtype: Optional[str] = None) -> ServeResult:
    """Prefill a seeded prompt of `batch` × `prompt_len` tokens, then
    decode `tokens` greedy steps on the prefill's cache. `params` (the
    reference's tree, on `device`) replaces the random weights drawn from
    `seed`; `param_dtype` ("float32" or "bfloat16") replaces the config's
    weight dtype."""
    dev = resolve_device(device)
    cfg = get_config(arch, reduced=reduced)
    if param_dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=param_dtype)
    api = get_model_api(cfg)
    with torch.inference_mode():
        if params is None:
            params = api.init_params(torch.Generator(device=dev).manual_seed(seed), cfg)
        inputs = make_batch(cfg, batch, prompt_len, seed, dev)
        flash0, slstm0 = flash.launches, slstm.launches
        _sync(dev)
        t0 = time.perf_counter()
        logits, state = api.prefill(params, inputs, cfg)
        tok = logits[:, -1, :].argmax(-1)[:, None]
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        out = [tok]
        t0 = time.perf_counter()
        for _ in range(tokens):
            logits, state = api.decode_step(params, {"tokens": tok}, state, cfg)
            tok = logits[:, -1, :].argmax(-1)[:, None]
            out.append(tok)
        _sync(dev)
        decode_s = time.perf_counter() - t0
        return ServeResult(arch=cfg.name, ids=torch.cat(out, dim=1).cpu(),
                           last_logits=logits[:, -1, :].float().cpu(),
                           prefill_s=prefill_s, decode_s=decode_s,
                           flash_launches=flash.launches - flash0,
                           slstm_launches=slstm.launches - slstm0,
                           n_params=param_count(cfg), batch=batch,
                           prompt_len=prompt_len, tokens=tokens)


def summary(res: ServeResult) -> dict:
    return {"arch": res.arch, "batch": res.batch, "prompt_len": res.prompt_len,
            "tokens": res.tokens, "n_params": res.n_params,
            "prefill_ms": res.prefill_s * 1e3,
            "decode_ms_per_token": res.decode_s * 1e3 / max(res.tokens, 1),
            "decode_tok_per_s": res.tokens * res.batch / res.decode_s
            if res.decode_s > 0 else None,
            "flash_launches": res.flash_launches,
            "slstm_launches": res.slstm_launches}


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-3b",
                    help="a dense, vlm, moe (olmoe-1b-7b, kimi-k2-1t-a32b), "
                    "ssm (xlstm-1.3b) or hybrid (zamba2-7b) architecture; "
                    "xlstm and zamba2 take a prompt of at most 64 tokens or "
                    "a multiple of 64")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true",
                    help="the CPU-sized variant (d_model <= 256; 2 layers, "
                    "8 for xlstm; 4 experts, top 2, for moe; one group of 2 "
                    "Mamba2 layers and window 8 for zamba2)")
    ap.add_argument("--param-dtype", choices=("float32", "bfloat16"),
                    help="the weights' dtype (default: the config's)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = serve(args.arch, reduced=args.reduced, batch=args.batch,
                prompt_len=args.prompt_len, tokens=args.tokens, seed=args.seed,
                device=args.device, param_dtype=args.param_dtype)
    print(f"served {res.arch}: prefill({res.prompt_len} tokens x {res.batch} "
          f"reqs) {res.prefill_s:.2f}s; decoded {res.tokens} tokens/request "
          f"in {res.decode_s:.2f}s")
    for i, row in enumerate(res.ids.tolist()):
        print(f"  req{i}: {row}")
    print(json.dumps(summary(res)))


if __name__ == "__main__":
    main()
