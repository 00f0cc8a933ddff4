"""Dispatch for flash attention.

`flash_attention` is the wrapper: tensors on the CPU run the plain
version (`ref.attention`); tensors on a CUDA device launch one of the
two hand-written kernels of `csrc/flash_attention.cu` by dtype — bf16 the
tensor-core kernel (TMA, wgmma), f32 the CUDA-core one — or raise: there
is no fallback. `launches` counts launches of either kernel,
`tc_launches` those of the tensor-core kernel alone.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

launches = 0      # kernel launches since the last reset (a plain counter)
tc_launches = 0   # of which the bf16 tensor-core kernel's

HEAD_DIMS = (64, 112, 128)   # head widths the kernels take (112 in the layout of 128)

_P = ctypes.c_void_p
_I = ctypes.c_int
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float,
                       _I, _I, ctypes.c_longlong, ctypes.c_float, _P]
        fn.restype = ctypes.c_int
    return lib


def _launch(q, k, v, causal, window, softcap) -> torch.Tensor:
    global launches, tc_launches
    if q.dtype not in _ENTRY:
        raise ValueError(f"flash_attention: unsupported dtype {q.dtype}")
    if any(t.dtype != q.dtype or t.device != q.device for t in (k, v)):
        raise ValueError("flash_attention: q, k and v must share dtype and device")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention: q (B, Sq, H, hd), k and v "
                         f"(B, Sk, n_kv, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Sk, n_kv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError("flash_attention: q and k/v disagree on batch or head "
                         f"width: {tuple(q.shape)} vs {tuple(k.shape)}")
    if n_kv == 0 or H % n_kv:
        raise ValueError(f"flash_attention: {H} query heads over {n_kv} KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head width {hd} not supported "
                         f"(the kernel takes {HEAD_DIMS})")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if max(Sq, Sk) >= 2**31 or max(B, H) > 65535:
        raise ValueError("flash_attention: shape outside the kernel's grid")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap must be positive, got {softcap}")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: bf16 q, k and v must start 16-byte aligned "
                         "(the kernel reads them with TMA)")
    out = torch.empty_like(q)
    err = getattr(_lib(), _ENTRY[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk, H,
        n_kv, hd, 1.0 / math.sqrt(hd),
        int(causal), int(window is not None), 0 if window is None else int(window),
        0.0 if softcap is None else float(softcap),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    launches += 1
    tc_launches += int(q.dtype == torch.bfloat16)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, n_kv, hd) -> (B, Sq, H, hd) in q's
    dtype (f32 or bf16). Scores are scaled by 1/√hd. Mask by position
    difference d = i − j: causal keeps d ≥ 0, `window` keeps d < window;
    `softcap` caps the scaled scores at c·tanh(s / c) before masking."""
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, window=window,
                             logit_softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch(q, k, v, causal, window, softcap)
