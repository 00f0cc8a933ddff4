"""Dispatch for the weighted FedAvg aggregation.

`weighted_aggregate` is the wrapper: a stack on the CPU runs the plain
version (`ref.weighted_aggregate`); a stack on a CUDA device launches
the hand-written kernel (`csrc/fedavg.cu`) or raises — there is no
fallback. `launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fedavg import ref

launches = 0   # kernel launches since the last reset (a plain counter)

_P = ctypes.c_void_p
_ENTRY = {torch.float32: "fedavg_f32", torch.bfloat16: "fedavg_bf16"}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("fedavg")
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [_P, ctypes.c_longlong, _P, _P, ctypes.c_int,
                       ctypes.c_longlong, _P]
        fn.restype = ctypes.c_int
    return lib


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    global launches
    if x.dtype not in _ENTRY:
        raise ValueError(f"fedavg: unsupported dtype {x.dtype}")
    if (w.device != x.device or w.dtype != torch.float32
            or w.shape != x.shape[:1] or not w.is_contiguous()):
        raise ValueError("fedavg: weights must be a contiguous (K,) float32 "
                         f"tensor on {x.device}")
    K = x.shape[0]
    if x.dim() == 2 and x.stride(1) == 1:
        flat = x                  # (K, P) rows, possibly with padded stride
    elif x.is_contiguous():
        flat = x.reshape(K, -1)
    else:
        raise ValueError("fedavg: stack must be contiguous, or (K, P) with "
                         "unit stride along P")
    P = flat.shape[1]
    out = torch.empty(P, dtype=x.dtype, device=x.device)
    err = getattr(_lib(), _ENTRY[x.dtype])(
        flat.data_ptr(), flat.stride(0), w.data_ptr(),
        out.data_ptr(), K, P, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fedavg kernel launch failed: CUDA error {err}")
    launches += 1
    return out.reshape(x.shape[1:])


def weighted_aggregate(stack: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """out = Σ_k w_k·stack[k] for stack (K, ...) f32 or bf16 and weights
    (K,) f32; f32 accumulation, output in the stack's dtype."""
    if stack.device.type == "cpu":
        return ref.weighted_aggregate(stack, weights)
    if stack.device.type != "cuda":
        raise ValueError(f"fedavg: unsupported device {stack.device}")
    return _launch(stack, weights)
