"""Dispatch for the statistical utility.

`stat_utility` is the wrapper: losses on the CPU run the plain version
(`ref.stat_utility`); losses on a CUDA device launch the hand-written
kernel (`csrc/stat_util.cu`) or raise — there is no fallback. `launches`
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.stat_util import ref

launches = 0   # kernel launches since the last reset (a plain counter)

_P = ctypes.c_void_p
_ENTRY = {torch.float32: "stat_util_f32", torch.bfloat16: "stat_util_bf16"}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("stat_util")
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [_P, ctypes.c_longlong, _P, _P, ctypes.c_longlong,
                       ctypes.c_int, _P]
        fn.restype = ctypes.c_int
    return lib


def _launch(losses: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    global launches
    if losses.dtype not in _ENTRY:
        raise ValueError(f"stat_util: unsupported dtype {losses.dtype}")
    if losses.dim() != 2 or losses.shape[1] == 0 or (
            losses.shape[1] > 1 and losses.stride(1) != 1):
        raise ValueError("stat_util: losses must be (S, n), n >= 1, with unit "
                         f"stride along n; got {tuple(losses.shape)}, "
                         f"strides {losses.stride()}")
    S, n = losses.shape
    if n >= 2**31:
        raise ValueError(f"stat_util: rows of {n} losses outside the kernel's range")
    if sizes.device != losses.device or sizes.shape != (S,):
        raise ValueError(f"stat_util: sizes must be ({S},) on {losses.device}")
    sizes = sizes.float().contiguous()
    out = torch.empty(S, dtype=torch.float32, device=losses.device)
    err = getattr(_lib(), _ENTRY[losses.dtype])(
        losses.data_ptr(), losses.stride(0), sizes.data_ptr(), out.data_ptr(),
        S, n, torch.cuda.current_stream(losses.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stat_util kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def stat_utility(losses: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """losses (S, n) f32 or bf16, sizes (S,) -> (S,) f32
    |B_i|·sqrt(max(mean_k loss², 0))."""
    if losses.device.type == "cpu":
        return ref.stat_utility(losses, sizes)
    if losses.device.type != "cuda":
        raise ValueError(f"stat_util: unsupported device {losses.device}")
    return _launch(losses, sizes)
