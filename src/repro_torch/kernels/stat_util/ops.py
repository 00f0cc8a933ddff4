"""Dispatch for the statistical utility.

`stat_utility` is the wrapper, a `torch.library` custom op: losses on
the CPU run the plain version (`ref.stat_utility`); losses on a CUDA
device launch the hand-written kernel (`csrc/stat_util.cu`) or raise —
there is no fallback. `launches` counts kernel launches.

The kernel reduces each row on its own, so under `torch.func.vmap` (a
campaign grid's cell axis) the op's vmap rule folds the C cells' (K, n)
rows into one (C·K, n) block: one launch for all cells.
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


@torch.library.custom_op("repro_torch::stat_util", mutates_args=(),
                         device_types="cpu")
def _stat_util(losses: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    return ref.stat_utility(losses, sizes)


@_stat_util.register_kernel("cuda")
def _(losses, sizes):
    return _launch(losses, sizes)


@_stat_util.register_fake
def _(losses, sizes):
    return losses.new_empty(losses.shape[:1], dtype=torch.float32)


def _stat_util_vmap(info, in_dims, losses, sizes):
    n = info.batch_size
    lo = (losses.unsqueeze(0).expand(n, *losses.shape) if in_dims[0] is None
          else losses.movedim(in_dims[0], 0))
    sz = (sizes.unsqueeze(0).expand(n, *sizes.shape) if in_dims[1] is None
          else sizes.movedim(in_dims[1], 0))
    rows = lo.shape[1]
    out = _stat_util(lo.reshape((n * rows,) + lo.shape[2:]), sz.reshape(n * rows))
    return out.reshape(n, rows), 0


_stat_util.register_vmap(_stat_util_vmap)


def stat_utility(losses: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """losses (S, n) f32 or bf16, sizes (S,) -> (S,) f32
    |B_i|·sqrt(max(mean_k loss², 0))."""
    if losses.device.type not in ("cpu", "cuda"):
        raise ValueError(f"stat_util: unsupported device {losses.device}")
    return _stat_util(losses, sizes)
