"""Dispatch for the sLSTM recurrence.

`slstm_scan` is the wrapper: tensors on the CPU run the plain version
(`ref.slstm_scan`); tensors on a CUDA device launch the hand-written
kernel (`csrc/slstm.cu`) or raise — there is no fallback. `launches`
counts kernel launches.

The kernel is persistent and launched cooperatively: NH·hd/J blocks of
256 threads, block (head, j0) owning J hidden units of one head and its
hd × 4J slice of R in shared memory; every block must be resident at
once, and `pick_units` chooses the smallest J whose grid fits the card's
SMs (one block each).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.slstm import ref

launches = 0   # kernel launches since the last reset (a plain counter)

MAX_B = 16          # batch rows the kernel takes
THREADS = 256       # threads per block
_TOO_LARGE = 720    # cudaErrorCooperativeLaunchTooLarge

_P = ctypes.c_void_p
_I = ctypes.c_int
_ENTRY = {torch.float32: "slstm_f32", torch.bfloat16: "slstm_bf16"}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("slstm")
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [_P] * 9 + [_I] * 5 + [_P]
        fn.restype = ctypes.c_int
    lib.slstm_barrier_loop.argtypes = [_P] + [_I] * 6 + [_P]
    lib.slstm_barrier_loop.restype = ctypes.c_int
    return lib


def pick_units(batch: int, n_heads: int, head_dim: int, n_sm: int) -> int:
    """J, the hidden units per block: the smallest power of two ≤ 64 with
    J | hd, (64 / J) | hd (the threads that share a gate column split hd
    evenly), B·J ≤ 256, and NH·hd/J blocks no more than the SMs."""
    for J in (1, 2, 4, 8, 16, 32, 64):
        if (head_dim % J == 0 and head_dim % (THREADS // (4 * J)) == 0
                and batch * J <= THREADS and n_heads * (head_dim // J) <= n_sm):
            return J
    raise ValueError(f"slstm: no block split of NH={n_heads} heads of hd={head_dim} "
                     f"at B={batch} fits {n_sm} SMs")


def _check(err: int, what: str, J: int, NH: int, hd: int) -> None:
    if err == _TOO_LARGE:
        raise ValueError(f"slstm: the {NH * hd // J} blocks of {what} (J={J}) cannot "
                         "all be resident on the card (shared memory or occupancy)")
    if err != 0:
        raise RuntimeError(f"slstm {what} launch failed: CUDA error {err}")


def _check_inputs(x_pre: torch.Tensor, r: torch.Tensor) -> int:
    """Raise on what the kernel does not take; return J."""
    if x_pre.dtype not in _ENTRY:
        raise ValueError(f"slstm: unsupported dtype {x_pre.dtype}")
    if r.dtype != x_pre.dtype or r.device != x_pre.device:
        raise ValueError("slstm: x_pre and r must share dtype and device")
    if x_pre.dim() != 4 or r.dim() != 3:
        raise ValueError("slstm: x_pre (B, T, NH, 4hd) and r (NH, hd, 4hd); got "
                         f"{tuple(x_pre.shape)}, {tuple(r.shape)}")
    B, T, NH, hd4 = x_pre.shape
    hd = r.shape[1]
    if tuple(r.shape) != (NH, hd, 4 * hd) or hd4 != 4 * hd or hd == 0:
        raise ValueError(f"slstm: x_pre {tuple(x_pre.shape)} and r {tuple(r.shape)} "
                         "disagree on heads or head width")
    if not 1 <= B <= MAX_B:
        raise ValueError(f"slstm: batch {B} outside the kernel's 1..{MAX_B}")
    if not (x_pre.is_contiguous() and r.is_contiguous()):
        raise ValueError("slstm: x_pre and r must be contiguous")
    n_sm = torch.cuda.get_device_properties(x_pre.device).multi_processor_count
    return pick_units(B, NH, hd, n_sm)


def _launch(x_pre: torch.Tensor, r: torch.Tensor,
            state: Optional[ref.State]) -> Tuple[torch.Tensor, ref.State]:
    global launches
    J = _check_inputs(x_pre, r)
    B, T, NH, hd4 = x_pre.shape
    hd = hd4 // 4
    if T >= 2**31 or T * (hd // J) >= 2**32:   # a head's barrier counts to T·hd/J
        raise ValueError(f"slstm: {T} steps outside the kernel's range")
    dev = x_pre.device
    h0, c, n, m = state if state is not None else ref.init_state(B, NH, hd, dev)
    if any(tuple(s.shape) != (B, NH, hd) for s in (h0, c, n, m)):
        raise ValueError(f"slstm: state leaves must be (B, NH, hd) = {(B, NH, hd)}")
    hbuf = torch.empty((2, B, NH, hd), dtype=torch.float32, device=dev)
    hbuf[0] = h0
    # the kernel overwrites c, n, m with the final state: f32 copies
    c, n, m = (torch.empty((B, NH, hd), device=dev).copy_(s) for s in (c, n, m))
    out = torch.empty((B, T, NH, hd), dtype=x_pre.dtype, device=dev)
    h_last = torch.empty((B, NH, hd), dtype=torch.float32, device=dev)
    bar = torch.zeros(NH, dtype=torch.int32, device=dev)
    err = getattr(_lib(), _ENTRY[x_pre.dtype])(
        x_pre.data_ptr(), r.data_ptr(), out.data_ptr(), hbuf.data_ptr(),
        c.data_ptr(), n.data_ptr(), m.data_ptr(), h_last.data_ptr(), bar.data_ptr(),
        B, T, NH, hd, J, torch.cuda.current_stream(dev).cuda_stream)
    _check(err, "the recurrence", J, NH, hd)
    launches += 1
    return out, (h_last, c, n, m)


def slstm_scan(x_pre: torch.Tensor, r: torch.Tensor,
               state: Optional[ref.State] = None) -> Tuple[torch.Tensor, ref.State]:
    """x_pre (B, T, NH, 4·hd) pre-activations, gates z, i, f, o within each
    head; r (NH, hd, 4·hd) of x_pre's dtype (f32 or bf16); state (h, c, n,
    m) f32 (B, NH, hd), zeros and m = −1e30 if None. Returns h (B, T, NH,
    hd) in x_pre's dtype and the final state, f32."""
    if x_pre.device.type == "cpu":
        h, st = ref.slstm_scan(x_pre, r, state)
        return h.to(x_pre.dtype), st
    if x_pre.device.type != "cuda":
        raise ValueError(f"slstm: unsupported device {x_pre.device}")
    return _launch(x_pre, r, state)


def barrier_floor(batch: int, steps: int, n_heads: int, head_dim: int,
                  dtype: torch.dtype, device) -> None:
    """Launch the kernel's per-step barrier alone, `steps` − 1 times, on the
    grid of an `slstm_scan` call of that shape: the recurrence's latency
    floor, for timing. Not counted in `launches`."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    J = pick_units(batch, n_heads, head_dim, n_sm)
    bar = torch.zeros(n_heads, dtype=torch.int32, device=device)
    err = _lib().slstm_barrier_loop(
        bar.data_ptr(), batch, steps, n_heads, head_dim, J,
        dtype.itemsize,
        torch.cuda.current_stream(device).cuda_stream)
    _check(err, "the barrier loop", J, n_heads, head_dim)
