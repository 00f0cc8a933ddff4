"""Dispatch for the sLSTM recurrence.

`slstm_scan` is the wrapper: tensors on the CPU run the plain version
(`ref.slstm_scan`); tensors on a CUDA device launch one of the two
hand-written kernels of `csrc/slstm.cu` by dtype, or raise — there is no
fallback. `launches` counts launches of either kernel, `tc_launches`
those of the bf16 one alone. A kernel takes at most `MAX_B` batch rows;
a larger batch runs as one launch per slice of at most `MAX_B` rows
(`batch_slices`), each counted: batch rows are independent.

bf16: one thread-block cluster of CL blocks per head (256 threads each),
block rank r owning the J = hd/CL hidden units from r·J, their gate
columns of R held in registers as the A operand of the tensor cores, h
exchanged between the cluster's blocks through distributed shared
memory; `tc_plan` chooses CL and J. Heads are independent clusters, so
they need not be resident together; at least one cluster must fit.

f32: a persistent kernel launched cooperatively: NH·hd/J blocks of 256
threads, block (head, j0) owning J hidden units of one head and its
hd × 4J slice of R in shared memory; every block must be resident at
once, and `pick_units` chooses the smallest J whose grid fits the card's
SMs (one block each).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.slstm import ref

launches = 0      # kernel launches since the last reset (a plain counter)
tc_launches = 0   # of which the bf16 cluster kernel's

MAX_B = 16          # batch rows a launch takes
THREADS = 256       # threads per block
_TOO_LARGE = 720    # cudaErrorCooperativeLaunchTooLarge
_NO_CLUSTER = -1    # the bf16 entry's "no cluster of CL blocks fits"

TC_MAX_HD = 512       # the bf16 kernel is compiled for hd = 16, 32, ..., 512
TC_CLUSTERS = (1, 2, 4, 8, 16)   # cluster sizes, 16 non-portable
TC_MAX_FRAGS = 32     # R^T's 16x16 A fragments a warp: 128 registers a thread

_P = ctypes.c_void_p
_I = ctypes.c_int
DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(_build.library("slstm"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entries' signatures on a loaded build of `csrc/slstm.cu`."""
    sigs = {"slstm_f32": [_P] * 9 + [_I] * 5 + [_P],
            "slstm_barrier_loop": [_P] + [_I] * 5 + [_P],
            "slstm_tc": [_P] * 8 + [_I] * 6 + [_P],
            "slstm_tc_exchange_loop": [_I] * 6 + [_P],
            "slstm_tc_max_clusters": [_I] * 5 + [ctypes.POINTER(_I)]}
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def tc_plan(batch: int, head_dim: int) -> Tuple[int, int]:
    """(CL, J) of the bf16 kernel: the smallest cluster CL in 1, 2, 4, 8,
    16 whose J = hd/CL units a block are a multiple of 8 (16-byte runs of
    h and x_pre) and whose share of Rᵀ a warp — ⌈J/32⌉ m-tiles of 16 gate
    columns × hd/16 k-steps — is at most 32 fragments, so that R stays in
    registers. hd must be a multiple of 16 up to 512, B (a launch's
    slice) 1..16. Mirrors
    `tc::plan` in `csrc/slstm.cu`."""
    if not 1 <= batch <= MAX_B:
        raise ValueError(f"slstm: batch {batch} outside the kernel's 1..{MAX_B}")
    if head_dim % 16 or not 16 <= head_dim <= TC_MAX_HD:
        raise ValueError(f"slstm: bf16 head width {head_dim} is not one of the "
                         f"kernel's multiples of 16 up to {TC_MAX_HD}")
    for cl in TC_CLUSTERS:
        J = head_dim // cl
        if head_dim % cl == 0 and J % 8 == 0 and -(-J // 32) * (head_dim // 16) <= TC_MAX_FRAGS:
            return cl, J
    raise ValueError(f"slstm: no cluster split of a bf16 head of hd={head_dim} keeps R "
                     "in registers")


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


def _check_inputs(x_pre: torch.Tensor, r: torch.Tensor,
                  state: Optional[ref.State]) -> None:
    """Raise on what neither kernel takes."""
    if x_pre.dtype not in DTYPES:
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
    if B < 1:
        raise ValueError(f"slstm: batch {B} is empty")
    if not (x_pre.is_contiguous() and r.is_contiguous()):
        raise ValueError("slstm: x_pre and r must be contiguous")
    if T >= 2**31:
        raise ValueError(f"slstm: {T} steps outside the kernel's range")
    if state is not None and any(tuple(s.shape) != (B, NH, hd) for s in state):
        raise ValueError(f"slstm: state leaves must be (B, NH, hd) = {(B, NH, hd)}")


def _state(state: Optional[ref.State], B: int, NH: int, hd: int, dev) -> ref.State:
    """(h0, c, n, m): h0 as given, f32 copies of c, n and m (the kernels
    overwrite them with the final state). `_check_inputs` checked the
    shapes."""
    h0, c, n, m = state if state is not None else ref.init_state(B, NH, hd, dev)
    c, n, m = (torch.empty((B, NH, hd), device=dev).copy_(s) for s in (c, n, m))
    return h0, c, n, m


def _launch_tc(x_pre: torch.Tensor, r: torch.Tensor,
               state: Optional[ref.State]) -> Tuple[torch.Tensor, ref.State]:
    global launches, tc_launches
    B, T, NH, hd4 = x_pre.shape
    hd = hd4 // 4
    CL, J = tc_plan(B, hd)
    if x_pre.data_ptr() % 16:
        raise ValueError("slstm: bf16 x_pre must start 16-byte aligned (the kernel "
                         "reads it in 16-byte copies)")
    dev = x_pre.device
    h0, c, n, m = _state(state, B, NH, hd, dev)
    h0 = h0.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty((B, T, NH, hd), dtype=x_pre.dtype, device=dev)
    h_last = torch.empty((B, NH, hd), dtype=torch.float32, device=dev)
    err = _lib().slstm_tc(
        x_pre.data_ptr(), r.data_ptr(), out.data_ptr(), h0.data_ptr(), c.data_ptr(),
        n.data_ptr(), m.data_ptr(), h_last.data_ptr(), B, T, NH, hd, CL, J,
        torch.cuda.current_stream(dev).cuda_stream)
    _check_tc(err, "the recurrence", CL, hd)
    launches += 1
    tc_launches += 1
    return out, (h_last, c, n, m)


def _check_tc(err: int, what: str, CL: int, hd: int) -> None:
    if err == _NO_CLUSTER:
        raise ValueError(f"slstm: not one cluster of {CL} blocks for {what} (hd={hd}) "
                         "fits on the card")
    if err != 0:
        raise RuntimeError(f"slstm {what} launch failed: CUDA error {err}")


def _launch(x_pre: torch.Tensor, r: torch.Tensor,
            state: Optional[ref.State]) -> Tuple[torch.Tensor, ref.State]:
    global launches
    B, T, NH, hd4 = x_pre.shape
    hd = hd4 // 4
    n_sm = torch.cuda.get_device_properties(x_pre.device).multi_processor_count
    J = pick_units(B, NH, hd, n_sm)
    if T * (hd // J) >= 2**32:   # a head's barrier counts to T·hd/J
        raise ValueError(f"slstm: {T} steps outside the kernel's range")
    dev = x_pre.device
    h0, c, n, m = _state(state, B, NH, hd, dev)
    hbuf = torch.empty((2, B, NH, hd), dtype=torch.float32, device=dev)
    hbuf[0] = h0
    out = torch.empty((B, T, NH, hd), dtype=x_pre.dtype, device=dev)
    h_last = torch.empty((B, NH, hd), dtype=torch.float32, device=dev)
    bar = torch.zeros(NH, dtype=torch.int32, device=dev)
    err = _lib().slstm_f32(
        x_pre.data_ptr(), r.data_ptr(), out.data_ptr(), hbuf.data_ptr(),
        c.data_ptr(), n.data_ptr(), m.data_ptr(), h_last.data_ptr(), bar.data_ptr(),
        B, T, NH, hd, J, torch.cuda.current_stream(dev).cuda_stream)
    _check(err, "the recurrence", J, NH, hd)
    launches += 1
    return out, (h_last, c, n, m)


def batch_slices(batch: int) -> List[slice]:
    """The batch rows of each launch: slices of at most MAX_B rows, in
    order, ⌈batch / MAX_B⌉ of them."""
    return [slice(b, min(b + MAX_B, batch)) for b in range(0, batch, MAX_B)]


Launch = Callable[[torch.Tensor, torch.Tensor, Optional[ref.State]],
                  Tuple[torch.Tensor, ref.State]]


def run_sliced(launch: Launch, x_pre: torch.Tensor, r: torch.Tensor,
               state: Optional[ref.State]) -> Tuple[torch.Tensor, ref.State]:
    """`launch` once per slice of `batch_slices`, on x_pre's rows (a
    contiguous view: batch leads) and the state's; h and the final state
    concatenated back along the batch."""
    parts = [launch(x_pre[s], r, None if state is None else tuple(t[s] for t in state))
             for s in batch_slices(x_pre.shape[0])]
    if len(parts) == 1:
        return parts[0]
    h = torch.cat([p[0] for p in parts])
    return h, tuple(torch.cat([p[1][i] for p in parts]) for i in range(4))


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
    _check_inputs(x_pre, r, state)
    return run_sliced(_launch_tc if x_pre.dtype == torch.bfloat16 else _launch,
                      x_pre, r, state)


def barrier_floor(batch: int, steps: int, n_heads: int, head_dim: int,
                  dtype: torch.dtype, device) -> None:
    """Launch the step's synchronisation alone, `steps` − 1 times, as an
    `slstm_scan` call of that shape and dtype would run it: for bf16 the
    exchange of h through distributed shared memory and each block's wait
    for it, on the same clusters; for f32 the counter barrier on the same
    cooperative grid. The recurrence's latency floor, for timing. Not
    counted in `launches`."""
    stream = torch.cuda.current_stream(device).cuda_stream
    if dtype == torch.bfloat16:
        CL, J = tc_plan(batch, head_dim)
        err = _lib().slstm_tc_exchange_loop(batch, steps, n_heads, head_dim, CL, J, stream)
        _check_tc(err, "the exchange loop", CL, head_dim)
        return
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    J = pick_units(batch, n_heads, head_dim, n_sm)
    bar = torch.zeros(n_heads, dtype=torch.int32, device=device)
    err = _lib().slstm_barrier_loop(bar.data_ptr(), batch, steps, n_heads, head_dim, J,
                                    stream)
    _check(err, "the barrier loop", J, n_heads, head_dim)


def max_active_clusters(batch: int, n_heads: int, head_dim: int, device) -> int:
    """cudaOccupancyMaxActiveClusters for the bf16 kernel at that shape:
    how many of its clusters (one a head) the card holds at once."""
    CL, J = tc_plan(batch, head_dim)
    with torch.cuda.device(device):
        n = ctypes.c_int(0)
        err = _lib().slstm_tc_max_clusters(batch, n_heads, head_dim, CL, J,
                                           ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"slstm: cluster occupancy query failed: CUDA error {err}")
    return n.value
