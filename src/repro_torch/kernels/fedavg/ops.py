"""Dispatch for the weighted FedAvg aggregation.

`weighted_aggregate` is the wrapper, a `torch.library` custom op: a
stack on the CPU runs the plain version (`ref.weighted_aggregate`); a
stack on a CUDA device launches the hand-written kernel
(`csrc/fedavg.cu`) or raises — there is no fallback. `launches` counts
kernel launches.

Under `torch.func.vmap` (a campaign grid's cell axis) the op's vmap rule
calls `weighted_aggregate_batched` on the (C, K, ...) stack and (C, K)
weights: one launch of the kernel over the cell axis on the card,
the batched plain version on the CPU. Each cell's sum runs in the order
of its own launch, so batched and single results are bitwise equal.

`weighted_aggregate_indexed` is the FedAvg of K rows picked by index
from an (S, P) stack (`select_aggregate`'s after the selection): on the
card one launch of `fedavg_indexed` (`csrc/fedavg.cu`), which reads the
rows in place and writes the aggregate and the (S,) mask of the live
slots; on the CPU the plain `ref.weighted_aggregate_indexed` and
`mask_from_slots`. It counts in `launches` and in `indexed_launches`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fedavg import ref
from repro_torch.kernels.rewafl_select.ref import mask_from_slots

launches = 0   # kernel launches since the last reset (a plain counter)
indexed_launches = 0   # of them, fedavg_indexed's

# fedavg_indexed is launched with programmatic dependent launch: it may
# start while the selection kernel before it finishes
# (`tools/select_aggregate/pdl_turns.py` times both settings)
PDL = True

_P = ctypes.c_void_p
_ENTRY = {torch.float32: "fedavg_f32", torch.bfloat16: "fedavg_bf16"}
_IX_ENTRY = {torch.float32: "fedavg_indexed_f32",
             torch.bfloat16: "fedavg_indexed_bf16"}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("fedavg")
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [_P, ctypes.c_longlong, ctypes.c_longlong, _P, _P,
                       ctypes.c_int, ctypes.c_int, ctypes.c_longlong, _P]
        fn.restype = ctypes.c_int
    for name in _IX_ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [_P, ctypes.c_longlong, _P, _P, _P, _P, _P, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P]
        fn.restype = ctypes.c_int
    return lib


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """C aggregations of a (C, K, ...) stack with (C, K) weights, one
    launch (a single aggregation is C = 1)."""
    global launches
    if x.dtype not in _ENTRY:
        raise ValueError(f"fedavg: unsupported dtype {x.dtype}")
    if x.dim() < 2:
        raise ValueError(f"fedavg: stack must be (C, K, ...), got {tuple(x.shape)}")
    C, K = x.shape[:2]
    if (w.device != x.device or w.dtype != torch.float32
            or w.shape != (C, K) or not w.is_contiguous()):
        raise ValueError(f"fedavg: weights must be a contiguous ({C}, {K}) "
                         f"float32 tensor on {x.device}")
    if not 1 <= C <= 65535:
        raise ValueError(f"fedavg: {C} cells outside the kernel's [1, 65535]")
    if x.dim() == 3 and x.stride(2) == 1:
        flat = x                  # (C, K, P) rows, possibly with padded stride
    elif x.is_contiguous():
        flat = x.reshape(C, K, -1)
    else:
        raise ValueError("fedavg: stack must be contiguous, or (K, P) rows "
                         "with unit stride along P")
    P = flat.shape[2]
    out = torch.empty(C, P, dtype=x.dtype, device=x.device)
    err = getattr(_lib(), _ENTRY[x.dtype])(
        flat.data_ptr(), flat.stride(1), flat.stride(0), w.data_ptr(),
        out.data_ptr(), C, K, P, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fedavg kernel launch failed: CUDA error {err}")
    launches += 1
    return out.reshape((C,) + x.shape[2:])


def indexed_rows(stack: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The (S, P) rows `fedavg_indexed` reads of an (S, ...) stack on the
    card, with (S,) f32 weights; raises on what the kernel does not take."""
    if stack.dtype not in _IX_ENTRY:
        raise ValueError(f"fedavg_indexed: unsupported dtype {stack.dtype}")
    if stack.dim() < 1 or not 1 <= stack.shape[0] < 2**31:
        raise ValueError(f"fedavg_indexed: stack must be (S, ...) with 1 <= S "
                         f"< 2**31, got {tuple(stack.shape)}")
    S = stack.shape[0]
    if (weights.device != stack.device or weights.dtype != torch.float32
            or weights.shape != (S,) or not weights.is_contiguous()):
        raise ValueError(f"fedavg_indexed: weights must be a contiguous ({S},) "
                         f"float32 tensor on {stack.device}")
    if stack.dim() == 2 and stack.stride(1) == 1:
        return stack              # (S, P) rows, possibly with padded stride
    if stack.is_contiguous():
        return stack.reshape(S, -1)
    raise ValueError("fedavg_indexed: stack must be contiguous, or (S, P) rows "
                     "with unit stride along P")


def launch_indexed(rows: torch.Tensor, idx: torch.Tensor, live: torch.Tensor,
                   weights: torch.Tensor, pdl: bool, stream: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of `fedavg_indexed` on `indexed_rows`' (S, P) rows:
    ((P,) f32 aggregate, (S,) bool mask). `pdl`: programmatic dependent
    launch after the kernel before it on `stream`."""
    global launches, indexed_launches
    S, P = rows.shape
    K = idx.shape[0] if idx.dim() == 1 else -1
    for name, t in (("idx", idx), ("live", live)):
        if (t.device != rows.device or t.dtype != torch.int32 or t.shape != (K,)
                or not t.is_contiguous()):
            raise ValueError(f"fedavg_indexed: {name} must be a contiguous (K,) "
                             f"int32 tensor on {rows.device}, like idx")
    if not 1 <= K < 2**31:
        raise ValueError(f"fedavg_indexed: K={K} slots; the kernel takes 1 or more")
    out = torch.empty(P, dtype=torch.float32, device=rows.device)
    mask = torch.empty(S, dtype=torch.bool, device=rows.device)
    err = getattr(_lib(), _IX_ENTRY[rows.dtype])(
        rows.data_ptr(), rows.stride(0), idx.data_ptr(), live.data_ptr(),
        weights.data_ptr(), out.data_ptr(), mask.data_ptr(), K, P, S, int(pdl),
        stream)
    if err != 0:
        raise RuntimeError(f"fedavg_indexed kernel launch failed: CUDA error {err}")
    launches += 1
    indexed_launches += 1
    return out, mask


@torch.library.custom_op("repro_torch::fedavg", mutates_args=(),
                         device_types="cpu")
def _fedavg(stack: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    return ref.weighted_aggregate(stack, weights)


@_fedavg.register_kernel("cuda")
def _(stack, weights):
    return _launch(stack[None], weights[None])[0]


@_fedavg.register_fake
def _(stack, weights):
    return stack.new_empty(stack.shape[1:])


@torch.library.custom_op("repro_torch::fedavg_batched", mutates_args=(),
                         device_types="cpu")
def _fedavg_batched(stack: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    return ref.weighted_aggregate_batched(stack, weights)


@_fedavg_batched.register_kernel("cuda")
def _(stack, weights):
    return _launch(stack, weights)


@_fedavg_batched.register_fake
def _(stack, weights):
    return stack.new_empty(stack.shape[:1] + stack.shape[2:])


def _leading(x: torch.Tensor, dim, n: int) -> torch.Tensor:
    """`x` with its vmap batch dim `dim` (None: unbatched, expanded) moved
    to the front, contiguous."""
    x = x.unsqueeze(0).expand(n, *x.shape) if dim is None else x.movedim(dim, 0)
    return x.contiguous()


def _fedavg_vmap(info, in_dims, stack, weights):
    n = info.batch_size
    return _fedavg_batched(_leading(stack, in_dims[0], n),
                           _leading(weights, in_dims[1], n)), 0


def _fedavg_batched_vmap(info, in_dims, stack, weights):
    # a second batch level: fold it into the cells
    n = info.batch_size
    s, w = _leading(stack, in_dims[0], n), _leading(weights, in_dims[1], n)
    out = _fedavg_batched(s.flatten(0, 1), w.flatten(0, 1))
    return out.unflatten(0, (n, s.shape[1])), 0


_fedavg.register_vmap(_fedavg_vmap)
_fedavg_batched.register_vmap(_fedavg_batched_vmap)


def _check_device(x: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fedavg: unsupported device {x.device}")


def weighted_aggregate(stack: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """out = Σ_k w_k·stack[k] for stack (K, ...) f32 or bf16 and weights
    (K,) f32; f32 accumulation, output in the stack's dtype."""
    _check_device(stack)
    return _fedavg(stack, weights)


def weighted_aggregate_batched(stack: torch.Tensor,
                               weights: torch.Tensor) -> torch.Tensor:
    """out[c] = Σ_k w[c, k]·stack[c, k] for stack (C, K, ...) and weights
    (C, K): C aggregations in one launch on the card."""
    _check_device(stack)
    return _fedavg_batched(stack, weights)


def weighted_aggregate_indexed(stack: torch.Tensor, idx: torch.Tensor,
                               live: torch.Tensor, weights: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The FedAvg of the K rows `idx` (int32, each in [0, S); live flags `live`,
    dead slots index 0) of an (S, ...) f32 or bf16 stack, weighted by
    `weights` (S,) f32 over the live slots and normalised by max(Σ, 1e-9):
    (f32 aggregate of the row shape, (S,) bool mask of the live slots).
    The rows are read in place; on the card one launch."""
    _check_device(stack)
    if stack.device.type == "cpu":
        return (ref.weighted_aggregate_indexed(stack, idx, live, weights),
                mask_from_slots(idx, live, stack.shape[0]))
    out, mask = launch_indexed(indexed_rows(stack, weights), idx, live, weights,
                               PDL, torch.cuda.current_stream(stack.device).cuda_stream)
    return out.reshape(stack.shape[1:]), mask
