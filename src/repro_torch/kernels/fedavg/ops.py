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
        fn.argtypes = [_P, ctypes.c_longlong, ctypes.c_longlong, _P, _P,
                       ctypes.c_int, ctypes.c_int, ctypes.c_longlong, _P]
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
