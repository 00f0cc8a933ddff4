"""Dispatch for the fused utility → top-K selection.

`select_topk` is the wrapper, a `torch.library` custom op: tensors on
the CPU run the plain version (`ref.select_topk`); tensors on a CUDA
device launch the hand-written kernel (`csrc/rewafl_select.cu`) or
raise — there is no fallback from the kernel to the plain version.
`launches` counts kernel launches (one per call that launches, whether
it runs one kernel or two; the plain version does not count).

Under `torch.func.vmap` (a seed batch of the per-method campaign path)
the op's vmap rule calls `select_topk_batched`: B selections over (B, S)
leaves in one launch on the card (one block, or one set of tile blocks
and a merging block, a selection), each bitwise the single launch's;
the batched plain version on the CPU.

The kernel takes any K <= S: up to 8,192 devices in one launch of one
block, above that in two (each tile of 8,192 devices hands on its K
smallest keys, then one block selects over them), with scratch the
wrapper allocates (`csrc/rewafl_select.cu`).

`select_mask` is the round's selection (the kernel for the Eqn-2
utility, the plain ranking for precomputed scores); `select_aggregate`
the reference's fused select → gather → FedAvg pass: on the card this
kernel, then `fedavg_indexed`, which reads the K selected rows in place
and writes the aggregate and the mask (two launches, three above 8,192
devices).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core import selection as sel
from repro_torch.core import utility as util
from repro_torch.kernels import _build
from repro_torch.kernels.fedavg import ops as fedavg_ops
from repro_torch.kernels.rewafl_select import ref

launches = 0   # kernel launches since the last reset (a plain counter)

_P = ctypes.c_void_p


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("rewafl_select")
    lib.rewafl_select.argtypes = (
        [_P] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3 + [_P] * 4)
    lib.rewafl_select.restype = ctypes.c_int
    lib.rewafl_select_scratch.argtypes = [ctypes.c_int] * 3
    lib.rewafl_select_scratch.restype = ctypes.c_longlong
    return lib


def _launch(available, ui, rnd, *, k_exploit, k_explore, T_round, alpha, beta):
    """B selections over (B, S) leaves, one launch (a single selection is
    B = 1)."""
    global launches
    B, S = available.shape
    K = k_exploit + k_explore
    leaves = tuple(ui) + ((rnd,) if k_explore > 0 else ())
    dev = available.device
    for x in leaves:
        if (x.device != dev or x.dtype != torch.float32 or x.shape != (B, S)
                or not x.is_contiguous()):
            raise ValueError("rewafl_select: every leaf must be a contiguous "
                             f"(S,) float32 tensor (({B}, {S}) batched) on {dev}")
    if available.dtype != torch.bool or not available.is_contiguous():
        raise ValueError("rewafl_select: `available` must be a contiguous "
                         "bool tensor")
    if k_exploit < 0 or k_explore < 0 or not 1 <= K <= S:
        raise ValueError(f"rewafl_select: K={K} ({k_exploit} + {k_explore}) "
                         f"outside [1, S={S}]")
    if not 1 <= B <= 65535:
        raise ValueError(f"rewafl_select: {B} selections outside [1, 65535]")
    lib = _lib()
    scratch = torch.empty(B * lib.rewafl_select_scratch(S, k_exploit, k_explore),
                          dtype=torch.int64, device=dev)
    idx = torch.empty(B, K, dtype=torch.int32, device=dev)
    live = torch.empty(B, K, dtype=torch.int32, device=dev)
    r = rnd if k_explore > 0 else ui.stat   # not read when k_explore == 0
    # `scratch` returns to PyTorch's caching allocator when this returns;
    # its reuse is ordered on this stream, after the kernel
    err = lib.rewafl_select(
        *(x.data_ptr() for x in ui), available.data_ptr(), r.data_ptr(), B,
        S, k_exploit, k_explore, T_round, alpha, beta,
        scratch.data_ptr(), idx.data_ptr(), live.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rewafl_select kernel launch failed: CUDA error {err}")
    launches += 1
    return idx, live


# the op's arguments: the five Eqn-2 leaves, the availability, the
# explore draw (None when k_explore is 0) and the Python constants
@torch.library.custom_op("repro_torch::rewafl_select", mutates_args=(),
                         device_types="cpu")
def _select(stat: torch.Tensor, t: torch.Tensor, e: torch.Tensor,
            residual: torch.Tensor, e0: torch.Tensor, available: torch.Tensor,
            rnd: Optional[torch.Tensor], k_exploit: int, k_explore: int,
            T_round: float, alpha: float, beta: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    return ref.select_topk(available, util.UtilityInputs(stat, t, e, residual, e0),
                           rnd, k_exploit=k_exploit, k_explore=k_explore,
                           T_round=T_round, alpha=alpha, beta=beta)


@_select.register_kernel("cuda")
def _(stat, t, e, residual, e0, available, rnd, k_exploit, k_explore, T_round,
      alpha, beta):
    idx, live = _launch(available[None],
                        util.UtilityInputs(*(x[None] for x in (stat, t, e, residual, e0))),
                        None if rnd is None else rnd[None], k_exploit=k_exploit,
                        k_explore=k_explore, T_round=T_round, alpha=alpha, beta=beta)
    return idx[0], live[0]


@_select.register_fake
def _(stat, t, e, residual, e0, available, rnd, k_exploit, k_explore, T_round,
      alpha, beta):
    K = k_exploit + k_explore
    return (stat.new_empty(K, dtype=torch.int32),
            stat.new_empty(K, dtype=torch.int32))


@torch.library.custom_op("repro_torch::rewafl_select_batched", mutates_args=(),
                         device_types="cpu")
def _select_batched(stat: torch.Tensor, t: torch.Tensor, e: torch.Tensor,
                    residual: torch.Tensor, e0: torch.Tensor,
                    available: torch.Tensor, rnd: Optional[torch.Tensor],
                    k_exploit: int, k_explore: int, T_round: float,
                    alpha: float, beta: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    return ref.select_topk_batched(
        available, util.UtilityInputs(stat, t, e, residual, e0), rnd,
        k_exploit=k_exploit, k_explore=k_explore, T_round=T_round,
        alpha=alpha, beta=beta)


@_select_batched.register_kernel("cuda")
def _(stat, t, e, residual, e0, available, rnd, k_exploit, k_explore, T_round,
      alpha, beta):
    return _launch(available, util.UtilityInputs(stat, t, e, residual, e0), rnd,
                   k_exploit=k_exploit, k_explore=k_explore, T_round=T_round,
                   alpha=alpha, beta=beta)


@_select_batched.register_fake
def _(stat, t, e, residual, e0, available, rnd, k_exploit, k_explore, T_round,
      alpha, beta):
    shape = (stat.shape[0], k_exploit + k_explore)
    return (stat.new_empty(shape, dtype=torch.int32),
            stat.new_empty(shape, dtype=torch.int32))


def _leading(x: Optional[torch.Tensor], dim, n: int) -> Optional[torch.Tensor]:
    """`x` with its vmap batch dim `dim` (None: unbatched, expanded) in
    front, contiguous; None stays None."""
    if x is None:
        return None
    x = x.unsqueeze(0).expand(n, *x.shape) if dim is None else x.movedim(dim, 0)
    return x.contiguous()


def _select_vmap(info, in_dims, *args):
    n = info.batch_size
    tensors = [_leading(x, d, n) for x, d in zip(args[:7], in_dims[:7])]
    return _select_batched(*tensors, *args[7:]), (0, 0)


def _select_batched_vmap(info, in_dims, *args):
    # a second batch level: fold it into the selections
    n = info.batch_size
    tensors = [_leading(x, d, n) for x, d in zip(args[:7], in_dims[:7])]
    inner = tensors[0].shape[1]
    idx, live = _select_batched(
        *(None if x is None else x.flatten(0, 1) for x in tensors), *args[7:])
    return (idx.unflatten(0, (n, inner)), live.unflatten(0, (n, inner))), (0, 0)


_select.register_vmap(_select_vmap)
_select_batched.register_vmap(_select_batched_vmap)


def _consts(available, k_exploit, k_explore, T_round, alpha, beta):
    if available.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rewafl_select: unsupported device {available.device}")
    return (int(k_exploit), int(k_explore), float(T_round), float(alpha),
            float(beta))


def select_topk(available: torch.Tensor, ui: util.UtilityInputs,
                rnd: Optional[torch.Tensor], *, k_exploit: int, k_explore: int,
                T_round: float, alpha: float, beta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """((K,) int32 device indices, (K,) int32 live flags) of the ε-greedy
    top-K by the Eqn-2 utility: exploit slots first, then explore slots
    drawn by `rnd` among the rest; each half in rank order, ties to the
    lower index, dead slots (index 0, live 0)."""
    return _select(*ui, available, rnd if k_explore > 0 else None,
                   *_consts(available, k_exploit, k_explore, T_round, alpha, beta))


def select_topk_batched(available: torch.Tensor, ui: util.UtilityInputs,
                        rnd: Optional[torch.Tensor], *, k_exploit: int,
                        k_explore: int, T_round: float, alpha: float,
                        beta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """`select_topk` of B selections over (B, S) leaves: ((B, K), (B, K)),
    one launch on the card."""
    return _select_batched(*ui, available, rnd if k_explore > 0 else None,
                           *_consts(available, k_exploit, k_explore, T_round, alpha, beta))


def select_mask(u: Optional[torch.Tensor], k: int, available: torch.Tensor,
                eps: float, *, scores: Optional[torch.Tensor] = None,
                ui: Optional[util.UtilityInputs] = None, T_round: float = 1.0,
                alpha: float = 1.0, beta: float = 1.0) -> torch.Tensor:
    """(S,) ε-greedy selection mask, scored by exactly one of:

    * `ui`: the Eqn-2 utility computed from the five leaves, through the
      selection kernel (the `rea` selector);
    * `scores`: a precomputed (S,) utility (the oort and autofl
      selectors), ranked by the plain `selection.epsilon_greedy` on
      either device, as the reference ranks it with `lax.top_k` outside
      any kernel.

    `u` is the (S,) uniform explore draw (unused at ε = 0)."""
    if (scores is None) == (ui is None):
        raise ValueError("select_mask: pass exactly one of `scores` and `ui`")
    if scores is not None:
        return sel.epsilon_greedy(u, scores, k, available, eps)
    S = available.shape[-1]
    k_eff = min(k, S)
    if k_eff <= 0:
        return torch.zeros_like(available)
    k_explore = sel._explore_slots(eps, k_eff)
    idx, live = select_topk(available, ui, u, k_exploit=k_eff - k_explore,
                            k_explore=k_explore, T_round=T_round,
                            alpha=alpha, beta=beta)
    return ref.mask_from_slots(idx, live, S)


def select_traced(u: torch.Tensor, scores: torch.Tensor, k: int,
                  available: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """(S,) ε-greedy mask with a tensor ε (`MethodParams.exploration`),
    the campaign grid's selection: precomputed `scores` of any selector
    ranked by the plain fused rank-space emission on either device, as
    the reference's `select_traced` reaches no kernel."""
    return sel.epsilon_greedy_traced_fused(u, scores, k, available, eps)


def select_aggregate(u: Optional[torch.Tensor], k: int, available: torch.Tensor,
                     eps: float, ui: util.UtilityInputs, deltas: torch.Tensor,
                     weights: torch.Tensor, *, T_round: float, alpha: float,
                     beta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused pass: Eqn-2 utility → ε-greedy top-K → weight-normalised
    FedAvg of the K selected rows of the (S, ...) `deltas` stack. Returns
    ((S,) bool mask, f32 aggregate of the row shape).

    On the card two kernels and no op between them: the selection kernel
    writes (K,) idx and live flags, then `fedavg_indexed` reads the K
    rows in place by index (K·P bytes, not S·P), weights them by their
    weights times live, normalised by max(Σ, 1e-9), and writes the
    aggregate and the mask; it is launched with programmatic dependent
    launch (`fedavg.ops.PDL`). Each wrapper counts its launch. CPU
    tensors run the plain selection and `weighted_aggregate_indexed`'s
    plain version. Nothing is selected and the aggregate is zero when
    k ≤ 0."""
    S = available.shape[-1]
    k_eff = min(k, S)
    if k_eff <= 0:
        return (torch.zeros_like(available),
                deltas.new_zeros(deltas.shape[1:], dtype=torch.float32))
    k_explore = sel._explore_slots(eps, k_eff)
    kx, kr, T_round, alpha, beta = _consts(available, k_eff - k_explore,
                                           k_explore, T_round, alpha, beta)
    kw = dict(k_exploit=kx, k_explore=kr, T_round=T_round, alpha=alpha, beta=beta)
    rnd = u if k_explore > 0 else None
    if available.device.type == "cuda":
        mask, agg = aggregate_launches(available, ui, rnd, deltas, weights,
                                       pdl=fedavg_ops.PDL, **kw)
        return mask, agg.reshape(deltas.shape[1:])
    idx, live = ref.select_topk(available, ui, rnd, **kw)
    agg, mask = fedavg_ops.weighted_aggregate_indexed(deltas, idx, live, weights)
    return mask, agg


def aggregate_launches(available: torch.Tensor, ui: util.UtilityInputs,
                       rnd: Optional[torch.Tensor], deltas: torch.Tensor,
                       weights: torch.Tensor, *, pdl: bool, **kw
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`select_aggregate`'s two calls on the card: the selection, then
    `fedavg_indexed` on its slots, with programmatic dependent launch or
    without (`pdl`). Returns ((S,) mask, (P,) f32 aggregate)."""
    rows = fedavg_ops.indexed_rows(deltas, weights)   # raises before a launch
    if rows.shape[0] != available.shape[-1] or rows.device != available.device:
        raise ValueError(f"select_aggregate: {rows.shape[0]} delta rows on "
                         f"{rows.device} for {available.shape[-1]} devices on "
                         f"{available.device}")
    idx, live = _launch(available[None], util.UtilityInputs(*(x[None] for x in ui)),
                        None if rnd is None else rnd[None], **kw)
    out, mask = fedavg_ops.launch_indexed(
        rows, idx[0], live[0], weights, pdl,
        torch.cuda.current_stream(available.device).cuda_stream)
    return mask, out
