"""Mamba2 (SSD) blocks: the chunked form for prefill and the O(1)
recurrent step for decode.

The port of the reference's `nn/ssm.py`, in its parameter layout and with
its names. The reference computes Mamba2 with no Pallas kernel (a
`lax.scan` of einsums over sequence chunks), so the port is plain
PyTorch too.

Prefill runs the chunked SSD formulation. Work inside a chunk does not
depend on the other chunks, so it is computed for all chunks at once:
the (cl × cl) decay-masked mixing matrices, the diagonal blocks' output
and each chunk's own contribution to the state. Only the (B, H, P, N)
state passes from chunk to chunk in order, two ops a chunk; a loop of the
reference's whole chunk body would issue ~20 ops a chunk, ~50,000 a
full-width prefill. Decode is the exact recurrent update
state' = state·exp(−dt·A) + dt·B·x.

Value-carrying operands (x, B, C and the mixing matrix) are rounded to
the model's dtype, as the reference rounds them, and multiplied in f32:
an f32 product of bf16 operands equals the reference's bf16 product with
f32 accumulation, up to the order of the sum. Gate and decay math is f32.

Shapes: x (B, L, D); inner (B, L, H, P) with P = head_dim, state N.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.nn import layers


class Mamba2Dims(NamedTuple):
    d_model: int
    d_inner: int
    n_heads: int
    head_dim: int
    d_state: int
    d_conv: int = 4
    chunk: int = 64


def dims_for(d_model: int, d_state: int, *, expand: int = 2,
             head_dim: int = 64, d_conv: int = 4, chunk: int = 64) -> Mamba2Dims:
    d_inner = expand * d_model
    if d_inner % head_dim:
        raise ValueError(f"d_inner {d_inner} is not a multiple of head_dim {head_dim}")
    return Mamba2Dims(d_model, d_inner, d_inner // head_dim, head_dim,
                      d_state, d_conv, chunk)


def mamba2_init(gen: torch.Generator, dims: Mamba2Dims, *, dtype=torch.float32):
    """Random parameters drawn from `gen`; A_log, D and dt_bias are f32
    whatever `dtype` is, as in the reference."""
    din, H, N = dims.d_inner, dims.n_heads, dims.d_state
    conv_ch = din + 2 * N   # x, B and C all pass through the causal conv
    dev = gen.device
    return {
        # in_proj -> [z, x, B, C, dt]
        "in_proj": layers.dense_init(gen, dims.d_model, 2 * din + 2 * N + H,
                                     bias=False, dtype=dtype),
        "conv": {"w": layers.normal_init(gen, (dims.d_conv, 1, conv_ch),
                                         1.0 / math.sqrt(dims.d_conv), dtype),
                 "b": torch.zeros((conv_ch,), dtype=dtype, device=dev)},
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)),
        "D": torch.ones((H,), device=dev),
        "dt_bias": torch.zeros((H,), device=dev),
        "norm": layers.rmsnorm_init(gen, din, dtype),
        "out_proj": layers.dense_init(gen, din, dims.d_model, bias=False, dtype=dtype),
    }


def _split_in_proj(dims: Mamba2Dims, zxbcdt: torch.Tensor):
    din, N, H = dims.d_inner, dims.d_state, dims.n_heads
    return torch.split(zxbcdt, [din, din, N, N, H], dim=-1)   # z, x, B, C, dt


def _ssd_chunk_scan(xh, dtp, A, Bc, Cc, dims: Mamba2Dims,
                    init_state: Optional[torch.Tensor] = None):
    """Chunked SSD. xh (B, L, H, P); dtp (B, L, H) softplus'd; A (H,)
    positive; Bc/Cc (B, L, N).

    Returns (y (B, L, H, P) f32, final_state (B, H, P, N) f32). L must be
    a multiple of min(chunk, L): at most the chunk, or a multiple of it."""
    B, L, H, P = xh.shape
    N = Bc.shape[-1]
    cl = min(dims.chunk, L)
    if cl == 0 or L % cl:
        raise ValueError(f"Mamba2: sequence length {L} is not a multiple of the "
                         f"SSD chunk {cl} (min({dims.chunk}, L)): use at most "
                         f"{dims.chunk} tokens, or a multiple of {dims.chunk}")
    nc = L // cl
    cdt = xh.dtype if xh.dtype in (torch.bfloat16, torch.float16) else torch.float32
    # operands rounded to the model's dtype, then held in f32 (exactly)
    xc = xh.reshape(B, nc, cl, H, P).to(cdt).float()
    dtc = dtp.reshape(B, nc, cl, H).float()
    Bcc = Bc.reshape(B, nc, cl, N).to(cdt).float()
    Ccc = Cc.reshape(B, nc, cl, N).to(cdt).float()

    cums = torch.cumsum(dtc * A, dim=2)   # (B, nc, cl, H) decay within the chunk
    # intra-chunk mixing: L_ij·dt_j = exp(cum_j − cum_i + log dt_j) for i ≥ j.
    # Above the diagonal the exponent may overflow to inf: `where` drops it
    # (a 0/1 mask would give 0·inf = NaN)
    logdt = torch.log(torch.clamp_min(dtc, 1e-20))
    expo = (cums[:, :, None, :, :] - cums[:, :, :, None, :]
            + logdt[:, :, None, :, :])                    # (B, nc, i, j, H)
    tril = torch.ones((cl, cl), dtype=torch.bool, device=xh.device).tril()
    Ldt = torch.where(tril[:, :, None], torch.exp(expo), 0.0)
    CB = torch.einsum("bcin,bcjn->bcij", Ccc, Bcc)        # (B, nc, i, j)
    M = (CB[..., None] * Ldt).to(cdt).float()
    y = torch.einsum("bcijh,bcjhp->bcihp", M, xc)
    # each chunk's own contribution to the state at its end:
    # Σ_j exp(−(cum_last − cum_j))·dt_j B_j x_j
    cum_last = cums[:, :, -1, :]                           # (B, nc, H)
    wout = torch.exp(-(cum_last[:, :, None, :] - cums)) * dtc
    local = torch.einsum("bcjh,bcjhp,bcjn->bchpn", wout, xc, Bcc)
    # the state entering each chunk, carried in order
    state = (xh.new_zeros((B, H, P, N), dtype=torch.float32) if init_state is None
             else init_state.float())
    decay = torch.exp(-cum_last)[..., None, None]          # (B, nc, H, 1, 1)
    states_in = []
    for c in range(nc):
        states_in.append(state)
        state = decay[:, c] * state + local[:, c]
    s_in = torch.stack(states_in, dim=1)                   # (B, nc, H, P, N)
    # the carried state's share of the output: C_i exp(−cum_i) state
    y_off = torch.einsum("bcin,bchpn->bcihp", Ccc, s_in) * torch.exp(-cums)[..., None]
    return (y + y_off).reshape(B, L, H, P), state


def mamba2_forward(params, x: torch.Tensor, dims: Mamba2Dims,
                   init_state: Optional[torch.Tensor] = None,
                   return_state: bool = False):
    """Full-sequence Mamba2 block. x: (B, L, D) -> (B, L, D); with
    `return_state`, also the final (B, H, P, N) f32 state."""
    B, L, _ = x.shape
    H, P, N = dims.n_heads, dims.head_dim, dims.d_state
    zxbcdt = layers.dense(params["in_proj"], x)
    z, xs, Bc, Cc, dt = _split_in_proj(dims, zxbcdt)
    conv_in = torch.cat([xs, Bc, Cc], dim=-1)
    conv_out = F.silu(layers.causal_depthwise_conv1d(params["conv"], conv_in))
    xs, Bc, Cc = torch.split(conv_out, [dims.d_inner, N, N], dim=-1)
    xh = xs.reshape(B, L, H, P)
    dtp = F.softplus(dt.float() + params["dt_bias"])
    A = torch.exp(params["A_log"])   # (H,) positive
    y, state = _ssd_chunk_scan(xh, dtp, A, Bc, Cc, dims, init_state)
    y = y + params["D"][None, None, :, None] * xh.float()
    y = y.reshape(B, L, dims.d_inner).to(x.dtype)
    y = layers.rmsnorm(params["norm"], y * F.silu(z))
    out = layers.dense(params["out_proj"], y)
    if return_state:
        return out, state
    return out


# ------------------------------------------------------------- decoding --

class Mamba2Cache(NamedTuple):
    state: torch.Tensor      # (B, H, P, N) f32
    conv_buf: torch.Tensor   # (B, d_conv − 1, conv_ch): trailing conv inputs


def init_mamba2_cache(batch: int, dims: Mamba2Dims, dtype=torch.float32, *,
                      device) -> Mamba2Cache:
    conv_ch = dims.d_inner + 2 * dims.d_state
    return Mamba2Cache(
        torch.zeros((batch, dims.n_heads, dims.head_dim, dims.d_state), device=device),
        torch.zeros((batch, dims.d_conv - 1, conv_ch), dtype=dtype, device=device))


def mamba2_decode_step(params, x: torch.Tensor, cache: Mamba2Cache, dims: Mamba2Dims):
    """One-token decode. x: (B, 1, D) -> ((B, 1, D), new cache)."""
    B = x.shape[0]
    H, P, N = dims.n_heads, dims.head_dim, dims.d_state
    zxbcdt = layers.dense(params["in_proj"], x[:, 0, :])
    z, xs, Bc, Cc, dt = _split_in_proj(dims, zxbcdt)
    conv_in = torch.cat([xs, Bc, Cc], dim=-1)   # (B, conv_ch)
    window = torch.cat([cache.conv_buf, conv_in[:, None, :].to(cache.conv_buf.dtype)],
                       dim=1)
    w = params["conv"]["w"][:, 0, :]            # (k, conv_ch)
    conv_out = torch.einsum("bkc,kc->bc", window.float(), w.float()) + params["conv"]["b"]
    conv_out = F.silu(conv_out).to(x.dtype)
    xs, Bc, Cc = torch.split(conv_out, [dims.d_inner, N, N], dim=-1)
    xh = xs.reshape(B, H, P).float()
    dtp = F.softplus(dt.float() + params["dt_bias"])   # (B, H)
    A = torch.exp(params["A_log"])
    decay = torch.exp(-dtp * A[None, :])
    state = (cache.state * decay[:, :, None, None]
             + torch.einsum("bh,bhp,bn->bhpn", dtp, xh, Bc.float()))
    y = torch.einsum("bn,bhpn->bhp", Cc.float(), state) + params["D"][None, :, None] * xh
    y = y.reshape(B, dims.d_inner).to(x.dtype)
    y = layers.rmsnorm(params["norm"], y * F.silu(z))
    out = layers.dense(params["out_proj"], y)[:, None, :]
    return out, Mamba2Cache(state, window[:, 1:, :])
