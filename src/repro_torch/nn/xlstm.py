"""xLSTM blocks: chunked-parallel mLSTM and sequentially scanned sLSTM.

The port of the reference's `nn/xlstm.py` (arXiv:2405.04517's cell
equations: stabilised exponential gating, matrix memory for mLSTM,
normaliser states; pre-LN residual blocks with up/down projections, conv4
+ silu on the q/k branch), in its parameter layout and with its names.

mLSTM runs chunkwise — a Python loop over sequence chunks carrying the
(C, n, m) state, dense products inside a chunk — in plain PyTorch, as the
reference computes it outside any kernel. The sLSTM recurrence over a
sequence is the `slstm` kernel (`kernels/slstm`); one-token decode stays
on the plain cell, as the reference decodes.

Shapes: x (B, L, D); mLSTM inner dim 2D with NH heads.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.slstm import ops as slstm_ops
from repro_torch.kernels.slstm import ref as slstm_ref
from repro_torch.nn import layers


# =================================================================== mLSTM

class MLSTMDims(NamedTuple):
    d_model: int
    d_inner: int
    n_heads: int
    head_dim: int
    d_conv: int = 4
    chunk: int = 64


def mlstm_dims(d_model: int, n_heads: int, *, expand: int = 2,
               chunk: int = 64) -> MLSTMDims:
    d_inner = expand * d_model
    if d_inner % n_heads:
        raise ValueError(f"d_inner {d_inner} is not a multiple of {n_heads} heads")
    return MLSTMDims(d_model, d_inner, n_heads, d_inner // n_heads, 4, chunk)


def mlstm_init(gen: torch.Generator, dims: MLSTMDims, *, dtype=torch.float32):
    din, NH, hd = dims.d_inner, dims.n_heads, dims.head_dim
    dev = gen.device

    def head_proj():   # block-diagonal per-head projection (NH, hd, hd)
        return layers.normal_init(gen, (NH, hd, hd), 1.0 / math.sqrt(hd), dtype)

    return {
        "up_proj": layers.dense_init(gen, dims.d_model, 2 * din, bias=False, dtype=dtype),
        "conv": {"w": layers.normal_init(gen, (dims.d_conv, 1, din),
                                         1.0 / math.sqrt(dims.d_conv), dtype),
                 "b": torch.zeros((din,), dtype=dtype, device=dev)},
        "wq": head_proj(),
        "wk": head_proj(),
        "wv": head_proj(),
        # input and forget gate pre-activations, per head
        "wif": layers.dense_init(gen, din, 2 * NH, bias=True, dtype=dtype),
        "norm": layers.rmsnorm_init(gen, din, dtype),
        "down_proj": layers.dense_init(gen, din, dims.d_model, bias=False, dtype=dtype),
    }


class MLSTMState(NamedTuple):
    C: torch.Tensor  # (B, NH, dk, dv) f32 matrix memory
    n: torch.Tensor  # (B, NH, dk) f32 normaliser
    m: torch.Tensor  # (B, NH) f32 log-space stabiliser


def init_mlstm_state(batch: int, dims: MLSTMDims, *, device) -> MLSTMState:
    NH, hd = dims.n_heads, dims.head_dim
    return MLSTMState(torch.zeros((batch, NH, hd, hd), device=device),
                      torch.zeros((batch, NH, hd), device=device),
                      torch.full((batch, NH), -1e30, device=device))


def _mlstm_chunked(q, k, v, i_pre, f_pre, state: MLSTMState, chunk: int):
    """Stabilised chunkwise mLSTM core.

    q, k, v: (B, L, NH, hd); i_pre, f_pre: (B, L, NH). Returns (h f32,
    state'). L must be a multiple of min(chunk, L)."""
    B, L, NH, hd = q.shape
    cl = min(chunk, L)
    if cl == 0 or L % cl:
        raise ValueError(f"mLSTM: sequence length {L} is not a multiple of the "
                         f"chunk {cl} (min({chunk}, L))")
    nc = L // cl
    # value-carrying operands in the model's dtype, products summed in f32
    # (an f32 product of bf16 operands is exact); gate math in f32
    cdt = q.dtype if q.dtype in (torch.bfloat16, torch.float16) else torch.float32
    qf = (q.float() / math.sqrt(hd)).to(cdt)
    kf, vf = k.to(cdt), v.to(cdt)
    a = F.logsigmoid(f_pre.float())   # log forget gate
    b = i_pre.float()                 # log input gate
    mask = torch.ones((cl, cl), dtype=torch.bool, device=q.device).tril()
    C_in, n_in, m_in = state
    hs = []
    for ci in range(nc):
        sl = slice(ci * cl, (ci + 1) * cl)
        qb, kb, vb = qf[:, sl].float(), kf[:, sl].float(), vf[:, sl].float()
        ab, bb = a[:, sl], b[:, sl]                    # (B, cl, NH)
        A = torch.cumsum(ab, dim=1)                    # cumulative log decay
        A_last = A[:, -1, :]
        g = A + m_in[:, None, :]                       # inter-chunk exponent per row
        e = A[:, :, None, :] - A[:, None, :, :] + bb[:, None, :, :]   # (B, i, j, NH)
        e = torch.where(mask[None, :, :, None], e, -math.inf)
        m_row = torch.maximum(g, e.amax(dim=2))        # (B, cl, NH)
        w_inter = torch.exp(g - m_row)
        w_intra = torch.exp(e - m_row[:, :, None, :])  # (B, i, j, NH)
        qk = torch.einsum("bihd,bjhd->bijh", qb, kb)
        wqk = (w_intra * qk).to(cdt).float()           # the fused weight, rounded
        wq = w_inter[..., None] * qb                   # (B, i, NH, hd)
        num = (torch.einsum("bihk,bhkv->bihv", wq, C_in)
               + torch.einsum("bijh,bjhv->bihv", wqk, vb))
        den = (torch.einsum("bihk,bhk->bih", wq, n_in)
               + (w_intra * qk).sum(dim=2))
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_row))[..., None])
        # carry the state to the end of the chunk
        e_end = A_last[:, None, :] - A + bb            # (B, j, NH)
        m_out = torch.maximum(A_last + m_in, e_end.amax(dim=1))
        w_c = torch.exp(A_last + m_in - m_out)
        w_kv = torch.exp(e_end - m_out[:, None, :])    # (B, j, NH)
        wk = w_kv[..., None] * kb
        C_in = w_c[:, :, None, None] * C_in + torch.einsum("bjhk,bjhv->bhkv", wk, vb)
        n_in = w_c[:, :, None] * n_in + wk.sum(dim=1)
        m_in = m_out
    return torch.cat(hs, dim=1), MLSTMState(C_in, n_in, m_in)


def mlstm_forward(params, x: torch.Tensor, dims: MLSTMDims,
                  state: Optional[MLSTMState] = None,
                  return_state: bool = False):
    """Full-sequence mLSTM block. x: (B, L, D) -> (B, L, D)."""
    B, L, _ = x.shape
    NH, hd = dims.n_heads, dims.head_dim
    x_in, z = layers.dense(params["up_proj"], x).chunk(2, dim=-1)
    cx = F.silu(layers.causal_depthwise_conv1d(params["conv"], x_in))
    cxh = cx.reshape(B, L, NH, hd)
    xih = x_in.reshape(B, L, NH, hd)
    q = torch.einsum("blhd,hde->blhe", cxh, params["wq"])
    k = torch.einsum("blhd,hde->blhe", cxh, params["wk"])
    v = torch.einsum("blhd,hde->blhe", xih, params["wv"])
    i_pre, f_pre = layers.dense(params["wif"], cx).chunk(2, dim=-1)   # (B, L, NH)
    st = state if state is not None else init_mlstm_state(B, dims, device=x.device)
    h, st = _mlstm_chunked(q, k, v, i_pre, f_pre, st, dims.chunk)
    h = h.reshape(B, L, dims.d_inner).to(x.dtype)
    h = layers.rmsnorm(params["norm"], h) * F.silu(z)
    out = layers.dense(params["down_proj"], h)
    if return_state:
        return out, st
    return out


class MLSTMCache(NamedTuple):
    state: MLSTMState
    conv_buf: torch.Tensor  # (B, d_conv − 1, d_inner)


def init_mlstm_cache(batch: int, dims: MLSTMDims, dtype=torch.float32, *,
                     device) -> MLSTMCache:
    return MLSTMCache(init_mlstm_state(batch, dims, device=device),
                      torch.zeros((batch, dims.d_conv - 1, dims.d_inner),
                                  dtype=dtype, device=device))


def mlstm_decode_step(params, x: torch.Tensor, cache: MLSTMCache, dims: MLSTMDims):
    """One-token decode, exact recurrence. x: (B, 1, D). Returns (out
    (B, 1, D), the new cache)."""
    B = x.shape[0]
    NH, hd = dims.n_heads, dims.head_dim
    x_in, z = layers.dense(params["up_proj"], x[:, 0, :]).chunk(2, dim=-1)
    window = torch.cat([cache.conv_buf, x_in[:, None, :].to(cache.conv_buf.dtype)], dim=1)
    w = params["conv"]["w"][:, 0, :]
    cx = torch.einsum("bkc,kc->bc", window.float(), w.float()) + params["conv"]["b"]
    cx = F.silu(cx).to(x.dtype)
    cxh = cx.reshape(B, NH, hd)
    xih = x_in.reshape(B, NH, hd)
    q = torch.einsum("bhd,hde->bhe", cxh, params["wq"]).float() / math.sqrt(hd)
    k = torch.einsum("bhd,hde->bhe", cxh, params["wk"]).float()
    v = torch.einsum("bhd,hde->bhe", xih, params["wv"]).float()
    i_pre, f_pre = layers.dense(params["wif"], cx).float().chunk(2, dim=-1)   # (B, NH)
    st = cache.state
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + st.m, i_pre)
    fw = torch.exp(logf + st.m - m_new)
    iw = torch.exp(i_pre - m_new)
    C = fw[:, :, None, None] * st.C + iw[:, :, None, None] * (
        k[:, :, :, None] * v[:, :, None, :])
    n = fw[:, :, None] * st.n + iw[:, :, None] * k
    den = torch.einsum("bhk,bhk->bh", q, n)
    num = torch.einsum("bhk,bhkv->bhv", q, C)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    h = h.reshape(B, dims.d_inner).to(x.dtype)
    h = layers.rmsnorm(params["norm"], h) * F.silu(z)
    out = layers.dense(params["down_proj"], h)[:, None, :]
    return out, MLSTMCache(MLSTMState(C, n, m_new), window[:, 1:, :])


# =================================================================== sLSTM

class SLSTMDims(NamedTuple):
    d_model: int
    n_heads: int
    head_dim: int


def slstm_dims(d_model: int, n_heads: int) -> SLSTMDims:
    if d_model % n_heads:
        raise ValueError(f"d_model {d_model} is not a multiple of {n_heads} heads")
    return SLSTMDims(d_model, n_heads, d_model // n_heads)


def slstm_init(gen: torch.Generator, dims: SLSTMDims, *, dtype=torch.float32):
    d, NH, hd = dims.d_model, dims.n_heads, dims.head_dim
    return {
        # z, i, f, o pre-activations from the input
        "w_in": layers.dense_init(gen, d, 4 * d, bias=True, dtype=dtype),
        # block-diagonal recurrent matrices, per head: (NH, hd, 4·hd)
        "r": layers.normal_init(gen, (NH, hd, 4 * hd), 1.0 / math.sqrt(hd), dtype),
        "norm": layers.rmsnorm_init(gen, d, dtype),
        "ff": {
            "up": layers.dense_init(gen, d, 2 * d, bias=False, dtype=dtype),
            "down": layers.dense_init(gen, d, d, bias=False, dtype=dtype),
        },
    }


class SLSTMState(NamedTuple):
    h: torch.Tensor  # (B, NH, hd) f32
    c: torch.Tensor  # (B, NH, hd) f32
    n: torch.Tensor  # (B, NH, hd) f32
    m: torch.Tensor  # (B, NH, hd) f32


def init_slstm_state(batch: int, dims: SLSTMDims, *, device) -> SLSTMState:
    return SLSTMState(*slstm_ref.init_state(batch, dims.n_heads, dims.head_dim, device))


def _slstm_cell(params, x_pre_t: torch.Tensor, st: SLSTMState, dims: SLSTMDims):
    """x_pre_t: (B, 4·D) input pre-activations; returns (h (B, D) f32,
    state)."""
    B = x_pre_t.shape[0]
    new = slstm_ref.slstm_cell(x_pre_t.reshape(B, dims.n_heads, 4 * dims.head_dim),
                               params["r"], st)
    return new[0].reshape(B, dims.d_model), SLSTMState(*new)


def _slstm_ff(params, h: torch.Tensor) -> torch.Tensor:
    """Post-sLSTM norm and gated FF (tanh GELU, as the reference's
    `jax.nn.gelu` default)."""
    h = layers.rmsnorm(params["norm"], h)
    g, u = layers.dense(params["ff"]["up"], h).chunk(2, dim=-1)
    return layers.dense(params["ff"]["down"], layers.gelu_tanh(g) * u)


def slstm_forward(params, x: torch.Tensor, dims: SLSTMDims,
                  state: Optional[SLSTMState] = None,
                  return_state: bool = False):
    """Sequential sLSTM block, its recurrence one `slstm` kernel call.
    x: (B, L, D)."""
    B, L, D = x.shape
    x_pre = layers.dense(params["w_in"], x).reshape(B, L, dims.n_heads, 4 * dims.head_dim)
    h, st = slstm_ops.slstm_scan(x_pre, params["r"], state)
    out = _slstm_ff(params, h.reshape(B, L, D).to(x.dtype))
    if return_state:
        return out, SLSTMState(*st)
    return out


def slstm_decode_step(params, x: torch.Tensor, state: SLSTMState, dims: SLSTMDims):
    """One-token decode on the plain cell. x: (B, 1, D)."""
    x_pre = layers.dense(params["w_in"], x[:, 0, :])
    h, st = _slstm_cell(params, x_pre, state, dims)
    return _slstm_ff(params, h.to(x.dtype))[:, None, :], st
