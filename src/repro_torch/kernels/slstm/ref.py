"""Plain PyTorch version of the sLSTM recurrence kernel: the model's cell
(`_slstm_cell` of the xLSTM reference) applied over time to raw
pre-activations, returning the final state as well."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG = -1e30   # the stabiliser m of an empty state

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def init_state(batch: int, n_heads: int, head_dim: int, device) -> State:
    """(h, c, n, m), each (B, NH, hd) f32: zeros, and m = −1e30."""
    z = torch.zeros((batch, n_heads, head_dim), device=device)
    return z, z.clone(), z.clone(), torch.full_like(z, NEG)


def _cell(xt: torch.Tensor, r32: torch.Tensor, rdt: torch.dtype,
          state: State) -> State:
    h, c, n, m = state
    hd = r32.shape[1]
    # h rounded to R's dtype, the product summed in f32 and rounded to R's
    # dtype, then everything in f32 — the model cell's roundings
    rec = torch.einsum("bhd,hdk->bhk", h.to(rdt).float(), r32).to(rdt)
    pre = xt.float() + rec.float()
    zp, ip, fp, op = pre.split(hd, dim=-1)
    zt = torch.tanh(zp)
    ot = torch.sigmoid(op)
    logf = F.logsigmoid(fp)
    m_new = torch.maximum(logf + m, ip)
    fw = torch.exp(logf + m - m_new)
    iw = torch.exp(ip - m_new)
    c = fw * c + iw * zt
    n = fw * n + iw
    return ot * c / n.clamp_min(1e-6), c, n, m_new


def slstm_cell(xt: torch.Tensor, r: torch.Tensor, state: State) -> State:
    """One step. xt (B, NH, 4·hd) pre-activations, gates z, i, f, o within
    each head; r (NH, hd, 4·hd); state (h, c, n, m) f32 (B, NH, hd).
    Returns the new state."""
    return _cell(xt, r.float(), r.dtype, state)


def slstm_scan(x_pre: torch.Tensor, r: torch.Tensor,
               state: Optional[State] = None) -> Tuple[torch.Tensor, State]:
    """x_pre (B, T, NH, 4·hd); r (NH, hd, 4·hd); state (h, c, n, m) f32
    (B, NH, hd), zeros and m = −1e30 if None. Returns h (B, T, NH, hd) f32
    and the final state."""
    B, T, NH, hd4 = x_pre.shape
    st = state if state is not None else init_state(B, NH, hd4 // 4, x_pre.device)
    hs = x_pre.new_empty((B, T, NH, hd4 // 4), dtype=torch.float32)
    r32 = r.float()
    for t in range(T):
        st = _cell(x_pre[:, t], r32, r.dtype, st)
        hs[:, t] = st[0]
    return hs, st
