"""Mixture-of-Experts FFN: the top-k router and the dense oracle, on one
device.

The reference's off-mesh path (`moe_forward` on an unsharded mesh) is
``moe_forward_dense``: every expert computes every token, and the router
weights combine them. Exact: no capacity, no drops. Its sharded paths
(capacity dispatch and combine, the expert-parallel all-to-all, the
2-D weight-resident decode) wait for the sharding item (ROADMAP A16).

Layout: the expert weights keep the reference's (E, D, F) / (E, F, D),
so a tree moves between the packages leaf for leaf. The expert products
run as one batched matmul over E, (E, N, D) @ (E, D, F), whose batch of
token rows is the same (N, D) block expanded, and the activations stay
expert-major, (E, N, F) and (E, N, D): the reference's (N, E, ·)
transposed, with no weight permuted or copied. In bf16 every product
sums in f32 and rounds once (cuBLAS and the CPU's GEMMs alike).

Aux outputs: the Switch load-balance loss and the router z-loss.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.nn import layers


@dataclasses.dataclass(frozen=True)
class MoECfg:
    d_model: int
    d_ff: int                 # per-expert hidden dim
    n_experts: int
    top_k: int
    shared_d_ff: int = 0      # >0 adds an always-on shared expert (Kimi K2)


def moe_init(gen: torch.Generator, cfg: MoECfg, *, dtype=torch.float32):
    """Random parameters drawn from `gen` on its device, in the
    reference's tree; the router stays f32 whatever `dtype` is."""
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    s_in, s_ff = 1.0 / math.sqrt(D), 1.0 / math.sqrt(F_)
    p = {
        "router": layers.dense_init(gen, D, E, bias=False, dtype=torch.float32),
        "experts": {
            "w_gate": layers.normal_init(gen, (E, D, F_), s_in, dtype),
            "w_up": layers.normal_init(gen, (E, D, F_), s_in, dtype),
            "w_down": layers.normal_init(gen, (E, F_, D), s_ff, dtype),
        },
    }
    if cfg.shared_d_ff:
        p["shared"] = {
            "w_gate": layers.dense_init(gen, D, cfg.shared_d_ff, bias=False, dtype=dtype),
            "w_up": layers.dense_init(gen, D, cfg.shared_d_ff, bias=False, dtype=dtype),
            "w_down": layers.dense_init(gen, cfg.shared_d_ff, D, bias=False, dtype=dtype),
        }
    return p


def route(router_params, x_flat: torch.Tensor, cfg: MoECfg):
    """Router, in f32 whatever x's dtype: returns (expert ids (N, K) int64,
    gates (N, K) f32, aux dict).

    The top k come from a stable descending sort over the E experts, so
    equal probabilities go to the lower index, as `lax.top_k` breaks
    ties (`torch.topk` on the card promises no order)."""
    logits = x_flat.float() @ router_params["w"]             # (N, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :cfg.top_k], top_i[:, :cfg.top_k]
    gates = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch load-balance: E * sum_e f_e * P_e, f_e the primary assignment's
    # share; counted with index_add_, which (unlike bincount) reads nothing
    # back to the host on the card. Whole counts in f32: exact in any order.
    N = x_flat.shape[0]
    f_e = probs.new_zeros(cfg.n_experts).index_add_(0, top_i[:, 0], probs.new_ones(N)) / N
    P_e = probs.mean(0)
    lb = cfg.n_experts * (f_e * P_e).sum()
    z = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    return top_i, gates, {"lb_loss": lb, "z_loss": z}


def _shared_ffn(shared, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(layers.dense(shared["w_gate"], x)) * layers.dense(shared["w_up"], x)
    return layers.dense(shared["w_down"], h)


def moe_forward_dense(params, x: torch.Tensor, cfg: MoECfg):
    """Oracle: all experts on all tokens, router-weighted. x: (B, S, D).
    Returns (out in x's dtype, aux).

    An unselected expert's output is multiplied by a weight of 0, as in
    the reference: where it overflows to inf, the token's output is NaN."""
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    top_i, gates, aux = route(params["router"], xf, cfg)
    ex = params["experts"]
    g = torch.matmul(xf, ex["w_gate"])                      # (E, N, F)
    u = torch.matmul(xf, ex["w_up"])
    y_all = torch.bmm(F.silu(g) * u, ex["w_down"])          # (E, N, D)
    # the gates in the activations' dtype at the selected experts, 0 elsewhere
    w = torch.zeros(xf.shape[0], cfg.n_experts, dtype=y_all.dtype, device=x.device)
    w.scatter_(1, top_i, gates.to(y_all.dtype))
    # out[n] = w[n] @ y_all[:, n]: a batch over tokens of (1, E) @ (E, D)
    out = torch.bmm(w[:, None, :], y_all.transpose(0, 1))[:, 0].reshape(B, S, D)
    if cfg.shared_d_ff:
        out = out + _shared_ffn(params["shared"], x)
    return out.to(x.dtype), aux


def moe_forward(params, x: torch.Tensor, cfg: MoECfg):
    """The reference's dispatch cut to its one-device branch: the dense
    oracle. It holds the place where the sharding item (ROADMAP A16)
    chooses between this and the expert-parallel paths."""
    return moe_forward_dense(params, x, cfg)
