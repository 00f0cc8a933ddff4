"""The layers the FL models and the LLMs need, in the JAX package's
parameter layout, with one exception.

Parameters keep the reference's layout at every interface — dense
weights (d_in, d_out), conv2d weights HWIO, activations NHWC, embedding
tables (vocab, d) — so a parameter tree moves between the two packages
leaf for leaf. The exception is the 1-D convolution of the HAR model:
its weights are torch's (c_out, c_in, k), not the reference's
(k, c_in, c_out), and its activations channels-first (B, C, T), so a
forward permutes nothing; `models.fl_models.params_from_jax` /
`params_to_jax` convert its weights. The convolutions and matmuls themselves are plain
`torch.nn.functional` calls, as the reference leaves them to XLA. Norms
and soft-caps compute in fp32 and cast back, as the reference does.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

Params = Dict[str, torch.Tensor]


def normal_init(gen: torch.Generator, shape, scale: float,
                dtype=torch.float32) -> torch.Tensor:
    """N(0, scale²) drawn in fp32, then cast to `dtype`."""
    return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(dtype)


def fan_in_init(gen: torch.Generator, shape, dtype=torch.float32,
                fan_axis: int = -2) -> torch.Tensor:
    fan_in = shape[fan_axis] if len(shape) >= 2 else shape[0]
    return normal_init(gen, shape, 1.0 / math.sqrt(max(fan_in, 1)), dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *, bias: bool = True,
               dtype=torch.float32, scale: Optional[float] = None) -> Params:
    w = (fan_in_init(gen, (d_in, d_out), dtype) if scale is None
         else normal_init(gen, (d_in, d_out), scale, dtype))
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def dense(params: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y


def embedding_init(gen: torch.Generator, vocab: int, d: int, *,
                   dtype=torch.float32, scale: Optional[float] = None) -> Params:
    return {"table": normal_init(gen, (vocab, d), 1.0 if scale is None else scale,
                                 dtype)}


def embedding(params: Params, ids: torch.Tensor) -> torch.Tensor:
    return params["table"][ids]


def rmsnorm_init(gen: torch.Generator, d: int, dtype=torch.float32) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=gen.device)}


def rmsnorm(params: Params, x: torch.Tensor, *, eps: float = 1e-6,
            scale_plus_one: bool = False) -> torch.Tensor:
    """RMS norm in fp32, cast back to x's dtype; gemma-style (1 + w)
    scale with `scale_plus_one`."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    s = params["scale"].float()
    if scale_plus_one:
        s = 1.0 + s
    return (y * s).to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 logit soft-capping cap·tanh(x / cap), in fp32."""
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def causal_depthwise_conv1d(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution. x: (B, T, C); w: (k, 1, C) in the
    reference's TIO layout, k − 1 zeros padded on the left; a
    cross-correlation, as `F.conv1d` computes it."""
    w = params["w"]
    k = w.shape[0]
    y = F.conv1d(F.pad(x.transpose(1, 2), (k - 1, 0)), w.permute(2, 1, 0),
                 groups=x.shape[-1])
    return y.transpose(1, 2) + params["b"]


def conv2d_init(gen: torch.Generator, c_in: int, c_out: int, k: int) -> Params:
    fan_in = c_in * k * k
    return {"w": normal_init(gen, (k, k, c_in, c_out), 1.0 / math.sqrt(fan_in)),
            "b": torch.zeros((c_out,), device=gen.device)}


def conv2d(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Stride-1 'SAME' convolution. x: (B, H, W, C) NHWC, w: HWIO.

    The NHWC → NCHW permute is a view (a channels-last NCHW tensor), so
    cuDNN reads the activations in place."""
    w = params["w"]
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 padding=w.shape[0] // 2)
    return y.permute(0, 2, 3, 1) + params["b"]


def conv1d_init(gen: torch.Generator, c_in: int, c_out: int, k: int) -> Params:
    """(c_out, c_in, k) weights, N(0, 1/(c_in·k)), zero bias."""
    return {"w": normal_init(gen, (c_out, c_in, k), 1.0 / math.sqrt(c_in * k)),
            "b": torch.zeros((c_out,), device=gen.device)}


def conv1d(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Stride-1 'SAME' convolution over channels-first x (B, C, T), with
    (c_out, c_in, k) weights — the reference's NTC/TIO `conv1d`, with
    both layouts transposed."""
    return F.conv1d(x, params["w"], params["b"], padding="same")


def max_pool2d(x: torch.Tensor, k: int = 2, stride: int = 2) -> torch.Tensor:
    """'VALID' max pool over NHWC."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), k, stride)
    return y.permute(0, 2, 3, 1)


def per_example_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example cross-entropy in fp32, no reduction."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return logz - gold


class Dense(nn.Module):
    """Holds a dense layer's parameters (shape only: the FL models are
    applied with `torch.func.functional_call`, so the module is built on
    the meta device and its own tensors never hold data)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d_in, d_out, device="meta"))
        self.b = nn.Parameter(torch.empty(d_out, device="meta"))

    def init(self, gen: torch.Generator) -> Params:
        return dense_init(gen, *self.w.shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense({"w": self.w, "b": self.b}, x)


class Conv2d(nn.Module):
    """Holds an HWIO conv layer's parameters (see `Dense`)."""

    def __init__(self, c_in: int, c_out: int, k: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(k, k, c_in, c_out, device="meta"))
        self.b = nn.Parameter(torch.empty(c_out, device="meta"))

    def init(self, gen: torch.Generator) -> Params:
        k, _, c_in, c_out = self.w.shape
        return conv2d_init(gen, c_in, c_out, k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d({"w": self.w, "b": self.b}, x)


class Conv1d(nn.Module):
    """Holds a (c_out, c_in, k) 1-D conv layer's parameters (see `Dense`)."""

    def __init__(self, c_in: int, c_out: int, k: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(c_out, c_in, k, device="meta"))
        self.b = nn.Parameter(torch.empty(c_out, device="meta"))

    def init(self, gen: torch.Generator) -> Params:
        c_out, c_in, k = self.w.shape
        return conv1d_init(gen, c_in, c_out, k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1d({"w": self.w, "b": self.b}, x)


class Embedding(nn.Module):
    """Holds a (vocab, d) embedding table (see `Dense`); initialised
    N(0, scale²)."""

    def __init__(self, vocab: int, d: int, *, scale: float = 1.0):
        super().__init__()
        self.table = nn.Parameter(torch.empty(vocab, d, device="meta"))
        self.scale = scale

    def init(self, gen: torch.Generator) -> Params:
        return embedding_init(gen, *self.table.shape, scale=self.scale)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return embedding({"table": self.table}, ids)
