"""The layers the FL CNN needs, in the JAX package's parameter layout.

Parameters keep the reference's layout at every interface — dense
weights (d_in, d_out), conv weights HWIO, activations NHWC — so a
parameter tree moves between the two packages leaf for leaf. The
convolutions and matmuls themselves are plain `torch.nn.functional`
calls, as the reference leaves them to XLA.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

Params = Dict[str, torch.Tensor]


def normal_init(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device) * scale


def dense_init(gen: torch.Generator, d_in: int, d_out: int) -> Params:
    return {"w": normal_init(gen, (d_in, d_out), 1.0 / math.sqrt(max(d_in, 1))),
            "b": torch.zeros((d_out,), device=gen.device)}


def dense(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"] + params["b"]


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
