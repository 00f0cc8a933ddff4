"""Classic LSTM (Hochreiter & Schmidhuber) for the paper's next-char task.

The reference's cell (`repro.nn.recurrent`): gates in the order i, f, g,
o; one bias; the forget gate shifted by +1 (sigmoid(f + 1)); the
pre-activation x_t·w + h·r + b. `torch.nn.LSTM` has two biases, no
shift and (4h, d_in) weights, so the cell is written out, and the time
loop is a Python loop over T: it runs under
`torch.func.vmap(grad(...))`, which the round's local SGD uses. The
input projection x·w is one matmul over all T steps before the loop.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.nn.layers import fan_in_init

Params = Dict[str, torch.Tensor]


def lstm_init(gen: torch.Generator, d_in: int, d_hidden: int) -> Params:
    """w (d_in, 4h) and r (h, 4h) fan-in-scaled normal, b (4h,) zeros."""
    return {"w": fan_in_init(gen, (d_in, 4 * d_hidden)),
            "r": fan_in_init(gen, (d_hidden, 4 * d_hidden)),
            "b": torch.zeros((4 * d_hidden,), device=gen.device)}


def lstm_forward(params: Params, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """x (B, T, d_in) → hidden states (B, T, h) and the final (h, c),
    from zero states."""
    r, b = params["r"], params["b"]
    h = c = x.new_zeros(x.shape[0], r.shape[0])
    hs = []
    # unbind, not xw[:, t]: the backward of T selects is T full-size
    # zero fills and adds, of one unbind a single stack
    for xw_t in (x @ params["w"]).unbind(1):  # T of (B, 4h)
        i, f, g, o = (xw_t + h @ r + b).chunk(4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, 1), (h, c)


class LSTM(nn.Module):
    """Holds the LSTM's w, r and b (shape only, as `layers.Dense`)."""

    def __init__(self, d_in: int, d_hidden: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d_in, 4 * d_hidden, device="meta"))
        self.r = nn.Parameter(torch.empty(d_hidden, 4 * d_hidden, device="meta"))
        self.b = nn.Parameter(torch.empty(4 * d_hidden, device="meta"))

    def init(self, gen: torch.Generator) -> Params:
        return lstm_init(gen, self.w.shape[0], self.r.shape[0])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return lstm_forward({"w": self.w, "r": self.r, "b": self.b}, x)[0]
