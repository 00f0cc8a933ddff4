"""The paper's local models: the 2-layer CNN [McMahan et al.] over
images and over HAR sensor windows, and the char-LSTM.

Uniform FL-model API (used by `core.round`), functional over a flat
parameter dict as in the reference:
  init(gen)                      -> params
  apply(params, x)               -> logits (B, n_classes) or (B, T, V)
  per_sample_loss(params, batch) -> (B,) fp32   (feeds statistical utility)
  loss(params, batch)            -> scalar
  accuracy(params, batch)        -> scalar

Parameter names are the reference tree's paths joined by dots
("conv1.w", ...), and every leaf but one kind keeps the reference
layout: conv2d weights HWIO, fc1 rows in the reference's flatten order
(NHWC, NTC), embedding (vocab, d), LSTM w (d_in, 4h), r (h, 4h). The
HAR model's 1-D conv weights are torch's (c_out, c_in, k) where the
reference has (k, c_in, c_out) (`nn.layers`): `params_from_jax` /
`params_to_jax` transpose them and move every other leaf as it is.
`ParamLayout` packs the leaves into one flat vector in the reference's
leaf order (sorted paths).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from repro_torch.common import resolve_device
from repro_torch.core.state import AsyncState
from repro_torch.data.synthetic import CHAR_VOCAB
from repro_torch.nn import layers
from repro_torch.nn.recurrent import LSTM

Params = Dict[str, torch.Tensor]


class CNN(nn.Module):
    """conv3×3 → relu → pool2 → conv3×3 → relu → pool2 → fc → relu → fc,
    over NHWC images."""

    def __init__(self, input_shape: Tuple[int, int, int], n_classes: int, *,
                 c1: int = 16, c2: int = 32, d_fc: int = 128):
        super().__init__()
        H, W, C = input_shape
        self.conv1 = layers.Conv2d(C, c1, 3)
        self.conv2 = layers.Conv2d(c1, c2, 3)
        self.fc1 = layers.Dense((H // 4) * (W // 4) * c2, d_fc)
        self.fc2 = layers.Dense(d_fc, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = layers.max_pool2d(torch.relu(self.conv1(x)))
        h = layers.max_pool2d(torch.relu(self.conv2(h)))
        h = h.reshape(h.shape[0], -1)   # NHWC flatten, as the reference
        return self.fc2(torch.relu(self.fc1(h)))


class HarCNN(nn.Module):
    """conv5 → relu → pool4 → conv5 → relu → pool4 → fc → relu → fc over
    (B, 128, 9) sensor windows; the convolutions run channels-first."""

    def __init__(self, n_classes: int = 6, *, c1: int = 16, c2: int = 32,
                 d_fc: int = 128):
        super().__init__()
        self.conv1 = layers.Conv1d(9, c1, 5)
        self.conv2 = layers.Conv1d(c1, c2, 5)
        self.fc1 = layers.Dense((128 // 16) * c2, d_fc)
        self.fc2 = layers.Dense(d_fc, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.transpose(1, 2)            # (B, T, C) → (B, C, T)
        h = F.max_pool1d(torch.relu(self.conv1(h)), 4)   # 'VALID', stride 4
        h = F.max_pool1d(torch.relu(self.conv2(h)), 4)
        h = h.transpose(1, 2).reshape(h.shape[0], -1)   # NTC flatten
        return self.fc2(torch.relu(self.fc1(h)))


class CharLSTM(nn.Module):
    """embedding → LSTM → dense head: next-char logits (B, T, vocab)."""

    def __init__(self, vocab: int, *, d_embed: int = 32, d_hidden: int = 128):
        super().__init__()
        self.embed = layers.Embedding(vocab, d_embed, scale=0.1)
        self.lstm = LSTM(d_embed, d_hidden)
        self.head = layers.Dense(d_hidden, vocab)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.lstm(self.embed(x)))


@dataclasses.dataclass(frozen=True)
class ParamLayout:
    """Leaf names (reference leaf order) and shapes of a parameter dict,
    and their packing into one flat vector. `views` works on any leading
    batch shape, so a (K, P) buffer of K client models unpacks to
    (K, ...) leaves that alias it."""
    names: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(int(np.prod(s)) for s in self.shapes)

    @property
    def size(self) -> int:
        return sum(self.sizes)

    def flatten(self, params: Params) -> torch.Tensor:
        return torch.cat([params[n].reshape(-1) for n in self.names])

    def views(self, flat: torch.Tensor) -> Params:
        out, off = {}, 0
        for n, shape, size in zip(self.names, self.shapes, self.sizes):
            out[n] = flat[..., off:off + size].unflatten(-1, shape)
            off += size
        return out


@dataclasses.dataclass(frozen=True)
class FLModel:
    name: str
    module: nn.Module
    layout: ParamLayout
    param_bits: int   # uplink payload size at 32 bits per parameter

    def init(self, gen: torch.Generator) -> Params:
        """Fresh parameters on `gen.device`: fan-in-scaled normal weights,
        zero biases (the reference's initializer, not its draws)."""
        out = {}
        for mod_name, mod in self.module.named_children():
            for leaf, v in mod.init(gen).items():
                out[f"{mod_name}.{leaf}"] = v
        return out

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return functional_call(self.module, params, (x,))

    def per_sample_loss(self, params: Params, batch) -> torch.Tensor:
        return layers.per_example_ce(self.apply(params, batch["x"]), batch["y"])

    def loss(self, params: Params, batch) -> torch.Tensor:
        return self.per_sample_loss(params, batch).mean()

    def accuracy(self, params: Params, batch) -> torch.Tensor:
        logits = self.apply(params, batch["x"])
        return (logits.argmax(-1) == batch["y"]).float().mean()


@dataclasses.dataclass(frozen=True)
class NextCharModel(FLModel):
    """A language model over (B, T) char ids: the batch's "y" is unused,
    and the targets are x shifted by one."""

    def per_sample_loss(self, params: Params, batch) -> torch.Tensor:
        """(B,) per-sequence mean next-char cross-entropy."""
        x = batch["x"]
        return layers.per_example_ce(self.apply(params, x[:, :-1]),
                                     x[:, 1:]).mean(-1)

    def accuracy(self, params: Params, batch) -> torch.Tensor:
        x = batch["x"]
        pred = self.apply(params, x[:, :-1]).argmax(-1)
        return (pred == x[:, 1:]).float().mean()


def _fl_model(name: str, module: nn.Module, cls=FLModel) -> FLModel:
    named = dict(module.named_parameters())
    names = tuple(sorted(named))
    layout = ParamLayout(names, tuple(tuple(named[n].shape) for n in names))
    return cls(name, module, layout, param_bits=layout.size * 32)


def make_fl_model(task: str, *, small: bool = False) -> FLModel:
    """Paper tasks: cnn@mnist, cnn@cifar10, cnn@har, lstm@shakespeare.
    ``small=True`` is the reference's width-reduced CPU proxy (CNNs c1=8,
    c2=16, d_fc=32; the LSTM d_embed=16, d_hidden=48); the paper-scale
    widths are the defaults."""
    kw = dict(c1=8, c2=16, d_fc=32) if small else {}
    if task == "cnn@mnist":
        return _fl_model("cnn", CNN((28, 28, 1), 10, **kw))
    if task == "cnn@cifar10":
        return _fl_model("cnn", CNN((32, 32, 3), 10, **kw))
    if task == "cnn@har":
        return _fl_model("har_cnn", HarCNN(6, **kw))
    if task == "lstm@shakespeare":
        return _fl_model("char_lstm", CharLSTM(
            CHAR_VOCAB, **(dict(d_embed=16, d_hidden=48) if small else {})),
            NextCharModel)
    raise ValueError(task)


def _swap_conv1d(a: np.ndarray) -> np.ndarray:
    """A 1-D conv weight between the reference's (k, c_in, c_out) and the
    port's (c_out, c_in, k) (its own inverse); the FL models' only 3-D
    leaves are these weights."""
    return np.ascontiguousarray(a.transpose(2, 1, 0)) if a.ndim == 3 else a


def params_from_jax(tree, device="cuda") -> Params:
    """A reference parameter tree (nested dicts of arrays) → port params
    (1-D conv weights transposed to the port's layout)."""
    dev = resolve_device(device)
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + ".")
            else:
                out[prefix + k] = torch.tensor(_swap_conv1d(np.asarray(v)),
                                               device=dev)

    walk(tree, "")
    return out


def async_state_from_jax(astate, layout: ParamLayout, device="cuda") -> AsyncState:
    """A reference `AsyncState` (its leaves as arrays; `slot_delta` a
    parameter tree of (P_slots, ...) leaves) → the port's, whose
    `slot_delta` is one (P_slots, P) buffer in `layout`'s flat order."""
    dev = resolve_device(device)

    def row(node, i):
        return {k: row(v, i) if isinstance(v, dict) else np.asarray(v)[i]
                for k, v in node.items()}

    leaves = {}
    for name in AsyncState._fields:
        v = getattr(astate, name)
        if name == "slot_delta":
            n = np.asarray(astate.slot_live).shape[0]
            leaves[name] = torch.stack([
                layout.flatten(params_from_jax(row(v, i), device=dev))
                for i in range(n)])
        else:
            leaves[name] = torch.tensor(np.asarray(v), device=dev)
    return AsyncState(**leaves)


def params_to_jax(params: Params) -> dict:
    """Port params → a reference-shaped nested dict of numpy arrays (1-D
    conv weights transposed back to the reference's layout)."""
    out: dict = {}
    for name, v in params.items():
        node = out
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = _swap_conv1d(v.detach().cpu().numpy())
    return out
