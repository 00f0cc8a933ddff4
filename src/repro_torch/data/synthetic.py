"""Offline synthetic datasets with the paper tasks' structure.

The container has no network, so MNIST/CIFAR10/HAR/Shakespeare are
replaced by class-structured synthetic generators of identical shape and
cardinality semantics (DESIGN.md §Assumption-changes #2):

  * mnist-like:  28×28×1, 10 classes — class-template + stroke noise
  * cifar-like:  32×32×3, 10 classes — harder (lower template SNR)
  * har-like:    128×9 sensor windows, 6 classes — per-class frequency
                 signatures on accel/gyro channels
  * shakespeare-like: char sequences from per-role Markov chains (each
    role = a client, naturally non-iid as in LEAF)

All generators are deterministic in their seed and produce numpy arrays
(the FL pipeline stacks them per client and moves them to torch
tensors on the run's device). A copy of `repro.data.synthetic`: the
same seed gives bitwise-equal arrays.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

CHAR_VOCAB = 64  # synthetic "byte" alphabet for the next-char task


def make_image_dataset(kind: str, n: int, *, seed: int = 0,
                       n_classes: int = 10) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (x (n, H, W, C) float32 in [0,1]-ish, y (n,) int32)."""
    rng = np.random.RandomState(seed)
    if kind == "mnist":
        H, W, C, snr = 28, 28, 1, 0.35
    elif kind == "cifar10":
        H, W, C, snr = 32, 32, 3, 0.22
    else:
        raise ValueError(kind)
    templates = rng.randn(n_classes, H, W, C).astype(np.float32)
    # low-frequency smooth templates (blur via cumsum trick)
    for _ in range(2):
        templates = (templates + np.roll(templates, 1, 1)
                     + np.roll(templates, 1, 2)) / 3.0
    templates *= snr / (templates.std() + 1e-6)
    y = rng.randint(0, n_classes, n).astype(np.int32)
    x = templates[y] + rng.randn(n, H, W, C).astype(np.float32)
    flip = rng.rand(n) < 0.08  # label noise slows convergence to paper-like
    y = np.where(flip, rng.randint(0, n_classes, n), y).astype(np.int32)
    x = (x - x.mean()) / (x.std() + 1e-6)
    return x.astype(np.float32), y


def make_har_dataset(n: int, *, seed: int = 0,
                     n_classes: int = 6) -> Tuple[np.ndarray, np.ndarray]:
    """(n, 128, 9) sensor windows; classes = activity frequency signatures."""
    rng = np.random.RandomState(seed)
    t = np.arange(128, dtype=np.float32)[None, :, None]  # (1, 128, 1)
    y = rng.randint(0, n_classes, n).astype(np.int32)
    freqs = 0.02 + 0.05 * np.arange(n_classes, dtype=np.float32)
    amps = rng.rand(n_classes, 1, 9).astype(np.float32) + 0.5
    phase = rng.rand(n, 1, 9).astype(np.float32) * 2 * np.pi
    x = amps[y] * np.sin(2 * np.pi * freqs[y][:, None, None] * t + phase)
    x = x + 1.2 * rng.randn(n, 128, 9).astype(np.float32)
    return x.astype(np.float32), y


def make_char_dataset(n_roles: int, seq_len: int = 80, per_role: int = 64,
                      *, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Shakespeare-like: per-role Markov chains over CHAR_VOCAB.

    Returns (x (n_roles, per_role, seq_len) int32, role_id (n_roles,)).
    Targets are x shifted by one (next-char prediction).
    """
    rng = np.random.RandomState(seed)
    # two global "style" transition matrices; each role mixes them
    base = rng.dirichlet(np.ones(CHAR_VOCAB) * 0.3,
                         size=(2, CHAR_VOCAB)).astype(np.float32)
    mix = rng.rand(n_roles).astype(np.float32)
    out = np.zeros((n_roles, per_role, seq_len), np.int32)
    for r in range(n_roles):
        T = mix[r] * base[0] + (1 - mix[r]) * base[1]
        cdf = np.cumsum(T, axis=1)
        s = rng.randint(0, CHAR_VOCAB, per_role)
        for t in range(seq_len):
            out[r, :, t] = s
            u = rng.rand(per_role, 1)
            s = (cdf[s] < u).sum(axis=1).clip(0, CHAR_VOCAB - 1)
    return out, np.arange(n_roles, dtype=np.int32)


DATASETS = ("mnist", "cifar10", "har", "shakespeare")
