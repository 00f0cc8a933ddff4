"""λ non-iid partitioner (paper Sec. IV-B) + fixed-size client stacking.
A copy of `repro.data.partition`: the same seed gives bitwise-equal
indices.

λ = 0   → iid across clients;
λ = 0.8 → 80% of each client's samples share one dominant label;
λ = 1   → each client holds a single label's data (disjoint label shards).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def partition_non_iid(y: np.ndarray, n_clients: int, lam: float, *,
                      per_client: int, n_classes: int,
                      seed: int = 0) -> np.ndarray:
    """Returns client sample indices (n_clients, per_client) int64.

    Sampling with replacement from label pools keeps per-client sizes
    fixed (static-shape stacking) while matching the λ label-skew law.
    """
    rng = np.random.RandomState(seed)
    by_label = [np.where(y == c)[0] for c in range(n_classes)]
    idx = np.zeros((n_clients, per_client), np.int64)
    dominant = rng.permutation(np.arange(n_clients) % n_classes)
    n_dom = int(round(lam * per_client))
    for i in range(n_clients):
        c = dominant[i]
        dom_pool = by_label[c]
        dom = rng.choice(dom_pool, n_dom, replace=True)
        if per_client - n_dom > 0:
            if lam >= 1.0:
                rest = rng.choice(dom_pool, per_client - n_dom, replace=True)
            else:
                others = np.concatenate(
                    [by_label[k] for k in range(n_classes) if k != c])
                rest = rng.choice(others, per_client - n_dom, replace=True)
        else:
            rest = np.zeros((0,), np.int64)
        idx[i] = np.concatenate([dom, rest])
        rng.shuffle(idx[i])
    return idx


def client_datasets(x: np.ndarray, y: np.ndarray, n_clients: int,
                    lam: float, per_client: int, n_classes: int,
                    seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Stacked per-client arrays: x (C, per_client, ...), y (C, per_client)."""
    idx = partition_non_iid(y, n_clients, lam, per_client=per_client,
                            n_classes=n_classes, seed=seed)
    return x[idx], y[idx]
