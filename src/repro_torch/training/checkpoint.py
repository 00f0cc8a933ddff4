"""Flat-npz checkpoints of tensor trees, and the verified layer behind
the engine's exact resume (`launch.engine.run_rounds(checkpoint_every=,
checkpoint_dir=, resume=)`).

The port of `repro.training.checkpoint`, with its file layout: a tree of
nested dicts, NamedTuples, tuples and lists is stored leaf by leaf under
its '/'-joined key path (dict keys, NamedTuple field names, sequence
indices; None is no leaf), bf16 leaves as their uint16 bit view under
the key plus `::bf16` (npz has no bfloat16). Either package reads the
other's files.

`save_checkpoint` writes a sha256 sidecar beside the npz (both through a
`.tmp` file and `os.replace`), `load_checkpoint` refuses a file whose
bytes do not match it, and `load_latest` walks a checkpoint directory
from the newest file to the oldest, past corrupt or torn ones.
`tree_digest` is the carry's fingerprint that the resume checks compare.
"""
from __future__ import annotations

import glob
import hashlib
import os
import re
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

_BF16_SUFFIX = "::bf16"
_SHA_SUFFIX = ".sha256"
_CKPT_RE = re.compile(r"ckpt_r(\d+)\.npz$")


class CheckpointError(RuntimeError):
    """A checkpoint failed verification (sha mismatch) or deserialization
    (unreadable npz, or a tree that does not match the `like` carry)."""


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaves(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(key path, leaf) of every leaf of `tree`, in the reference's key
    paths."""
    if tree is None:
        return
    if _is_namedtuple(tree):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (tuple, list)):
        items = ((str(i), v) for i, v in enumerate(tree))
    elif isinstance(tree, dict):
        items = ((str(k), v) for k, v in tree.items())
    else:
        yield "/".join(path), tree
        return
    for k, v in items:
        yield from _leaves(v, path + (k,))


def _map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    """`tree` with each leaf replaced by `fn(key path, leaf)`."""
    if tree is None:
        return None
    if _is_namedtuple(tree):
        return type(tree)(*(_map_with_path(fn, v, path + (k,))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    return fn("/".join(path), tree)


def _host(leaf) -> Tuple[np.ndarray, bool]:
    """A leaf as a host array, and whether it is bf16 (then the array is
    its uint16 bit view)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":   # an ml_dtypes array
        return arr.view(np.uint16), True
    return arr, False


def save(path: str, tree: Any) -> None:
    flat: Dict[str, np.ndarray] = {}
    for key, leaf in _leaves(tree):
        arr, bf16 = _host(leaf)
        flat[key + _BF16_SUFFIX if bf16 else key] = arr
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def load(path: str, like: Any) -> Any:
    """The tree stored at `path`, shaped as `like`: every leaf a fresh
    tensor on the `like` leaf's device, in its dtype."""
    with np.load(path) as data:
        stored = dict(data)

    def restore(key, leaf):
        leaf = torch.as_tensor(leaf)
        if key + _BF16_SUFFIX in stored:
            t = torch.from_numpy(stored[key + _BF16_SUFFIX].view(np.int16).copy())
            t = t.view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(stored[key]))
        if tuple(t.shape) != tuple(leaf.shape):   # a raise: -O drops asserts
            raise ValueError(f"{key}: stored shape {tuple(t.shape)}, expected "
                             f"{tuple(leaf.shape)}")
        return t.to(device=leaf.device, dtype=leaf.dtype)

    return _map_with_path(restore, like)


# ------------------------------------------------- verified checkpoints

def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def save_checkpoint(path: str, tree: Any) -> str:
    """`save`, then a sha256 sidecar (`path + '.sha256'`) over the npz's
    bytes. The sidecar lands after the npz, so a crash between the two
    leaves an npz without one, which `load_checkpoint` refuses. Returns
    `path`."""
    save(path, tree)
    digest = _sha256_file(path)
    tmp = path + _SHA_SUFFIX + ".tmp"
    with open(tmp, "w") as f:
        f.write(digest + "\n")
    os.replace(tmp, path + _SHA_SUFFIX)
    return path


def load_checkpoint(path: str, like: Any, *, verify: bool = True) -> Any:
    """`load` with integrity checks: with `verify` the sidecar must exist
    and match the npz's bytes. Any failure (a missing or stale sidecar,
    an unreadable npz, a key or shape that does not match `like`) raises
    `CheckpointError`, never a partial tree."""
    if verify:
        sidecar = path + _SHA_SUFFIX
        if not os.path.exists(sidecar):
            raise CheckpointError(f"{path}: missing {_SHA_SUFFIX} sidecar")
        with open(sidecar) as f:
            expect = f.read().strip()
        got = _sha256_file(path)
        if got != expect:
            raise CheckpointError(
                f"{path}: sha256 mismatch (file {got[:12]}… != sidecar "
                f"{expect[:12]}…)")
    try:
        return load(path, like)
    except Exception as e:  # unreadable npz / missing key / bad shape
        raise CheckpointError(f"{path}: failed to deserialize: {e}") from e


def checkpoint_paths(ckpt_dir: str) -> List[str]:
    """The engine's checkpoints in `ckpt_dir` (ckpt_r{round:08d}.npz),
    by round, oldest first."""
    keyed = []
    for p in glob.glob(os.path.join(ckpt_dir, "ckpt_r*.npz")):
        m = _CKPT_RE.search(os.path.basename(p))
        if m:
            keyed.append((int(m.group(1)), p))
    return [p for _, p in sorted(keyed)]


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The newest engine checkpoint in `ckpt_dir`, or None."""
    paths = checkpoint_paths(ckpt_dir)
    return paths[-1] if paths else None


def load_latest(path_or_dir: str, like: Any, *,
                verify: bool = True) -> Tuple[Any, str]:
    """A file loads that checkpoint; a directory the newest of its
    checkpoints that verifies and deserializes, so a run whose last write
    was torn resumes from the boundary before it. Returns (tree, path);
    raises `CheckpointError` when no candidate is usable."""
    if os.path.isdir(path_or_dir):
        candidates = list(reversed(checkpoint_paths(path_or_dir)))
        if not candidates:
            raise CheckpointError(f"{path_or_dir}: no ckpt_r*.npz found")
    else:
        candidates = [path_or_dir]
    errors = []
    for p in candidates:
        try:
            return load_checkpoint(p, like, verify=verify), p
        except CheckpointError as e:
            errors.append(str(e))
    raise CheckpointError("no usable checkpoint: " + "; ".join(errors))


def tree_digest(tree: Any) -> str:
    """sha256 over the path-sorted (key path, shape, dtype, raw bytes) of
    every leaf, as the reference computes it: two trees digest equal iff
    they are bitwise equal with the same keys."""
    rows = []
    for key, leaf in _leaves(tree):
        arr, bf16 = _host(leaf)
        rows.append((key, arr, "bfloat16" if bf16 else str(arr.dtype)))
    h = hashlib.sha256()
    for key, arr, dtype in sorted(rows, key=lambda r: r[0]):
        h.update(key.encode())
        h.update(str(arr.shape).encode())
        h.update(dtype.encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()
