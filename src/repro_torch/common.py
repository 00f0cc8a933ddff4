"""Device placement and the helpers the ported numerics need."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. A CUDA device must exist: with
    no GPU the call raises instead of carrying on on the CPU — pass
    `device="cpu"` to ask for the CPU.

    Also pins the numerics. cuDNN convolutions default to TF32 on the
    card (about three decimal digits), so both TF32 switches are turned
    off and convolutions and matmuls run in full fp32 like the JAX
    reference. cuDNN's default backward algorithms add with atomics, so
    one FL campaign run twice on the card parted by up to 1.9e-3 in loss
    within 6 rounds: cuDNN is pinned to its deterministic algorithms and
    its autotuner stays off, and a run repeats bitwise (a resumed run
    too). These are cuDNN's switches only; torch's global deterministic
    mode stays off (it would change or refuse the card's `index_add` and
    `scatter_reduce` and fill every `torch.empty`)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return dev


def rdiv(num: float, den: torch.Tensor) -> torch.Tensor:
    """`num / den` for a Python scalar `num`, as an IEEE division.

    `float / tensor` in PyTorch is `tensor.reciprocal() * float` — two
    roundings, not one — so it can differ in the last bit from the
    reference's `num / den`. Dividing a same-dtype 0-d tensor keeps one
    correctly rounded division. (A filled tensor, not `new_tensor`: on the
    card that would be a host-to-device copy that waits for the stream.)"""
    return torch.full_like(den, num).div_(den)


def scatter_drop(base: torch.Tensor, idx: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """`base.at[idx].set(vals, mode="drop")` for idx in [0, len(base)]:
    index len(base) lands in an extra entry that is sliced off, so writes
    meant to be dropped need no host-side filtering. The other indices
    must be distinct (a repeated index keeps an unspecified value). Out
    of place, so it runs under `torch.func.vmap` with batched `idx` or
    `vals` and an unbatched `base`."""
    ext = torch.cat([base, base[:1]])
    return ext.index_put((idx,), vals)[:base.shape[0]]


def tree_map(fn, tree, *rest):
    """`fn` over the tensor leaves of nested NamedTuples, tuples, lists
    and dicts (the round's states, noise and metrics), with the matching
    leaves of `rest` as further arguments; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_stack(trees):
    """Stack same-structured trees leaf by leaf along a new axis 0."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def batch_axes(tree):
    """`torch.func.vmap` in_dims for a tree batched along axis 0 (None
    leaves stay unbatched)."""
    return tree_map(lambda x: 0, tree)
