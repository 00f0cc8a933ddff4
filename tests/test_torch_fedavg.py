"""Parity of the port's FedAvg aggregation with the reference.

The port's plain version (`kernels/fedavg/ref.py`, what a CPU tensor
runs) is held against the reference's Pallas kernel in interpret mode
(`weighted_aggregate_flat(interpret=True)`): f32 within atol 1e-5 (the
two sum the K rows in other orders), bf16 within 0.05 as the reference's
own kernel test holds it. The CUDA kernel itself is held against the
plain version on the card (`test_torch_cuda.py`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fedavg import fedavg as jfedavg
from repro.kernels.fedavg import ref as jref
from repro_torch.kernels.fedavg import ops, ref


def _stack(K, P, seed):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((K, P)).astype(np.float32)
    w = rng.uniform(0, 1, K).astype(np.float32)
    return x, w / w.sum()


@pytest.mark.parametrize("K,P", [(2, 256), (8, 2048), (20, 4096), (5, 6144)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret(K, P, dtype):
    x, w = _stack(K, P, K * 31 + P)
    jx = jnp.asarray(x).astype(dtype)
    want = jfedavg.weighted_aggregate_flat(jx, jnp.asarray(w), interpret=True,
                                           block_p=min(2048, P))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = ops.weighted_aggregate(tx, torch.from_numpy(w))
    assert got.dtype == tx.dtype and got.shape == (P,)
    atol = 1e-5 if dtype == "float32" else 0.05
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), atol=atol)


def test_plain_matches_reference_oracle_on_leaf_shapes():
    """The reference calls the op once per parameter leaf; the port once on
    a (K, P) stack. Per leaf, the plain version equals the oracle."""
    rng = np.random.RandomState(0)
    w = rng.uniform(0, 1, 4).astype(np.float32)
    for shape in ((3, 3, 1, 8), (8,), (392, 32), (32, 10)):
        x = rng.standard_normal((4,) + shape).astype(np.float32)
        got = ref.weighted_aggregate(torch.from_numpy(x), torch.from_numpy(w))
        want = jref.weighted_aggregate(jnp.asarray(x), jnp.asarray(w))
        assert got.shape == shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_wrapper_on_cpu_runs_plain_version_without_counting():
    x, w = _stack(6, 1001, 1)
    before = ops.launches
    out = ops.weighted_aggregate(torch.from_numpy(x)[:, 1:], torch.from_numpy(w))
    assert ops.launches == before and out.shape == (1000,)
    np.testing.assert_allclose(out.numpy(), (w[:, None] * x[:, 1:]).sum(0), atol=1e-5)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.weighted_aggregate(torch.from_numpy(x).to("meta"),
                               torch.from_numpy(w).to("meta"))


@pytest.mark.parametrize("C,K,P", [(3, 4, 1001), (5, 20, 257)])
@pytest.mark.parametrize("weights_batched", [True, False])
def test_vmap_runs_the_batched_op_equal_to_single_calls(C, K, P, weights_batched):
    """Under `torch.func.vmap` (a campaign grid's cell axis) the op's vmap
    rule runs the batched op once: bitwise the loop of single calls, with
    the weights batched or shared; a second vmap level folds into the
    cells. The batched plain version is the plain version of each cell."""
    rng = np.random.RandomState(C * K + P)
    x = torch.tensor(rng.standard_normal((C, K, P)), dtype=torch.float32)
    w = torch.tensor(rng.uniform(0, 1, (C, K)), dtype=torch.float32)
    if not weights_batched:
        w = w[0]
    got = torch.func.vmap(ops.weighted_aggregate,
                          in_dims=(0, 0 if weights_batched else None))(x, w)
    want = torch.stack([ops.weighted_aggregate(x[c], w[c] if weights_batched else w)
                        for c in range(C)])
    assert torch.equal(got, want)
    wb = w if weights_batched else w.expand(C, K)
    assert torch.equal(ref.weighted_aggregate_batched(x, wb), want)
    assert torch.equal(ops.weighted_aggregate_batched(x, wb), want)
    two = torch.func.vmap(torch.func.vmap(ops.weighted_aggregate))(
        x.unsqueeze(0).expand(2, C, K, P), wb.unsqueeze(0).expand(2, C, K))
    assert torch.equal(two[1], want)
