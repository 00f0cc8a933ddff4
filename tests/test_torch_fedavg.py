"""Parity of the port's FedAvg aggregation with the reference.

The port's plain version (`kernels/fedavg/ref.py`, what a CPU tensor
runs) is held against the reference's Pallas kernel in interpret mode
(`weighted_aggregate_flat(interpret=True)`): f32 within atol 1e-5 (the
two sum the K rows in other orders), bf16 within 0.05 as the reference's
own kernel test holds it. The CUDA kernel itself is held against the
plain version on the card (`test_torch_cuda.py`).

The plain version of `fedavg_indexed` (`ref.weighted_aggregate_indexed`,
the FedAvg of K rows picked by index, what `select_aggregate` runs after
its selection) is held against the reference's steps for the same slots
(`src/repro/kernels/rewafl_select/ops.py` `select_aggregate`: the slots'
weights times live, normalised by max(Σ, 1e-9), then
`weighted_aggregate` of the rows cast to f32) within atol 1e-5 (the two
sum the K rows in other orders), f32 and bf16 stacks, K 1, 20 and 257,
with dead slots, all slots dead, and a padded row stride.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fedavg import fedavg as jfedavg
from repro.kernels.fedavg import ref as jref
from repro_torch.kernels.fedavg import ops, ref
from repro_torch.kernels.rewafl_select.ref import mask_from_slots


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


def _slots(S, K, case, seed):
    """(K,) int32 idx and live flags as the selection writes them: distinct
    live rows first, dead slots (index 0, live 0) after them."""
    rng = np.random.RandomState(seed)
    idx = rng.permutation(S)[:K].astype(np.int32)
    live = np.ones(K, np.int32)
    n_dead = {"live": 0, "padded": 0, "dead": K // 3, "all_dead": K}[case]
    if n_dead:
        idx[K - n_dead:], live[K - n_dead:] = 0, 0
    return idx, live


def _jax_indexed(x, idx, live, weights):
    """The reference's steps after its selection, for the same slots."""
    jidx = jnp.asarray(idx)
    w = jnp.asarray(weights)[jidx].astype(jnp.float32) * (jnp.asarray(live) > 0)
    wn = w / jnp.maximum(w.sum(), 1e-9)
    return jref.weighted_aggregate(jnp.asarray(x)[jidx].astype(jnp.float32), wn)


@pytest.mark.parametrize("case", ["live", "dead", "all_dead", "padded"])
@pytest.mark.parametrize("K", [1, 20, 257])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_indexed_plain_matches_reference_steps(dtype, K, case):
    S, P = 300, 37
    rng = np.random.RandomState(K + len(case))
    full = torch.tensor(rng.standard_normal((S, P + 3)), dtype=getattr(torch, dtype))
    # a padded row stride: the (S, P) view of wider rows
    x = full[:, :P] if case == "padded" else full[:, :P].contiguous()
    weights = (rng.uniform(0, 1, S) + 0.5).astype(np.float32)
    idx, live = _slots(S, K, case, K)
    got = ref.weighted_aggregate_indexed(x, torch.from_numpy(idx),
                                         torch.from_numpy(live),
                                         torch.from_numpy(weights))
    # bf16 values are exact in f32: both sides read the same numbers
    want = _jax_indexed(jnp.asarray(x.float().numpy()).astype(dtype), idx, live, weights)
    assert got.dtype == torch.float32 and got.shape == (P,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    if case == "all_dead":
        assert not got.any()


def test_indexed_wrapper_on_cpu_runs_plain_version_without_counting():
    rng = np.random.RandomState(3)
    x = torch.tensor(rng.standard_normal((12, 2, 5)), dtype=torch.float32)
    w = torch.tensor(rng.uniform(0.5, 1.5, 12), dtype=torch.float32)
    idx, live = map(torch.from_numpy, _slots(12, 6, "dead", 3))
    before = ops.launches, ops.indexed_launches
    out, mask = ops.weighted_aggregate_indexed(x, idx, live, w)
    assert (ops.launches, ops.indexed_launches) == before
    assert out.shape == (2, 5) and out.dtype == torch.float32
    assert torch.equal(out, ref.weighted_aggregate_indexed(x, idx, live, w))
    assert torch.equal(mask, mask_from_slots(idx, live, 12)) and int(mask.sum()) == 4
    with pytest.raises(ValueError, match="unsupported device"):
        ops.weighted_aggregate_indexed(x.to("meta"), idx, live, w)
