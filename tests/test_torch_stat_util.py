"""Parity of the port's statistical-utility op (`repro_torch.kernels.
stat_util`) with the reference's, on the CPU: the plain version (what the
wrapper runs for a CPU tensor) against the Pallas kernel in interpret mode
and against its jnp oracle, at the reference kernel test's four shapes,
with f32 losses (rtol 1e-5, as that test: both sum n squares in f32 in
another order) and bf16 losses (the same values on both sides, squared in
f32 after the cast: rtol 1e-5 too). The CUDA kernel is held against the
plain version on the card (`tests/test_torch_cuda.py`)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.stat_util import ops as j_ops
from repro.kernels.stat_util import ref as j_ref
from repro_torch.kernels.stat_util import ops, ref

RTOL = 1e-5


def _inputs(S, n, seed):
    rng = np.random.RandomState(seed)
    losses = (rng.uniform(0, 1, (S, n)) * 5.0).astype(np.float32)
    sizes = np.arange(S, dtype=np.float32) + 1
    return losses, sizes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,n", [(16, 8), (128, 32), (100, 17), (256, 64)])
def test_plain_matches_pallas_kernel_and_oracle(S, n, dtype):
    losses, sizes = _inputs(S, n, S + n)
    jl = jnp.asarray(losses).astype(dtype)
    tl = torch.from_numpy(losses).to(getattr(torch, dtype))
    got = ops.stat_utility(tl, torch.from_numpy(sizes))
    assert got.dtype == torch.float32 and got.shape == (S,)
    np.testing.assert_allclose(ref.stat_utility(tl, torch.from_numpy(sizes)).numpy(),
                               got.numpy(), rtol=0, atol=0)
    for want in (j_ops.stat_utility(jl, jnp.asarray(sizes), interpret=True),
                 j_ref.stat_utility(jl, jnp.asarray(sizes))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def test_int_sizes_and_the_round_term_agree():
    """The round passes int32 data sizes; the op equals the utility module's
    |B|·sqrt(mean loss²) on the same losses."""
    from repro_torch.core.utility import statistical_utility
    losses, _ = _inputs(20, 32, 0)
    tl = torch.from_numpy(losses)
    sizes = torch.arange(20, dtype=torch.int32) * 37 + 100
    got = ops.stat_utility(tl, sizes)
    want = statistical_utility(sizes, (tl * tl).mean(1))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL)


def test_launch_counter_untouched_on_the_cpu():
    before = ops.launches
    ops.stat_utility(torch.ones(3, 4), torch.ones(3))
    assert ops.launches == before


@pytest.mark.parametrize("sizes_batched", [True, False])
def test_vmap_folds_the_cells_into_one_call(sizes_batched):
    """Under `torch.func.vmap` the op's vmap rule folds the C cells'
    (K, n) rows into one (C·K, n) call (one launch on the card), equal to
    the loop of single calls."""
    g = torch.Generator().manual_seed(3)
    losses = torch.rand(6, 4, 9, generator=g) * 5
    sizes = torch.randint(1, 900, (6, 4), generator=g, dtype=torch.int32)
    s = sizes if sizes_batched else sizes[0]
    got = torch.func.vmap(ops.stat_utility,
                          in_dims=(0, 0 if sizes_batched else None))(losses, s)
    want = torch.stack([ops.stat_utility(losses[c], s[c] if sizes_batched else s)
                        for c in range(6)])
    assert torch.equal(got, want)
    flat = ops.stat_utility(losses.reshape(24, 9),
                            (s if sizes_batched else s.expand(6, 4)).reshape(24))
    assert torch.equal(flat.reshape(6, 4), want)
