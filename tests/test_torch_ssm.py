"""Parity of the port's Mamba2 blocks (`repro_torch.nn.ssm`) with the
reference's `nn/ssm.py`, on the CPU.

Inputs are drawn from numpy seeds and handed to both; parameters are the
reference's, carried across by `params_from_jax`. Small widths: d 64,
d_inner 128, 4 SSM heads of 32, state 16, chunk 64.

- `_ssd_chunk_scan` at L 40, 64 and 192 (one partial chunk, one full
  chunk, three chunks), with and without an initial state. f32 operands:
  output and final state within 2e-5 of their scale (measured <= 8.2e-6:
  the two frameworks sum the products in other orders, and the port sums
  each chunk's own state contribution before adding the carried state).
  bf16 operands: x, B, C and the mixing matrix M are rounded to bf16 on
  both sides, and an M entry whose f32 value lies on a rounding boundary
  lands one bf16 step (2**-8 relative) apart; output within 1e-3 of
  scale (measured <= 6.4e-5), state within 2e-5 (measured <= 8.2e-6: it
  takes no rounded M).
- Large dt·A: the exponent above the diagonal overflows to inf, which
  the `where` drops (a 0/1 mask would give 0·inf = NaN); the output stays
  finite and matches the reference.
- `mamba2_forward` with `return_state`, f32 and bf16 weights, and
  `mamba2_decode_step` over four steps from a prefill state: f32 within
  2e-5 of scale; bf16 (every matmul, norm and activation rounds to bf16
  on both sides, XLA keeping f32 between some fused ops) within 3e-2 of
  scale for outputs and 5e-2 for states (measured <= 1.2e-2 and 1.5e-2 in
  the reduced model).
- The prompt-length rule of the SSD chunk (L <= 64, or a multiple of 64)
  raises a ValueError naming it; `A_log` is log(linspace(1, 16, H))
  within an ulp of the reference's; the init tree's leaves.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.nn import ssm as jssm
from repro_torch.models.lm import params_from_jax
from repro_torch.nn import ssm

F32_REL = 2e-5
BF16_Y_REL, BF16_REL, BF16_STATE_REL = 1e-3, 3e-2, 5e-2
B, D, N, HD = 2, 64, 16, 32


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the parallel test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dims():
    return jssm.dims_for(D, N, head_dim=HD), ssm.dims_for(D, N, head_dim=HD)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_to_scale(got, want, rel):
    got, want = _np(got), _np(want)
    assert np.isfinite(got).all()
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, (err, scale)


def _scan_inputs(L, seed, dt_scale=0.5):
    rng = np.random.RandomState(seed)
    H = 2 * D // HD
    return dict(
        xh=rng.standard_normal((B, L, H, HD)).astype(np.float32),
        dtp=(np.abs(rng.standard_normal((B, L, H))) * dt_scale).astype(np.float32),
        A=np.linspace(1.0, 16.0, H).astype(np.float32),
        Bc=rng.standard_normal((B, L, N)).astype(np.float32),
        Cc=rng.standard_normal((B, L, N)).astype(np.float32),
        s0=rng.standard_normal((B, H, HD, N)).astype(np.float32))


def _run_scan(inp, dtype, with_state):
    jd = jnp.dtype(dtype)
    td = getattr(torch, dtype)
    jdims, dims = _dims()
    s0 = inp["s0"] if with_state else None
    want = jssm._ssd_chunk_scan(
        jnp.asarray(inp["xh"]).astype(jd), jnp.asarray(inp["dtp"]), jnp.asarray(inp["A"]),
        jnp.asarray(inp["Bc"]).astype(jd), jnp.asarray(inp["Cc"]).astype(jd), jdims,
        None if s0 is None else jnp.asarray(s0))
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    got = ssm._ssd_chunk_scan(t["xh"].to(td), t["dtp"], t["A"], t["Bc"].to(td),
                              t["Cc"].to(td), dims, None if s0 is None else t["s0"])
    return got, want


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [40, 64, 192])
def test_ssd_chunk_scan_matches_reference(L, dtype, with_state):
    (y, st), (jy, jst) = _run_scan(_scan_inputs(L, L), dtype, with_state)
    assert y.dtype == st.dtype == torch.float32
    assert tuple(y.shape) == jy.shape and tuple(st.shape) == jst.shape
    _close_to_scale(y, jy, F32_REL if dtype == "float32" else BF16_Y_REL)
    _close_to_scale(st, jst, F32_REL)


def test_ssd_large_decay_overflows_above_the_diagonal_and_stays_finite():
    inp = _scan_inputs(64, 5, dt_scale=8.0)   # dt·A up to ~500: exp(Σ) overflows
    cums = np.cumsum(inp["dtp"] * inp["A"], axis=1)
    assert (cums.max(axis=1) - cums.min(axis=1)).max() > 89   # > log(f32 max)
    (y, st), (jy, jst) = _run_scan(inp, "float32", True)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    _close_to_scale(y, jy, F32_REL)
    _close_to_scale(st, jst, F32_REL)


def _block(dtype, seed):
    jdims, dims = _dims()
    jp = jssm.mamba2_init(jax.random.PRNGKey(seed), jdims, dtype=jnp.dtype(dtype))
    return jdims, dims, jp, params_from_jax(jp, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [40, 128])
def test_mamba2_forward_with_state_matches_reference(L, dtype):
    jdims, dims, jp, p = _block(dtype, L)
    x = np.random.RandomState(L + 1).standard_normal((B, L, D)).astype(np.float32)
    jout, jst = jssm.mamba2_forward(jp, jnp.asarray(x).astype(jnp.dtype(dtype)), jdims,
                                    return_state=True)
    out, st = ssm.mamba2_forward(p, torch.from_numpy(x).to(getattr(torch, dtype)), dims,
                                 return_state=True)
    assert out.dtype == getattr(torch, dtype) and st.dtype == torch.float32
    f32 = dtype == "float32"
    _close_to_scale(out, jout, F32_REL if f32 else BF16_REL)
    _close_to_scale(st, jst, F32_REL if f32 else BF16_STATE_REL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_decode_steps_from_a_prefill_state_match_reference(dtype):
    jdims, dims, jp, p = _block(dtype, 3)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    rng = np.random.RandomState(4)
    x = rng.standard_normal((B, 64, D)).astype(np.float32)
    _, jst = jssm.mamba2_forward(jp, jnp.asarray(x).astype(jd), jdims, return_state=True)
    _, st = ssm.mamba2_forward(p, torch.from_numpy(x).to(td), dims, return_state=True)
    buf = rng.standard_normal((B, dims.d_conv - 1, dims.d_inner + 2 * N)).astype(np.float32)
    jcache = jssm.Mamba2Cache(jst, jnp.asarray(buf).astype(jd))
    cache = ssm.Mamba2Cache(st, torch.from_numpy(buf).to(td))
    f32 = dtype == "float32"
    for step in range(4):
        xt = rng.standard_normal((B, 1, D)).astype(np.float32)
        jout, jcache = jssm.mamba2_decode_step(jp, jnp.asarray(xt).astype(jd), jcache, jdims)
        out, cache = ssm.mamba2_decode_step(p, torch.from_numpy(xt).to(td), cache, dims)
        assert out.shape == (B, 1, D) and out.dtype == td
        _close_to_scale(out, jout, F32_REL if f32 else BF16_REL)
        _close_to_scale(cache.state, jcache.state, F32_REL if f32 else BF16_STATE_REL)
        assert cache.conv_buf.dtype == td
        _close_to_scale(cache.conv_buf, jcache.conv_buf, F32_REL if f32 else BF16_REL)


@pytest.mark.parametrize("L", [100, 65, 130])
def test_sequence_length_rule_raises_naming_the_chunk(L):
    dims = _dims()[1]
    p = ssm.mamba2_init(torch.Generator().manual_seed(0), dims)
    with pytest.raises(ValueError, match="SSD chunk 64"):
        ssm.mamba2_forward(p, torch.zeros(1, L, D), dims)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_matches_reference(dtype):
    jdims, dims = _dims()
    jp = jssm.mamba2_init(jax.random.PRNGKey(0), jdims, dtype=jnp.dtype(dtype))
    p = ssm.mamba2_init(torch.Generator().manual_seed(0), dims, dtype=getattr(torch, dtype))
    assert tuple(dims) == tuple(jdims)

    def leaves(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v

    jl, tl = dict(leaves(jp)), dict(leaves(p))
    assert sorted(jl) == sorted(tl)
    for k, v in jl.items():
        assert tuple(tl[k].shape) == v.shape, k
        assert str(tl[k].dtype).removeprefix("torch.") == str(v.dtype), k
    for k in ("A_log", "D", "dt_bias"):   # f32 whatever the model's dtype
        assert tl[k].dtype == torch.float32
    # A_log = log(linspace(1, 16, H)): within an ulp of the reference's
    np.testing.assert_array_max_ulp(tl["A_log"].numpy(), np.asarray(jl["A_log"]), maxulp=1)
    np.testing.assert_array_equal(tl["D"].numpy(), np.asarray(jl["D"]))
    assert not tl["dt_bias"].any() and not tl["conv/b"].float().any()


def test_bf16_leaves_cross_exactly():
    """`params_from_jax` carries bf16 leaves through f32, exactly."""
    jp = jssm.mamba2_init(jax.random.PRNGKey(1), _dims()[0], dtype=jnp.bfloat16)
    p = params_from_jax(jp, device="cpu")
    w = np.asarray(jp["in_proj"]["w"])
    assert w.dtype == ml_dtypes.bfloat16 and p["in_proj"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(p["in_proj"]["w"].float().numpy(), w.astype(np.float32))
