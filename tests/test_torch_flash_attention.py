"""Parity of the port's flash attention with the reference, on the CPU.

The port's wrapper (`kernels/flash_attention/ops.py`), given CPU tensors,
runs its plain version (`ref.attention`); it is held against the
reference's oracle `ref.attention` and, where the reference's Pallas
kernel takes the shape (Sq and Sk multiples of its 128 tile, or
smaller), against that kernel in interpret mode, as
`tests/test_kernels.py` runs it. Inputs are numpy arrays drawn from a
seed. Tolerances: f32 atol 1e-5 (the two sum in other orders); bf16
rtol 2**-7 (one bf16 rounding step: both compute in f32 and round the
output once). The CUDA kernel itself is held against the plain version
on the card (`test_torch_cuda.py`).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jkernel
from repro.kernels.flash_attention import ref as jref
from repro_torch.kernels.flash_attention import ops

F32_ATOL = 1e-5
BF16_RTOL = 2.0 ** -7

# B, Sq, Sk, H, n_kv, hd, causal, window, softcap
SWEEP = [
    (2, 16, 16, 4, 2, 64, True, None, None),        # GQA, causal
    (1, 17, 17, 6, 2, 32, True, None, None),        # ragged length
    (2, 24, 24, 4, 4, 16, True, 8, None),           # MHA + window
    (1, 20, 20, 4, 2, 16, True, 6, 50.0),           # window + softcap
    (2, 12, 12, 8, 1, 32, True, None, None),        # MQA
    (1, 12, 20, 4, 2, 16, False, None, None),       # non-causal, Sq < Sk
    (1, 20, 12, 4, 1, 16, False, None, 30.0),       # non-causal, Sq > Sk
    (1, 20, 12, 4, 2, 16, True, None, None),        # causal, Sq > Sk
    (1, 16, 16, 2, 1, 16, True, 2**30, None),       # a global layer's window
    (1, 16, 16, 2, 2, 16, False, 4, None),          # window without causal
]


def _inputs(B, Sq, Sk, H, n_kv, hd, seed):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, n_kv, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, n_kv, hd)).astype(np.float32))


def _port(q, k, v, dtype, **kw):
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    out = ops.flash_attention(*t, **kw)
    assert out.dtype == dtype and out.shape == t[0].shape
    return out.float().numpy()


@pytest.mark.parametrize("B,Sq,Sk,H,n_kv,hd,causal,window,softcap", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_oracle(B, Sq, Sk, H, n_kv, hd, causal, window,
                                        softcap, dtype):
    q, k, v = _inputs(B, Sq, Sk, H, n_kv, hd, seed=Sq * 7 + Sk + H)
    if dtype == "bfloat16":   # both sides start from the same bf16 values
        q, k, v = (a.astype(ml_dtypes.bfloat16) for a in (q, k, v))
    want = jref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal, window=window, logit_softcap=softcap)
    got = _port(q.astype(np.float32), k.astype(np.float32),
                v.astype(np.float32), getattr(torch, dtype),
                causal=causal, window=window, softcap=softcap)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=1e-6)


@pytest.mark.parametrize("B,Sq,Sk,H,n_kv,hd,causal,window,softcap", [
    (1, 128, 128, 4, 2, 64, True, None, None),
    (1, 128, 256, 4, 1, 32, False, None, None),
    (1, 128, 128, 4, 2, 32, True, 48, 50.0),
])
def test_plain_matches_pallas_interpret(B, Sq, Sk, H, n_kv, hd, causal, window,
                                        softcap):
    q, k, v = _inputs(B, Sq, Sk, H, n_kv, hd, seed=Sk + hd)
    want = jkernel.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   causal=causal, window=window,
                                   softcap=softcap, interpret=True)
    got = _port(q, k, v, torch.float32, causal=causal, window=window,
                softcap=softcap)
    np.testing.assert_allclose(got, np.asarray(want), atol=F32_ATOL, rtol=0)


def test_fully_masked_row_is_the_mean_of_v_as_in_the_reference():
    """A window of 0 masks every key of every row: the reference's softmax
    over a row of -1e30 is uniform, so each output is the mean of v."""
    q, k, v = _inputs(1, 8, 8, 2, 1, 16, seed=4)
    want = jref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          window=0)
    got = _port(q, k, v, torch.float32, window=0)
    np.testing.assert_allclose(got, np.asarray(want), atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(got[0, 3, 0], v[0, :, 0].mean(0), atol=F32_ATOL)


def test_wrapper_raises_off_cpu_and_cuda():
    q = torch.zeros(1, 4, 2, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flash_attention(q, q[:, :, :1], q[:, :, :1])
