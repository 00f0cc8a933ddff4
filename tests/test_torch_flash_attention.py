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

The bf16 CUDA kernel's arithmetic is emulated here in PyTorch (the
`_emulate_tc_kernel` below; it is not on the package's path) and held
against the Pallas kernel in interpret mode at the card check's limit,
|emulation - Pallas| <= 2**-7 |Pallas| + 1e-5 element by element.
"""
import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jkernel
from repro.kernels.flash_attention import ref as jref
from repro_torch.kernels.flash_attention import ops, ref

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
    (2, 24, 24, 4, 4, 112, True, 8, None),          # zamba2's head width, window
    (1, 20, 12, 4, 2, 112, False, None, None),      # hd 112, GQA, Sq > Sk
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
    (1, 128, 128, 4, 4, 112, True, 48, None),       # zamba2's head width
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


# ------------------------------------------- the bf16 tensor-core kernel

TC_BQ, TC_BK = 128, 64          # query rows a CTA (64 a warpgroup), keys a tile
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
CARD_RTOL, CARD_ATOL = 2.0 ** -7, 1e-5   # the card check's bf16 limit


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _emulate_tc_kernel(q, k, v, causal, window, softcap, split=True):
    """The bf16 kernel of `csrc/flash_attention.cu`, step for step, in f32
    on the CPU: the same q tiles of 128 rows (64 a warpgroup) and K/V
    tiles of 64 keys in the same order, the warpgroup's unseen tiles
    skipped and a tile with a row that sees no key sweeping every key;
    S = q k^T of bf16 values with f32 sums, the scale applied after (as
    scale * log2 e, inside the exponent's FMA on tiles with no mask and no
    softcap); the online softmax in base 2 a tile at a time; P split into
    hi = bf16(p) and lo = bf16(p - hi), both multiplied by V into the f32
    accumulator (`split=False`: hi alone). A head width short of a
    multiple of 64 (112) runs in the next one's layout, its columns past
    hd zero (TMA's zero fill), and the output keeps the first hd. q, k, v:
    f32 tensors holding bf16 values. Returns the bf16 output as f32."""
    hd_true = q.shape[-1]
    scale = torch.tensor(1.0 / math.sqrt(hd_true), dtype=torch.float32)
    q, k, v = (torch.nn.functional.pad(t, (0, -hd_true % 64)) for t in (q, k, v))
    B, Sq, H, hd = q.shape
    Sk, n_kv = k.shape[1], k.shape[2]
    c = scale * LOG2E
    pad = k.new_zeros(B, (-Sk) % TC_BK + TC_BK, n_kv, hd)   # TMA's zero fill
    kp = torch.cat([k, pad], 1).repeat_interleave(H // n_kv, 2)
    vp = torch.cat([v, pad], 1).repeat_interleave(H // n_kv, 2)
    out = torch.zeros(B, Sq, H, hd)

    def key_range(i):
        lo, hi = 0, Sk - 1
        if causal and i < hi:
            hi = i
        if window is not None and i - window + 1 > lo:
            lo = i - window + 1
        return lo, hi

    for q0 in range(0, Sq, TC_BQ):
        lo0 = key_range(q0)[0]
        lo1, hi1 = key_range(min(q0 + TC_BQ, Sq) - 1)
        sweep = lo1 > hi1
        k_begin = 0 if sweep else lo0 // TC_BK * TC_BK
        n_tiles = -(-((Sk if sweep else hi1 + 1) - k_begin) // TC_BK)
        for r_first in range(q0, min(q0 + TC_BQ, Sq), 64):
            r_last = min(r_first + 63, Sq - 1)
            rows = torch.arange(r_first, r_last + 1)
            m = torch.full((B, H, len(rows)), ref.NEG)
            l = torch.zeros(B, H, len(rows))
            acc = torch.zeros(B, H, len(rows), hd)
            for t in range(n_tiles):
                k0 = k_begin + t * TC_BK
                if not sweep and ((causal and k0 > r_last) or (
                        window is not None and r_first - (k0 + TC_BK - 1) >= window)):
                    continue
                keys = torch.arange(k0, k0 + TC_BK)
                s = torch.einsum("brhd,bkhd->bhrk", q[:, r_first:r_last + 1],
                                 kp[:, k0:k0 + TC_BK])
                masked = (sweep or k0 + TC_BK > Sk or (causal and k0 + TC_BK - 1 > r_first)
                          or (window is not None and r_last - k0 >= window))
                if not masked and softcap is None:
                    m_new = torch.maximum(m, s.amax(-1) * c)
                    # fma(s, c, -m): the exact product less m, rounded once
                    arg = (s.double() * c.double() - m_new[..., None].double()).float()
                else:
                    x = (softcap * torch.tanh(s * scale / softcap) * LOG2E
                         if softcap is not None else s * c)
                    d = rows[:, None] - keys[None, :]
                    keep = torch.ones_like(d, dtype=torch.bool)
                    if causal:
                        keep &= d >= 0
                    if window is not None:
                        keep &= d < window
                    x = torch.where(keep, x, torch.tensor(ref.NEG))
                    x = torch.where(keys >= Sk, torch.tensor(-math.inf), x)
                    m_new = torch.maximum(m, x.amax(-1))
                    arg = x - m_new[..., None]
                p = torch.exp2(arg)
                corr = torch.exp2(m - m_new)
                m = m_new
                l = l * corr + p.sum(-1)
                vt = vp[:, k0:k0 + TC_BK].permute(0, 2, 1, 3)
                hi = _bf16(p)
                acc = acc * corr[..., None] + hi @ vt
                if split:
                    acc = acc + _bf16(p - hi) @ vt
            o = acc / torch.clamp(l, min=1e-30)[..., None]
            out[:, r_first:r_last + 1] = _bf16(o.permute(0, 2, 1, 3))
    return out[..., :hd_true]


def _pallas_and_inputs(B, Sq, Sk, H, n_kv, hd, causal, window, softcap, seed):
    """bf16 inputs from a seed, and the Pallas kernel's bf16 output on them
    (interpret mode, one block per sequence so ragged lengths fit)."""
    q, k, v = (a.astype(ml_dtypes.bfloat16)
               for a in _inputs(B, Sq, Sk, H, n_kv, hd, seed))
    want = jkernel.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   causal=causal, window=window, softcap=softcap,
                                   bq=Sq, bk=Sk, interpret=True)
    want = torch.from_numpy(np.asarray(want.astype(jnp.float32)))
    return [torch.from_numpy(a.astype(np.float32)) for a in (q, k, v)], want


def _over_limit(got, want):
    return (got - want).abs() > CARD_RTOL * want.abs() + CARD_ATOL


@pytest.mark.parametrize("B,Sq,Sk,H,n_kv,hd,causal,window,softcap", [
    (1, 256, 256, 4, 2, 64, True, None, None),       # causal GQA, two q tiles
    (2, 200, 200, 4, 1, 128, True, None, None),      # MQA, ragged, hd 128
    (1, 256, 256, 4, 2, 64, True, 48, 50.0),         # window + softcap
    (1, 200, 70, 4, 2, 64, True, 8, None),           # Sq > Sk: rows with no key
    (1, 130, 130, 2, 2, 64, False, 0, None),         # the last row sees no key
    (2, 100, 257, 4, 2, 128, False, None, None),     # non-causal, ragged Sk
    (1, 256, 256, 4, 4, 112, True, 64, None),        # hd 112 in the layout of 128
])
def test_tc_kernel_arithmetic_matches_pallas_at_the_card_limit(
        B, Sq, Sk, H, n_kv, hd, causal, window, softcap):
    """The bf16 kernel's arithmetic (bf16 products with f32 sums, the
    scale after, base-2 online softmax over 64-key tiles, P split into two
    bf16 parts) stays within one bf16 step of the Pallas kernel, whose
    p @ v is in f32, on every element."""
    (q, k, v), want = _pallas_and_inputs(B, Sq, Sk, H, n_kv, hd, causal, window, softcap,
                                         seed=Sq + Sk + hd)
    got = _emulate_tc_kernel(q, k, v, causal, window, softcap)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert not _over_limit(got, want).any()


def test_rounding_p_to_bf16_once_breaks_the_card_limit():
    """Why the kernel splits P: with p rounded to bf16 for a single
    product, outputs whose p.v terms cancel lose their relative accuracy,
    and about a tenth of them fall outside one bf16 step of the f32
    reference; the split leaves none."""
    (q, k, v), want = _pallas_and_inputs(1, 256, 256, 4, 2, 64, True, None, None, seed=9)
    once = _over_limit(_emulate_tc_kernel(q, k, v, True, None, None, split=False), want)
    assert once.float().mean().item() > 0.02
    assert not _over_limit(_emulate_tc_kernel(q, k, v, True, None, None), want).any()
