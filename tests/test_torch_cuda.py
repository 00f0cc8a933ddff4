"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip without a CUDA device (the kernels are CUDA C++
for sm_90a, built by nvcc at first use). This file imports neither JAX
nor the JAX package: the plain versions, which the CPU parity tests hold
against the reference, are the oracle here. `rewafl_select` must match
bitwise, for any K <= S (one launch of one block up to 8,192 devices,
two above); `fedavg` within atol 1e-5 in f32 (another sum order) and 0.05
in bf16; `flash_attention` within atol 1e-5 in f32 (another sum order)
and one bf16 step in bf16 (rtol 2**-7, atol 1e-5: both round one f32
result; bf16 runs the tensor-core kernel, f32 the CUDA-core one); `slstm` within 1e-5 of max(1, the tensor's scale max |plain|)
in f32 (another sum order; m and n grow to 10-60 with large input gates)
and one bf16 step of the scale (2**-7 of max |plain|) in bf16, on h and
on the final state (a product rounded to bf16 on the other side of a tie
moves the steps after it; bf16 runs the cluster kernel, f32 the
cooperative one; a batch above 16 runs one launch per slice of at most
16 rows); `stat_util` within rtol 1e-5 (another sum order);
`fedavg_indexed` (the K selected rows of a stack, read in place) within
atol 1e-5 for f32 and bf16 stacks (an f32 result), its mask equal, and
`select_aggregate` two kernels a call (three above 8,192 devices).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.selection import _explore_slots
from repro_torch.core.utility import UtilityInputs
from repro_torch.kernels.fedavg import ops as fedavg_ops
from repro_torch.kernels.fedavg import ref as fedavg_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.rewafl_select import ops as select_ops
from repro_torch.kernels.rewafl_select import ref as select_ref
from repro_torch.kernels.slstm import ops as slstm_ops
from repro_torch.kernels.slstm import ref as slstm_ref
from repro_torch.kernels.stat_util import ops as stat_ops
from repro_torch.kernels.stat_util import ref as stat_ref


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ for sm_90a")
    return torch.device("cuda")


def _select_case(S, case, K, dev, seed=0):
    rng = np.random.RandomState(S + len(case) + seed)
    cols = [rng.uniform(lo, hi, S) for lo, hi in
            ((0, 1e4), (1, 120), (10, 2e3), (1e3, 6e4), (100, 3e3), (0, 1))]
    avail = rng.uniform(0, 1, S) >= 0.3
    if case == "ties":        # 2K devices share the top utility and draw
        blk = rng.permutation(S)[:2 * K]
        for c, v in zip(cols, (1e4, 1.0, 10.0, 6e4, 100.0, 0.999)):
            c[blk] = v
        avail[blk] = True
    elif case == "under_k":
        avail[:] = False
        avail[rng.permutation(S)[:K // 2]] = True
    elif case == "none":      # no device available: every slot dead
        avail[:] = False
    elif case == "nan":       # NaN utilities rank last and are live
        blk = rng.permutation(S)[:max(1, S // 10)]
        cols[0][blk] = np.nan
        avail[blk] = True
    elif case == "negzero":   # -0 and +0 utilities: +0 ranks first (total order)
        blk = rng.permutation(S)[:max(1, S // 4)]
        cols[0][blk[::2]] = -0.0
        cols[2][blk[1::2]] = 1e9   # e above the headroom: utility +0
        avail[blk] = True
    t = [torch.tensor(c, dtype=torch.float32, device=dev) for c in cols]
    return torch.tensor(avail, device=dev), UtilityInputs(*t[:5]), t[5]


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 100, 5000, 300_000])
@pytest.mark.parametrize("k_explore", [0, 5])
@pytest.mark.parametrize("case", ["random", "ties", "under_k"])
def test_rewafl_select_matches_plain_bitwise(dev, S, k_explore, case):
    K = min(20, S)
    k_explore = min(k_explore, K)
    avail, ui, rnd = _select_case(S, case, K, dev)
    kw = dict(k_exploit=K - k_explore, k_explore=k_explore, T_round=60.0,
              alpha=1.0, beta=1.0)
    before = select_ops.launches
    idx, live = select_ops.select_topk(avail, ui, rnd, **kw)
    ridx, rlive = select_ref.select_topk(avail, ui, rnd, **kw)
    torch.cuda.synchronize()
    assert select_ops.launches == before + 1
    assert torch.equal(idx, ridx) and torch.equal(live, rlive)


@pytest.mark.cuda
@pytest.mark.parametrize("alpha,beta", [(2.0, 0.5), (3.0, -0.5), (-1.0, -2.0),
                                        (0.0, 1.7), (0.5, 2.0), (1.3, 3.0)])
@pytest.mark.parametrize("k_explore", [0, 5])
def test_rewafl_select_non_unit_exponents_match_plain_bitwise(dev, alpha, beta,
                                                             k_explore):
    """PyTorch's tensor ** scalar special-cases 0, 0.5, -0.5, -1, 2, 3 and
    -2; the kernel must compute each power as it does."""
    avail, ui, rnd = _select_case(5000, "random", 20, dev)
    kw = dict(k_exploit=20 - k_explore, k_explore=k_explore, T_round=60.0,
              alpha=alpha, beta=beta)
    idx, live = select_ops.select_topk(avail, ui, rnd, **kw)
    ridx, rlive = select_ref.select_topk(avail, ui, rnd, **kw)
    torch.cuda.synchronize()
    assert torch.equal(idx, ridx) and torch.equal(live, rlive)


def _select_grid():
    """(S, K): S up to 1e6, around 2,048 and around the one-block limit
    and stage-1 tile (8,192); K 1, 20, 256, 257 and S (K = S up to S
    1e5)."""
    grid = []
    for S in (1, 100, 2047, 2048, 2049, 8192, 8193, 100_000, 1_000_000):
        ks = {1, 20, 256, 257} | ({S} if S <= 100_000 else set())
        grid += [(S, K) for K in sorted(ks) if K <= S]
    return grid


SELECT_CASES = ("random", "ties", "under_k", "none", "nan", "negzero")


@pytest.mark.cuda
@pytest.mark.parametrize("S,K", _select_grid())
@pytest.mark.parametrize("eps", [0.0, 0.1, 0.5])
def test_rewafl_select_any_k_matches_plain_bitwise(dev, S, K, eps):
    k_explore = _explore_slots(eps, K)
    kw = dict(k_exploit=K - k_explore, k_explore=k_explore, T_round=60.0,
              alpha=1.0, beta=1.0)
    for case in SELECT_CASES:
        avail, ui, rnd = _select_case(S, case, K, dev)
        before = select_ops.launches
        idx, live = select_ops.select_topk(avail, ui, rnd, **kw)
        ridx, rlive = select_ref.select_topk(avail, ui, rnd, **kw)
        torch.cuda.synchronize()
        assert select_ops.launches == before + 1
        assert torch.equal(live, rlive), case
        assert torch.equal(idx, ridx), case


@pytest.mark.cuda
def test_rewafl_select_rejects_k_above_its_limit(dev):
    """K must lie in [1, S]; any K up to S is taken."""
    avail, ui, rnd = _select_case(1000, "random", 20, dev)
    for kx, kr in ((1001, 0), (995, 6), (0, 0), (-1, 2)):
        with pytest.raises(ValueError, match="outside"):
            select_ops.select_topk(avail, ui, rnd, k_exploit=kx, k_explore=kr,
                                   T_round=60.0, alpha=1.0, beta=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("K,P,ld,offset", [(20, 206_922, 206_924, 0),
                                           (20, 206_922, 206_922, 0),
                                           (7, 1001, 1002, 1), (1, 5, 5, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fedavg_matches_plain(dev, K, P, ld, offset, dtype):
    rng = np.random.RandomState(K + P)
    x = torch.tensor(rng.standard_normal((K, ld + offset)), dtype=dtype, device=dev)
    x = x[:, offset:offset + P]
    w = torch.tensor(rng.uniform(0, 1, K), dtype=torch.float32, device=dev)
    w = w / w.sum()
    before = fedavg_ops.launches
    got = fedavg_ops.weighted_aggregate(x, w)
    want = fedavg_ref.weighted_aggregate(x, w)
    torch.cuda.synchronize()
    assert fedavg_ops.launches == before + 1 and got.dtype == dtype
    atol = 1e-5 if dtype == torch.float32 else 0.05
    assert (got.float() - want.float()).abs().max().item() <= atol


# B, Sq, Sk, H, n_kv, hd, causal, window, softcap
FLASH_CASES = [
    (2, 17, 17, 24, 8, 128, True, None, None),        # llama heads, ragged S
    (1, 128, 128, 24, 8, 128, True, None, None),
    (1, 512, 512, 24, 8, 128, True, None, None),
    (1, 512, 512, 32, 16, 128, True, 64, 50.0),       # gemma2 local layer
    (1, 300, 300, 32, 16, 128, True, 2**30, 50.0),    # gemma2 global layer
    (2, 300, 300, 48, 1, 128, True, None, None),      # granite MQA
    (2, 100, 257, 8, 2, 128, False, None, None),      # non-causal, Sq != Sk
    (1, 200, 70, 4, 2, 64, True, 8, None),            # Sq > Sk, windowed
    (2, 40, 40, 4, 4, 64, True, 8, 50.0),             # reduced gemma2
    (1, 130, 130, 4, 2, 64, True, 0, None),           # every row masked
    (1, 130, 130, 4, 2, 64, False, 0, None),          # the last row sees no key
    # hd 112 (zamba2-7b's shared attention), in the kernels' layout of 128
    (1, 512, 512, 32, 32, 112, True, 4096, None),     # zamba2's heads and window
    (2, 300, 300, 32, 8, 112, True, None, None),      # GQA, ragged
    (2, 100, 257, 8, 2, 112, False, None, None),      # non-causal, Sq != Sk
    (1, 200, 70, 4, 2, 112, True, 8, 50.0),           # Sq > Sk, window + softcap
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,n_kv,hd,causal,window,softcap", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain(dev, B, Sq, Sk, H, n_kv, hd, causal,
                                       window, softcap, dtype):
    g = torch.Generator(device=dev).manual_seed(Sq + Sk + H)
    q = torch.randn(B, Sq, H, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(B, Sk, n_kv, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, Sk, n_kv, hd, generator=g, device=dev).to(dtype)
    kw = dict(causal=causal, window=window)
    before = flash_ops.launches, flash_ops.tc_launches
    got = flash_ops.flash_attention(q, k, v, softcap=softcap, **kw)
    want = flash_ref.attention(q, k, v, logit_softcap=softcap, **kw)
    torch.cuda.synchronize()
    assert flash_ops.launches == before[0] + 1
    assert flash_ops.tc_launches == before[1] + (dtype == torch.bfloat16)
    assert got.dtype == dtype and got.shape == q.shape
    d = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert d.max().item() <= 1e-5
    else:
        assert bool((d <= 2.0 ** -7 * want.float().abs() + 1e-5).all())


# bf16 only (the tensor-core kernel): hd 64 with ragged Sq and Sk, and the
# llama3.2-3b, olmoe-1b-7b and zamba2-7b prefill layers at full size
TC_FLASH_CASES = [
    (2, 200, 70, 4, 2, 64, True, None, None),         # Sq > Sk, ragged
    (1, 100, 257, 8, 2, 64, False, None, None),       # non-causal, ragged Sk
    (2, 77, 77, 8, 8, 64, True, 16, 30.0),            # window + softcap, ragged
    (1, 1000, 1000, 16, 4, 64, True, None, None),     # many q tiles, ragged
    (4, 2048, 2048, 24, 8, 128, True, None, None),    # the main path's shape
    (4, 2048, 2048, 16, 16, 128, True, None, None),   # olmoe-1b-7b's prefill (group 1)
    (4, 2048, 2048, 32, 32, 112, True, 4096, None),   # zamba2-7b's prefill (hd 112)
    (2, 2048, 2048, 32, 32, 112, True, 512, None),    # hd 112, a window shorter than S
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,n_kv,hd,causal,window,softcap", TC_FLASH_CASES)
def test_tc_flash_attention_matches_plain(dev, B, Sq, Sk, H, n_kv, hd, causal, window,
                                          softcap):
    g = torch.Generator(device=dev).manual_seed(Sq * 3 + Sk + hd)
    q = torch.randn(B, Sq, H, hd, generator=g, device=dev).bfloat16()
    k = torch.randn(B, Sk, n_kv, hd, generator=g, device=dev).bfloat16()
    v = torch.randn(B, Sk, n_kv, hd, generator=g, device=dev).bfloat16()
    kw = dict(causal=causal, window=window)
    before = flash_ops.tc_launches
    got = flash_ops.flash_attention(q, k, v, softcap=softcap, **kw)
    want = flash_ref.attention(q, k, v, logit_softcap=softcap, **kw)
    torch.cuda.synchronize()
    assert flash_ops.tc_launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    d = (got.float() - want.float()).abs()
    assert bool((d <= 2.0 ** -7 * want.float().abs() + 1e-5).all())


@pytest.mark.cuda
def test_flash_attention_rejects_what_the_kernel_does_not_take(dev):
    q = torch.zeros(1, 8, 4, 32, device=dev)
    with pytest.raises(ValueError, match="head width"):
        flash_ops.flash_attention(q, q[:, :, :2], q[:, :, :2])
    q = torch.zeros(1, 8, 4, 64, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        flash_ops.flash_attention(q, q, q)
    q = torch.zeros(1, 8, 6, 64, device=dev)
    with pytest.raises(ValueError, match="KV heads"):
        flash_ops.flash_attention(q, q[:, :, :4], q[:, :, :4])
    with pytest.raises(ValueError, match="contiguous"):
        flash_ops.flash_attention(q.transpose(1, 2), q.transpose(1, 2),
                                  q.transpose(1, 2))
    # TMA reads bf16 from 16-byte-aligned bases only
    flat = torch.zeros(1 + 8 * 4 * 64, device=dev, dtype=torch.bfloat16)
    q = flat[1:].view(1, 8, 4, 64)
    with pytest.raises(ValueError, match="aligned"):
        flash_ops.flash_attention(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-3b", "gemma2-27b", "granite-34b"])
def test_prefill_launches_the_kernel_once_per_layer(dev, arch):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    cfg = get_config(arch, reduced=True)
    before = flash_ops.launches, flash_ops.tc_launches
    res = serve(arch, reduced=True, batch=2, prompt_len=24, tokens=3, device=dev)
    assert res.flash_launches == flash_ops.launches - before[0] == cfg.n_layers
    assert flash_ops.tc_launches == before[1]   # f32 weights: the CUDA-core kernel
    assert res.slstm_launches == 0
    assert res.ids.shape == (2, 4) and torch.isfinite(res.last_logits).all()


@pytest.mark.cuda
def test_full_width_bf16_prefill_runs_the_tensor_core_kernel(dev):
    """llama3.2-3b at its published widths with bf16 weights: every one
    of its 28 layers' attention goes through the tensor-core kernel."""
    from repro_torch.launch.serve import serve
    before = flash_ops.launches, flash_ops.tc_launches
    res = serve("llama3.2-3b", batch=1, prompt_len=256, tokens=2, device=dev)
    assert res.flash_launches == 28
    assert flash_ops.launches - before[0] == flash_ops.tc_launches - before[1] == 28
    assert res.ids.shape == (1, 3) and torch.isfinite(res.last_logits).all()


# B, T, NH, hd: reduced xlstm-1.3b (hd 64) and full width (hd 512)
SLSTM_CASES = [(1, 1, 4, 64), (4, 17, 4, 64), (2, 64, 4, 64), (4, 33, 4, 512),
               (1, 5, 4, 512), (16, 9, 4, 512), (3, 12, 1, 32)]


def _slstm_inputs(B, T, NH, hd, dtype, dev, seed, gate_shift=0.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, T, NH, 4, hd, generator=g, device=dev) * 0.5
    x[:, :, :, 1] += gate_shift
    r = torch.randn(NH, hd, 4 * hd, generator=g, device=dev) / hd ** 0.5
    return x.reshape(B, T, NH, 4 * hd).to(dtype), r.to(dtype)


def _assert_slstm_close(got, want, dtype):
    d = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if dtype == torch.float32:
        assert d <= 1e-5 * max(1.0, scale), (d, scale)
    else:
        assert d <= 2.0 ** -7 * scale, (d, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,NH,hd", SLSTM_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slstm_matches_plain(dev, B, T, NH, hd, dtype):
    x, r = _slstm_inputs(B, T, NH, hd, dtype, dev, B * T + hd)
    before = slstm_ops.launches, slstm_ops.tc_launches
    h, st = slstm_ops.slstm_scan(x, r)
    want_h, want_st = slstm_ref.slstm_scan(x, r)
    torch.cuda.synchronize()
    assert slstm_ops.launches == before[0] + 1
    assert slstm_ops.tc_launches == before[1] + (dtype == torch.bfloat16)
    assert h.dtype == dtype and h.shape == (B, T, NH, hd)
    _assert_slstm_close(h, want_h.to(dtype), dtype)
    for got, want in zip(st, want_st):
        assert got.dtype == torch.float32 and got.shape == (B, NH, hd)
        _assert_slstm_close(got, want, dtype)


# bf16 only (the cluster kernel): two n8 tiles (B 16), clusters of 4 (hd
# 256), eight clusters of 16 (NH 8 at hd 512, more than the card holds at
# once; B 16 too), clusters of 16 at hd 384 with B 9, hd 48 (one block, 12
# m-tiles over 8 warps), and the xlstm-1.3b prefill layer
TC_SLSTM_CASES = [(16, 64, 4, 512), (4, 256, 4, 256), (4, 128, 8, 512), (16, 3, 8, 512),
                  (9, 20, 2, 384), (3, 12, 1, 48), (4, 2048, 4, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,NH,hd", TC_SLSTM_CASES)
def test_tc_slstm_matches_plain(dev, B, T, NH, hd):
    x, r = _slstm_inputs(B, T, NH, hd, torch.bfloat16, dev, B * T + hd + 1)
    before = slstm_ops.tc_launches
    h, st = slstm_ops.slstm_scan(x, r)
    want_h, want_st = slstm_ref.slstm_scan(x, r)
    torch.cuda.synchronize()
    assert slstm_ops.tc_launches == before + 1
    assert h.dtype == torch.bfloat16 and h.shape == (B, T, NH, hd)
    _assert_slstm_close(h, want_h.bfloat16(), torch.bfloat16)
    for got, want in zip(st, want_st):
        _assert_slstm_close(got, want, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [17, 32])
@pytest.mark.parametrize("T,NH,hd", [(9, 4, 512), (17, 4, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slstm_above_batch_16_matches_plain(dev, B, T, NH, hd, dtype):
    """Two slices of at most 16 rows, one launch each, in two calls, the
    second from the first's final state."""
    x, r = _slstm_inputs(B, T, NH, hd, dtype, dev, B + T + hd)
    t1 = T // 2
    before = slstm_ops.launches, slstm_ops.tc_launches
    h1, st1 = slstm_ops.slstm_scan(x[:, :t1].contiguous(), r)
    assert slstm_ops.launches == before[0] + 2
    h2, st2 = slstm_ops.slstm_scan(x[:, t1:].contiguous(), r, st1)
    want_h, want_st = slstm_ref.slstm_scan(x, r)
    torch.cuda.synchronize()
    assert slstm_ops.launches == before[0] + 4
    assert slstm_ops.tc_launches == before[1] + 4 * (dtype == torch.bfloat16)
    h = torch.cat([h1, h2], 1)
    assert h.dtype == dtype and h.shape == (B, T, NH, hd)
    _assert_slstm_close(h, want_h.to(dtype), dtype)
    for got, want in zip(st2, want_st):
        assert got.dtype == torch.float32 and got.shape == (B, NH, hd)
        _assert_slstm_close(got, want, dtype)


@pytest.mark.cuda
def test_tc_slstm_clusters_fit(dev):
    """At least one cluster of each plan fits; xlstm-1.3b's clusters of 16
    need the non-portable cluster size."""
    for hd in (64, 256, 512):
        assert slstm_ops.max_active_clusters(4, 4, hd, dev) >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slstm_from_a_state_and_large_input_gates(dev, dtype):
    """Input-gate pre-activations of ~+60 (the stabiliser m at work), and a
    second call continuing from the first's final state."""
    x, r = _slstm_inputs(4, 40, 4, 64, dtype, dev, 5, gate_shift=60.0)
    h1, st1 = slstm_ops.slstm_scan(x[:, :25].contiguous(), r)
    h2, st2 = slstm_ops.slstm_scan(x[:, 25:].contiguous(), r, st1)
    want_h, want_st = slstm_ref.slstm_scan(x, r)
    torch.cuda.synchronize()
    assert torch.isfinite(h2.float()).all() and torch.isfinite(st2[3]).all()
    _assert_slstm_close(torch.cat([h1, h2], 1), want_h.to(dtype), dtype)
    for got, want in zip(st2, want_st):
        _assert_slstm_close(got, want, dtype)


@pytest.mark.cuda
def test_slstm_rejects_what_the_kernel_does_not_take(dev):
    x, r = _slstm_inputs(0, 3, 4, 64, torch.float32, dev, 0)
    with pytest.raises(ValueError, match="batch"):
        slstm_ops.slstm_scan(x, r)
    x, r = _slstm_inputs(2, 3, 4, 64, torch.float32, dev, 0)
    with pytest.raises(ValueError, match="dtype"):
        slstm_ops.slstm_scan(x, r.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        slstm_ops.slstm_scan(x.transpose(0, 1), r)
    # a state of another batch is refused, not cut to the slices' rows
    for B in (17, 4):
        x, r = _slstm_inputs(B, 3, 4, 64, torch.float32, dev, 0)
        for dtype in (torch.float32, torch.bfloat16):
            st = slstm_ref.init_state(20, 4, 64, dev)
            with pytest.raises(ValueError, match="state leaves"):
                slstm_ops.slstm_scan(x.to(dtype), r.to(dtype), st)
    # f32 runs the cooperative kernel: all 256 blocks (at least) at once
    x, r = _slstm_inputs(16, 3, 8, 512, torch.float32, dev, 0)
    with pytest.raises(ValueError, match="fits"):
        slstm_ops.slstm_scan(x, r)
    # bf16 runs the cluster kernel: hd a multiple of 16 up to 512, with a
    # plan that keeps R in registers, and a 16-byte-aligned x_pre
    for hd in (1024, 40):
        x, r = _slstm_inputs(1, 3, 1, hd, torch.bfloat16, dev, 0)
        with pytest.raises(ValueError, match="multiples of 16"):
            slstm_ops.slstm_scan(x, r)
    x, r = _slstm_inputs(1, 3, 1, 176, torch.bfloat16, dev, 0)
    with pytest.raises(ValueError, match="registers"):
        slstm_ops.slstm_scan(x, r)
    x, r = _slstm_inputs(2, 3, 4, 64, torch.bfloat16, dev, 0)
    flat = torch.zeros(1 + x.numel(), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        slstm_ops.slstm_scan(flat[1:].view(x.shape), r)
    x, r = _slstm_inputs(1, 3, 1, 2048, torch.float32, dev, 0)
    with pytest.raises(ValueError, match="resident"):  # 512 KB of R a block
        slstm_ops.slstm_scan(x, r)


@pytest.mark.cuda
@pytest.mark.parametrize("S,n", [(20, 32), (100, 17), (1, 5), (100_000, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stat_util_matches_plain(dev, S, n, dtype):
    g = torch.Generator(device=dev).manual_seed(S + n)
    losses = (torch.rand(S, n, generator=g, device=dev) * 5).to(dtype)
    sizes = torch.randint(1, 1000, (S,), generator=g, device=dev, dtype=torch.int32)
    before = stat_ops.launches
    got = stat_ops.stat_utility(losses, sizes)
    want = stat_ref.stat_utility(losses, sizes)
    torch.cuda.synchronize()
    assert stat_ops.launches == before + 1 and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    padded = torch.zeros(S, n + 3, device=dev, dtype=dtype)[:, :n]
    padded.copy_(losses)
    torch.testing.assert_close(stat_ops.stat_utility(padded, sizes), want, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_prefill_launches_slstm_once_per_slstm_layer(dev, param_dtype):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    cfg = get_config("xlstm-1.3b", reduced=True)
    before = slstm_ops.launches, flash_ops.launches, slstm_ops.tc_launches
    res = serve("xlstm-1.3b", reduced=True, batch=2, prompt_len=64, tokens=3, device=dev,
                param_dtype=param_dtype)
    n_slstm = cfg.n_layers // cfg.slstm_group
    assert res.slstm_launches == slstm_ops.launches - before[0] == n_slstm
    assert res.flash_launches == flash_ops.launches - before[1] == 0
    # bf16 weights: the cluster kernel; f32: the cooperative one
    assert slstm_ops.tc_launches - before[2] == (n_slstm if param_dtype == "bfloat16" else 0)
    assert res.ids.shape == (2, 4) and torch.isfinite(res.last_logits).all()


@pytest.mark.cuda
def test_full_width_bf16_xlstm_prefill_runs_the_cluster_kernel(dev):
    """xlstm-1.3b at its published widths with bf16 weights: each of its 6
    sLSTM layers (hd 512) goes through the cluster kernel."""
    from repro_torch.launch.serve import serve
    before = slstm_ops.launches, slstm_ops.tc_launches
    res = serve("xlstm-1.3b", batch=1, prompt_len=128, tokens=2, device=dev)
    assert res.slstm_launches == 6
    assert slstm_ops.launches - before[0] == slstm_ops.tc_launches - before[1] == 6
    assert res.ids.shape == (1, 3) and torch.isfinite(res.last_logits).all()


@pytest.mark.cuda
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_xlstm_serve_above_batch_16_matches_cpu(dev, param_dtype):
    """Reduced xlstm-1.3b at batch 17: two slstm launches a sLSTM layer, the
    same greedy ids as the CPU and last logits within the reduced
    agreement's limits (5e-4 of scale with f32 weights, 3e-2 with bf16)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models.api import get_model_api
    cfg = dataclasses.replace(get_config("xlstm-1.3b", reduced=True),
                              param_dtype=param_dtype)
    params = get_model_api(cfg).init_params(torch.Generator().manual_seed(3), cfg)
    kw = dict(reduced=True, batch=17, prompt_len=64, tokens=3, seed=5,
              param_dtype=param_dtype)

    def to(tree):
        return {k: to(v) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    cpu = serve("xlstm-1.3b", device="cpu", params=params, **kw)
    card = serve("xlstm-1.3b", device=dev, params=to(params), **kw)
    assert card.slstm_launches == 2 * (cfg.n_layers // cfg.slstm_group)
    assert torch.equal(cpu.ids, card.ids.cpu())
    rel = 5e-4 if param_dtype == "float32" else 3e-2
    scale = cpu.last_logits.abs().max().item()
    assert (cpu.last_logits - card.last_logits.cpu()).abs().max().item() <= rel * scale


@pytest.mark.cuda
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "kimi-k2-1t-a32b"])
def test_moe_serve_on_the_card_matches_the_cpu(dev, arch, param_dtype):
    """Reduced olmoe-1b-7b (2 MoE layers) and kimi-k2-1t-a32b (a dense
    prefix layer, then a MoE layer with a shared expert) served on the card
    and on the CPU from the same weights, under the flip rule
    (`tests/moe_flip_rule.py`): one flash launch a layer, a first-order
    flip within CARD_GAP_BOUND of a tie, router inputs, ids and last logits
    that no flip reached within CARD_STATE_REL of their scale."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models.api import get_model_api
    from moe_flip_rule import check_served, record_port_routes   # tests/, on the path
    cfg = dataclasses.replace(get_config(arch, reduced=True), param_dtype=param_dtype)
    params = get_model_api(cfg).init_params(torch.Generator().manual_seed(3), cfg)
    kw = dict(reduced=True, batch=2, prompt_len=40, tokens=8, seed=5,
              param_dtype=param_dtype)

    def to(tree):
        return {k: to(v) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    with record_port_routes() as cpu_log:
        cpu = serve(arch, device="cpu", params=params, **kw)
    tc0 = flash_ops.tc_launches
    with record_port_routes() as card_log:
        card = serve(arch, device=dev, params=to(params), **kw)
    assert card.flash_launches == cfg.n_layers and card.slstm_launches == 0
    assert flash_ops.tc_launches - tc0 == (cfg.n_layers if param_dtype == "bfloat16" else 0)
    rep = check_served(card, cpu, card_log, cpu_log, dtype=param_dtype,
                       n_moe=cfg.n_layers - cfg.moe.n_dense_prefix, name=arch)
    print("\n".join(rep.lines(f"{arch} {param_dtype}")))


@pytest.mark.cuda
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_hybrid_serve_on_the_card_matches_the_cpu(dev, param_dtype):
    """Reduced zamba2-7b (2 Mamba2 layers, then the shared attention block,
    window 8) at prompt 128 (two SSD chunks; the ring wraps) served on the
    card and on the CPU from the same weights: one flash launch a prefill
    (on the tensor cores with bf16 weights), the same greedy ids, last
    logits within 5e-4 of their scale with f32 weights and 3e-2 with
    bf16."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models.api import get_model_api
    cfg = dataclasses.replace(get_config("zamba2-7b", reduced=True),
                              param_dtype=param_dtype)
    params = get_model_api(cfg).init_params(torch.Generator().manual_seed(3), cfg)
    kw = dict(reduced=True, batch=2, prompt_len=128, tokens=8, seed=5,
              param_dtype=param_dtype)

    def to(tree):
        return {k: to(v) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    cpu = serve("zamba2-7b", device="cpu", params=params, **kw)
    tc0 = flash_ops.tc_launches
    card = serve("zamba2-7b", device=dev, params=to(params), **kw)
    assert card.flash_launches == cfg.n_layers // cfg.attn_every == 1
    assert flash_ops.tc_launches - tc0 == (1 if param_dtype == "bfloat16" else 0)
    assert torch.equal(cpu.ids, card.ids.cpu())
    rel = 5e-4 if param_dtype == "float32" else 3e-2
    scale = cpu.last_logits.abs().max().item()
    assert (cpu.last_logits - card.last_logits.cpu()).abs().max().item() <= rel * scale


@pytest.mark.cuda
def test_full_width_bf16_zamba_prefill_runs_the_tensor_core_kernel(dev):
    """zamba2-7b at its published widths with bf16 weights: each of its 13
    applications of the shared attention goes through the tensor-core
    kernel at head width 112; the 3 tail layers have no attention."""
    from repro_torch.launch.serve import serve
    before = flash_ops.launches, flash_ops.tc_launches
    res = serve("zamba2-7b", batch=1, prompt_len=256, tokens=2, device=dev)
    assert res.flash_launches == 13
    assert flash_ops.launches - before[0] == flash_ops.tc_launches - before[1] == 13
    assert res.ids.shape == (1, 3) and torch.isfinite(res.last_logits).all()


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 10, 300, 100_000])
@pytest.mark.parametrize("eps", [0.0, 0.1, 1.0])
@pytest.mark.parametrize("case", ["random", "ties", "zeros", "under_k", "none"])
def test_scores_path_on_the_card_matches_the_cpu(dev, S, eps, case):
    """`select_mask(..., scores=)` (the oort and autofl selectors: the
    plain ranking, no kernel) on the card against the CPU, bitwise."""
    rng = np.random.RandomState(S + len(case))
    K = min(20, S)
    scores = rng.uniform(0, 1e3, S).astype(np.float32)
    avail = rng.uniform(0, 1, S) >= 0.2
    if case == "ties":
        scores = np.round(rng.uniform(0, 2, S)).astype(np.float32)
    elif case == "zeros":
        scores[:] = 0.0
    elif case == "under_k":
        avail[:] = False
        avail[rng.permutation(S)[:K // 2]] = True
    elif case == "none":
        avail[:] = False
    u = rng.uniform(0, 1, S).astype(np.float32)
    args = [torch.from_numpy(a) for a in (u, avail, scores)]
    before = select_ops.launches
    got = select_ops.select_mask(args[0].to(dev), K, args[1].to(dev), eps,
                                 scores=args[2].to(dev))
    want = select_ops.select_mask(args[0], K, args[1], eps, scores=args[2])
    assert select_ops.launches == before and got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)


def _aggregate_inputs(S, P, case, K, dev, seed):
    avail, ui, rnd = _select_case(S, case, K, dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    deltas = torch.randn(S, P, generator=g, device=dev)
    weights = torch.rand(S, generator=g, device=dev) + 0.5
    return avail, ui, rnd, deltas, weights


@pytest.mark.cuda
@pytest.mark.parametrize("S,K,P", [(100, 20, 206_922), (8193, 257, 4096), (30, 0, 64)])
@pytest.mark.parametrize("eps", [0.0, 0.1])
@pytest.mark.parametrize("case", ["random", "ties", "under_k", "none"])
def test_select_aggregate_matches_plain(dev, S, K, P, eps, case):
    """The select kernel, a K-row gather and the fedavg kernel against the
    plain dense version: masks bitwise, the aggregate within fedavg's
    atol 1e-5; one launch of each kernel (none at K 0)."""
    from repro_torch.kernels.rewafl_select import ops
    avail, ui, rnd, deltas, weights = _aggregate_inputs(S, P, case, max(K, 1), dev, S + P)
    kw = dict(T_round=60.0, alpha=1.0, beta=1.0)
    before = select_ops.launches, fedavg_ops.launches
    mask, agg = ops.select_aggregate(rnd, K, avail, eps, ui, deltas, weights, **kw)
    pmask, pagg = select_ref.select_aggregate(rnd, K, avail, eps, ui, deltas, weights, **kw)
    torch.cuda.synchronize()
    n = int(K > 0)
    assert (select_ops.launches, fedavg_ops.launches) == (before[0] + n, before[1] + n)
    assert torch.equal(mask, pmask)
    assert int(mask.sum()) == min(K, int(avail.sum()))
    assert agg.shape == (P,) and agg.dtype == torch.float32
    assert (agg - pagg).abs().max().item() <= 1e-5


def _indexed_case(S, K, P, pad, dead, dtype, dev, seed):
    """An (S, P) stack with row stride P + pad, (S,) weights and K slots
    as the selection writes them (dead ones index 0, live 0, last)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(S, P + pad, generator=g, device=dev).to(dtype)[:, :P]
    w = torch.rand(S, generator=g, device=dev) + 0.5
    idx = torch.randperm(S, generator=g, device=dev)[:K].to(torch.int32)
    live = torch.ones(K, dtype=torch.int32, device=dev)
    n_dead = K // 3 if dead else 0
    if n_dead:
        idx[K - n_dead:], live[K - n_dead:] = 0, 0
    return x, idx, live, w


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 20, 257])
@pytest.mark.parametrize("P", [206_922, 4096, 4097, 7])
@pytest.mark.parametrize("pad", [0, 1, 6])
@pytest.mark.parametrize("dead", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fedavg_indexed_matches_plain(dev, K, P, pad, dead, dtype):
    """fedavg_indexed against its plain version: the aggregate within
    atol 1e-5 (f32 out of f32 sums in another order, bf16 stacks too),
    the mask equal to `mask_from_slots`'; row strides P + pad take the
    16-byte, 8-byte and scalar loads; one launch."""
    x, idx, live, w = _indexed_case(300, K, P, pad, dead, dtype, dev, K + P + pad)
    before = fedavg_ops.launches, fedavg_ops.indexed_launches
    out, mask = fedavg_ops.weighted_aggregate_indexed(x, idx, live, w)
    want = fedavg_ref.weighted_aggregate_indexed(x, idx, live, w)
    torch.cuda.synchronize()
    assert (fedavg_ops.launches, fedavg_ops.indexed_launches) == (before[0] + 1,
                                                                  before[1] + 1)
    assert out.dtype == torch.float32 and out.shape == (P,)
    assert (out - want).abs().max().item() <= 1e-5
    assert torch.equal(mask, select_ref.mask_from_slots(idx, live, 300))


@pytest.mark.cuda
@pytest.mark.parametrize("P", [4097, 206_922])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fedavg_indexed_above_a_block_of_slots(dev, P, dtype):
    """K 1,500: more slots than a block holds at once (1,024), so the sums
    continue from one chunk of slots to the next."""
    x, idx, live, w = _indexed_case(2000, 1500, P, 2, True, dtype, dev, 7)
    out, mask = fedavg_ops.weighted_aggregate_indexed(x, idx, live, w)
    want = fedavg_ref.weighted_aggregate_indexed(x, idx, live, w)
    torch.cuda.synchronize()
    assert (out - want).abs().max().item() <= 1e-5
    assert torch.equal(mask, select_ref.mask_from_slots(idx, live, 2000))


@pytest.mark.cuda
def test_fedavg_indexed_all_dead_and_nan_row_zero(dev):
    """Every slot dead: a zero aggregate and mask. A NaN in row 0 read by
    dead slots: NaN at the same positions as the plain version."""
    x, idx, live, w = _indexed_case(300, 20, 4097, 0, True, torch.float32, dev, 9)
    out, mask = fedavg_ops.weighted_aggregate_indexed(x, torch.zeros_like(idx),
                                                      torch.zeros_like(live), w)
    assert not out.any() and not mask.any()
    x[0, ::3] = float("nan")
    out, _ = fedavg_ops.weighted_aggregate_indexed(x, idx, live, w)
    want = fedavg_ref.weighted_aggregate_indexed(x, idx, live, w)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(out), nan) and int(nan.sum()) == -(-4097 // 3)
    assert (out[~nan] - want[~nan]).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("S,K,kernels", [(100, 20, 2), (8193, 257, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_select_aggregate_runs_two_kernels_and_no_op(dev, S, K, kernels, dtype):
    """On the card `select_aggregate` runs the selection kernel (two above
    8,192 devices) and fedavg_indexed, and no other device kernel
    (torch.profiler); bf16 deltas too, against the plain version. A CUDA
    graph of the call (programmatic dependent launch under capture)
    replays to the eager result."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.rewafl_select import ops
    avail, ui, rnd, deltas, weights = _aggregate_inputs(S, 4096, "random", K, dev, S)
    deltas = deltas.to(dtype)
    kw = dict(T_round=60.0, alpha=1.0, beta=1.0)
    mask, agg = ops.select_aggregate(rnd, K, avail, 0.0, ui, deltas, weights, **kw)
    pmask, pagg = select_ref.select_aggregate(rnd, K, avail, 0.0, ui, deltas, weights, **kw)
    torch.cuda.synchronize()
    assert torch.equal(mask, pmask) and (agg - pagg).abs().max().item() <= 1e-5
    calls = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            ops.select_aggregate(rnd, K, avail, 0.0, ui, deltas, weights, **kw)
        torch.cuda.synchronize()
    ev = {e.key: e.count for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}
    assert sum(ev.values()) == kernels * calls, ev
    assert sum(c for k, c in ev.items() if "fedavg_indexed" in k) == calls, ev
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.select_aggregate(rnd, K, avail, 0.0, ui, deltas, weights, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gmask, gagg = ops.select_aggregate(rnd, K, avail, 0.0, ui, deltas, weights, **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(gmask, mask) and torch.equal(gagg, agg)


@pytest.mark.cuda
def test_select_aggregate_rejects_what_the_kernel_does_not_take(dev):
    """A wrong dtype, stride, weights or row count raises before any launch."""
    from repro_torch.kernels.rewafl_select import ops
    avail, ui, rnd, deltas, weights = _aggregate_inputs(100, 64, "random", 20, dev, 1)
    kw = dict(T_round=60.0, alpha=1.0, beta=1.0)
    before = select_ops.launches, fedavg_ops.launches
    for bad_deltas, bad_w, match in (
            (deltas.half(), weights, "dtype"), (deltas[:, ::2], weights, "stride"),
            (deltas, weights.double(), "weights"), (deltas[:99], weights[:99], "rows"),
            (deltas, weights[:50], "weights")):
        with pytest.raises(ValueError, match=match):
            ops.select_aggregate(rnd, 20, avail, 0.0, ui, bad_deltas, bad_w, **kw)
    idx = torch.zeros(20, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="idx"):
        fedavg_ops.weighted_aggregate_indexed(deltas, idx, idx.int(), weights)
    assert (select_ops.launches, fedavg_ops.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("task,method,probe_every", [
    ("cnn@mnist", "random", 1), ("cnn@mnist", "oort", 1), ("cnn@mnist", "autofl", 1),
    ("cnn@mnist", "rewafl", 2), ("cnn@har", "rewafl", 1),
    ("lstm@shakespeare", "rewafl", 1), ("lstm@shakespeare", "oort", 1)])
def test_round_on_the_card_matches_the_cpu(dev, task, method, probe_every):
    """Two rounds of the round body on the card (kernels) and on the CPU
    (plain versions) from the same fleet, data, params and draws:
    selections bitwise, losses and costs within rtol 1e-3 (cuDNN and the
    CPU sum in other orders); stat_util and fedavg launch once a round,
    rewafl_select once for the rea methods and never for the others."""
    import dataclasses

    from repro_torch.core.methods import METHODS
    from repro_torch.core.round import draw_noise, make_round_body
    from repro_torch.core.state import init_fleet_state
    from repro_torch.launch.fl_run import build_task, quick_cfg
    from repro_torch.models.fl_models import make_fl_model
    from repro_torch.sim.devices import build_fleet
    from repro_torch.sim.dynamics import init_env_state
    S, K, n, R = 10, 4, 32, 2
    cfg = dataclasses.replace(quick_cfg(K), probe_every=probe_every)
    spec = METHODS[method]
    model = make_fl_model(task, small=True)
    params = model.init(torch.Generator().manual_seed(2))
    H_max = cfg.policy.H0 if spec.policy == "fixed" else cfg.policy.H_max
    gen = torch.Generator().manual_seed(1)
    noise = [draw_noise(gen, S, K, H_max, cfg.batch_size, n) for _ in range(R)]
    body = make_round_body(model, cfg, spec)
    out = {}
    for d in ("cpu", dev):
        fleet = build_fleet(S, seed=0, device=d, init_energy_mean=0.11,
                            init_energy_std=0.04, e0_frac=0.08)
        cx, cy, _ = build_task(task, S, 0.8, per_client=n, n_test=8, device=d)
        p, st = {k: v.to(d) for k, v in params.items()}, init_fleet_state(fleet, H0=cfg.policy.H0)
        before = (select_ops.launches, fedavg_ops.launches, stat_ops.launches)
        ms = []
        for r in range(R):
            p, st, _, m = body(p, st, init_env_state(fleet), fleet, cx, cy, noise[r].to(d), r)
            ms.append({k: v.cpu() for k, v in m.items()})
        after = (select_ops.launches, fedavg_ops.launches, stat_ops.launches)
        out[str(d)] = ms, [a - b for a, b in zip(after, before)]
    (cpu, cpu_launches), (card, card_launches) = out["cpu"], out[str(dev)]
    assert cpu_launches == [0, 0, 0]
    assert card_launches == [R if spec.selector == "rea" else 0, R, R]
    for a, b in zip(cpu, card):
        assert torch.equal(a["selected"], b["selected"])
        for k in ("global_loss", "round_energy", "round_latency", "mean_H_selected"):
            torch.testing.assert_close(b[k], a[k], rtol=1e-3, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("scenario", ["commuter-diurnal", "congested-urban",
                                      "overnight-charging", "churn-heavy"])
def test_dynamic_round_on_the_card_matches_the_cpu(dev, scenario):
    """Two rounds of rewafl under a fleet-dynamics scenario on the card
    and on the CPU from the same fleet, data, params, environment and
    draws: selections, the environment and the charging, online and
    available counts bitwise, losses and costs within rtol 1e-3; the
    three FL kernels once a round on the card."""
    from repro_torch.core.methods import METHODS
    from repro_torch.core.round import draw_noise, make_round_body
    from repro_torch.core.state import init_fleet_state
    from repro_torch.launch.fl_run import build_task, quick_cfg
    from repro_torch.models.fl_models import make_fl_model
    from repro_torch.sim.devices import build_fleet
    from repro_torch.sim.dynamics import SCENARIOS, init_env_state
    S, K, n, R = 10, 4, 32, 2
    cfg, sc = quick_cfg(K), SCENARIOS[scenario]
    model = make_fl_model("cnn@mnist", small=True)
    params = model.init(torch.Generator().manual_seed(2))
    gen = torch.Generator().manual_seed(1)
    noise = [draw_noise(gen, S, K, cfg.policy.H_max, cfg.batch_size, n, True)
             for _ in range(R)]
    env_u = torch.rand(4, S, generator=torch.Generator().manual_seed(3))
    body = make_round_body(model, cfg, METHODS["rewafl"], sc)
    out = {}
    for d in ("cpu", dev):
        fleet = build_fleet(S, seed=0, device=d, init_energy_mean=0.11,
                            init_energy_std=0.04, e0_frac=0.08)
        cx, cy, _ = build_task("cnn@mnist", S, 0.8, per_client=n, n_test=8, device=d)
        p, st = {k: v.to(d) for k, v in params.items()}, init_fleet_state(fleet, H0=cfg.policy.H0)
        env = init_env_state(fleet, sc, env_u.to(d))
        before = (select_ops.launches, fedavg_ops.launches, stat_ops.launches)
        ms = []
        for r in range(R):
            p, st, env, m = body(p, st, env, fleet, cx, cy, noise[r].to(d), r)
            ms.append({k: v.cpu() for k, v in m.items()})
        after = (select_ops.launches, fedavg_ops.launches, stat_ops.launches)
        out[str(d)] = ms, [x.cpu() for x in env], [a - b for a, b in zip(after, before)]
    (cpu, cpu_env, cpu_launches), (card, card_env, card_launches) = out["cpu"], out[str(dev)]
    assert cpu_launches == [0, 0, 0] and card_launches == [R, R, R]
    assert all(torch.equal(a, b) for a, b in zip(cpu_env, card_env))
    for a, b in zip(cpu, card):
        for k in ("selected", "n_charging", "n_online", "n_available"):
            assert torch.equal(a[k], b[k]), k
        for k in ("global_loss", "round_energy", "round_latency", "mean_H_selected"):
            torch.testing.assert_close(b[k], a[k], rtol=1e-3, atol=1e-5)


@pytest.mark.cuda
def test_fedavg_nan_row_at_weight_zero_matches_plain(dev):
    """The async buffer's shape, (buffer_m + K, P) = (30, 206,922), with
    one row of NaNs at weight 0 (a stale dead slot): 0 · NaN = NaN at the
    same positions as the plain version, the rest within atol 1e-5."""
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(30, 206_922, generator=g, device=dev)
    w = torch.rand(30, generator=g, device=dev)
    x[7, ::7], w[7] = float("nan"), 0.0
    got, want = fedavg_ops.weighted_aggregate(x, w), fedavg_ref.weighted_aggregate(x, w)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan) and int(nan.sum()) == -(-206_922 // 7)
    torch.testing.assert_close(got[~nan], want[~nan], rtol=0, atol=1e-5)


# (scenario, AsyncCfg fields or None)
CHAOS_ROUNDS = [("static-paper", dict(buffer_m=2, delay_jitter=0.3)),
                ("static-paper", dict(buffer_m=4, delay="unit")),
                ("lossy-uplink", None), ("flaky-fleet", None),
                ("flaky-fleet", dict(buffer_m=2))]


@pytest.mark.cuda
@pytest.mark.parametrize("scenario,akw", CHAOS_ROUNDS)
def test_async_and_fault_rounds_on_the_card_match_the_cpu(dev, scenario, akw):
    """Three rounds of rewafl, async or under a fault scenario, on the card
    and on the CPU from the same state and draws (fault and jitter draws
    included): selections and every integer metric bitwise, the buffer's
    integer leaves bitwise, floats within rtol 1e-3; on the card fedavg
    launches 1 + ceil(K / M) times a round async, once sync."""
    from repro_torch.core.async_agg import AsyncCfg
    from repro_torch.core.methods import METHODS
    from repro_torch.core.round import draw_noise, make_async_round_body, make_round_body
    from repro_torch.core.state import init_async_state, init_fleet_state
    from repro_torch.launch.fl_run import build_task, quick_cfg
    from repro_torch.models.fl_models import make_fl_model
    from repro_torch.sim.devices import build_fleet
    from repro_torch.sim.dynamics import SCENARIOS, init_env_state
    S, K, n, R = 10, 4, 32, 3
    cfg, sc = quick_cfg(K), SCENARIOS[scenario]
    acfg = AsyncCfg(**akw) if akw is not None else None
    model = make_fl_model("cnn@mnist", small=True)
    params = model.init(torch.Generator().manual_seed(2))
    gen = torch.Generator().manual_seed(1)
    noise = [draw_noise(gen, S, K, cfg.policy.H_max, cfg.batch_size, n, sc.dynamic,
                        sc.faults.enabled, acfg is not None and acfg.delay_jitter > 0)
             for _ in range(R)]
    env_u = torch.rand(4, S, generator=torch.Generator().manual_seed(3))
    spec = METHODS["rewafl"]
    body = (make_round_body(model, cfg, spec, sc) if acfg is None
            else make_async_round_body(model, cfg, spec, sc, acfg))
    out = {}
    for d in ("cpu", dev):
        fleet = build_fleet(S, seed=0, device=d, init_energy_mean=0.11,
                            init_energy_std=0.04, e0_frac=0.08)
        cx, cy, _ = build_task("cnn@mnist", S, 0.8, per_client=n, n_test=8, device=d)
        p, st = {k: v.to(d) for k, v in params.items()}, init_fleet_state(fleet, H0=cfg.policy.H0)
        env = init_env_state(fleet, sc, env_u.to(d))
        ast = (init_async_state(model.layout.flatten(p), S, acfg.slots(K))
               if acfg is not None else None)
        before = fedavg_ops.launches
        ms = []
        for r in range(R):
            if acfg is None:
                p, st, env, m = body(p, st, env, fleet, cx, cy, noise[r].to(d), r)
            else:
                p, st, ast, env, m = body(p, st, ast, env, fleet, cx, cy, noise[r].to(d), r)
            ms.append({k: v.cpu() for k, v in m.items()})
        out[str(d)] = ms, ast, fedavg_ops.launches - before
    (cpu, cpu_ast, cpu_launches), (card, card_ast, card_launches) = out["cpu"], out[str(dev)]
    for a, b in zip(cpu, card):
        assert set(a) == set(b)
        for k in a:
            if a[k].is_floating_point():
                torch.testing.assert_close(b[k], a[k], rtol=1e-3, atol=1e-5, equal_nan=True)
            else:
                assert torch.equal(a[k], b[k]), k
    if acfg is not None:
        for k, x in cpu_ast._asdict().items():
            if not x.is_floating_point():
                assert torch.equal(x, getattr(card_ast, k).cpu()), k
    per_round = 1 if acfg is None else 1 + acfg.lands(K)
    assert cpu_launches == 0 and card_launches == per_round * R


@pytest.mark.cuda
@pytest.mark.parametrize("C,K,P", [(18, 20, 206_922), (18, 40, 206_922), (3, 7, 1001),
                                   (4, 5, 1024)])
def test_fedavg_batched_matches_plain_and_single_launches(dev, C, K, P):
    """C aggregations in one launch of the batched kernel, by the op's
    vmap rule: within atol 1e-5 of the plain version and bitwise the C
    single launches (each cell sums in its own launch's order); a NaN
    row at weight 0 gives NaN at its NaN positions on both sides."""
    g = torch.Generator(device=dev).manual_seed(C + K + P)
    x = torch.randn(C, K, P, generator=g, device=dev)
    w = torch.rand(C, K, generator=g, device=dev)
    w = w / w.sum(1, keepdim=True)
    x[1, 2, ::7] = float("nan")
    w[1, 2] = 0.0
    before = fedavg_ops.launches
    got = torch.func.vmap(fedavg_ops.weighted_aggregate)(x, w)
    torch.cuda.synchronize()
    assert fedavg_ops.launches == before + 1 and got.shape == (C, P)
    singles = torch.stack([fedavg_ops.weighted_aggregate(x[c], w[c]) for c in range(C)])
    want = fedavg_ref.weighted_aggregate_batched(x, w)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan) and int(nan.sum()) == -(-P // 7)
    assert torch.equal(got[~nan], singles[~nan])
    assert (got[~nan] - want[~nan]).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,K,eps", [(6, 100, 20, 0.0), (6, 100, 20, 0.1),
                                       (3, 8193, 20, 0.0), (3, 8193, 257, 0.1)])
@pytest.mark.parametrize("case", ["random", "nan", "negzero", "under_k"])
def test_rewafl_select_batched_matches_plain_and_single_launches(dev, B, S, K, eps,
                                                                 case):
    """B selections in one launch (one block, or one set of tiles and a
    merging block, a selection) by the op's vmap rule: bitwise the plain
    version and the B single launches, at S 100 and past one block's
    8,192 devices, with ~30% unavailable, NaN and ±0 utilities."""
    cases = [_select_case(S, case, K, dev, seed=1000 * b) for b in range(B)]
    avail = torch.stack([c[0] for c in cases])
    ui = UtilityInputs(*(torch.stack([c[1][i] for c in cases]) for i in range(5)))
    rnd = torch.stack([c[2] for c in cases])
    kx = _explore_slots(eps, K)
    kw = dict(k_exploit=K - kx, k_explore=kx, T_round=60.0, alpha=1.0, beta=1.0)

    def one(a, s, t, e, r, e0, u):
        return select_ops.select_topk(a, UtilityInputs(s, t, e, r, e0), u, **kw)

    before = select_ops.launches
    idx, live = torch.func.vmap(one)(avail, *ui, rnd)
    torch.cuda.synchronize()
    assert select_ops.launches == before + 1 and idx.shape == live.shape == (B, K)
    ridx, rlive = select_ref.select_topk_batched(avail, ui, rnd, **kw)
    assert torch.equal(idx, ridx) and torch.equal(live, rlive)
    for b in range(B):
        sidx, slive = select_ops.select_topk(avail[b], UtilityInputs(*(x[b] for x in ui)),
                                             rnd[b], **kw)
        assert torch.equal(idx[b], sidx) and torch.equal(live[b], slive)


@pytest.mark.cuda
def test_stat_util_vmap_is_one_launch(dev):
    """The C cells' (K, n) loss rows fold into one (C·K, n) launch."""
    g = torch.Generator(device=dev).manual_seed(5)
    losses = torch.rand(18, 20, 32, generator=g, device=dev) * 5
    sizes = torch.randint(1, 1000, (18, 20), generator=g, device=dev, dtype=torch.int32)
    before = stat_ops.launches
    got = torch.func.vmap(stat_ops.stat_utility)(losses, sizes)
    torch.cuda.synchronize()
    assert stat_ops.launches == before + 1 and got.shape == (18, 20)
    torch.testing.assert_close(got, stat_ref.stat_utility(losses.reshape(360, 32),
                                                          sizes.reshape(360)).reshape(18, 20),
                               rtol=1e-5, atol=0)
