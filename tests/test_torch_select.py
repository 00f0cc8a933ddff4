"""Parity of the port's REWAFL selection with the reference.

The port's plain version of the selection kernel (`kernels/rewafl_select/
ref.py`, what a CPU tensor runs) is held against the reference's Pallas
kernel in interpret mode (`select_mask(..., backend="pallas",
interpret=True)`, which pads S to the tile grid) and against its oracle
`ref.select_ref`: masks bitwise, and the kernel's (K,) live flags and
live indices bitwise. Both sides get the same uniform explore draw. K
above 256 and K = S (which the CUDA kernel takes) are held against the
oracle at S 300 and 4,096, and against the Pallas kernel at S 300. The
CUDA kernel itself is held against the plain version on the card
(`test_torch_cuda.py`).

`select_mask`'s scores path (the oort and autofl selectors: no kernel in
either package) is held bitwise against the reference's
`select_mask(..., scores=)`. `select_aggregate` (the select kernel,
then `fedavg_indexed` on the K selected rows) against the reference's
Pallas composition in interpret mode at ε 0 (at ε > 0 each compile of
the interpret kernel takes ~30 s) and against its oracle
`select_aggregate_ref` at ε 0.1: masks bitwise, the aggregate within
atol 1e-5 (fedavg's tolerance: the K-row and dense S-row sums add in
other orders). With a NaN in row 0, NaN at the same positions as the
reference's fused pass (a dead slot reads row 0 at weight 0).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import selection as jsel
from repro.core import utility as jutil
from repro.kernels.rewafl_select import ops as jops
from repro.kernels.rewafl_select import ref as jref
from repro.kernels.rewafl_select import rewafl_select as jkernel
from repro_torch.core import selection as sel
from repro_torch.core.utility import UtilityInputs
from repro_torch.kernels.rewafl_select import ops, ref

K = 8


def _case(seed, S, case, k=K):
    """(avail, five f32 leaves, uniform draw) as numpy; `case` adds ties
    (2k devices) or fewer than k available devices."""
    rng = np.random.RandomState(seed)
    stat, t, e = rng.uniform(0, 1e4, S), rng.uniform(1, 120, S), rng.uniform(10, 2e3, S)
    residual, e0 = rng.uniform(1e3, 6e4, S), rng.uniform(100, 3e3, S)
    u = rng.uniform(0, 1, S)
    avail = rng.uniform(0, 1, S) >= 0.3
    if case == "ties":        # 2k devices share the top utility and draw
        blk = rng.permutation(S)[:2 * k]
        stat[blk], t[blk], e[blk], residual[blk], e0[blk] = 1e4, 1.0, 10.0, 6e4, 100.0
        u[blk] = 0.999
        avail[blk] = True
    elif case == "under_k":
        avail = np.zeros(S, bool)
        avail[rng.permutation(S)[:k // 2 + 1]] = True
    f32 = [np.asarray(a, np.float32) for a in (stat, t, e, residual, e0, u)]
    return avail, f32[:5], f32[5]


def _port(avail, leaves, u):
    return (torch.from_numpy(avail), UtilityInputs(*map(torch.from_numpy, leaves)),
            torch.from_numpy(u))


def _jax_ui(leaves):
    return jutil.UtilityInputs(*map(jnp.asarray, leaves))


@pytest.mark.parametrize("case", ["random", "ties", "under_k"])
@pytest.mark.parametrize("S", [100, 300])
@pytest.mark.parametrize("eps", [0.0, 0.25, 1.0])
def test_mask_matches_pallas_interpret_and_oracle(eps, S, case):
    avail, leaves, _ = _case(S + len(case), S, case)
    key = jax.random.PRNGKey(S)
    u = np.array(jax.random.uniform(key, (S,)))    # the reference's draw
    kw = dict(T_round=60.0, alpha=1.0, beta=1.0)
    ta, tui, tu = _port(avail, leaves, u)
    got = ops.select_mask(tu, K, ta, eps, ui=tui, **kw).numpy()
    jav, jui = jnp.asarray(avail), _jax_ui(leaves)
    want = jref.select_ref(key, K, jav, eps, jui, **kw)
    pallas = jops.select_mask(key, K, jav, eps, ui=jui, backend="pallas",
                              interpret=True, **kw)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, np.asarray(pallas))
    assert got.sum() == min(K, avail.sum()) and not (got & ~avail).any()


@pytest.mark.parametrize("case", ["random", "ties", "under_k"])
@pytest.mark.parametrize("S,k", [(300, 257), (300, 300), (4096, 257), (4096, 4096)])
@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_large_k_mask_matches_oracle(eps, S, k, case):
    """K above 256 and K = S (the CUDA kernel takes any K <= S): masks
    bitwise the reference's `select_ref`, the selection its CPU path."""
    avail, leaves, _ = _case(S + k + len(case), S, case, k)
    key = jax.random.PRNGKey(k)
    u = np.array(jax.random.uniform(key, (S,)))
    kw = dict(T_round=60.0, alpha=1.0, beta=1.0)
    ta, tui, tu = _port(avail, leaves, u)
    got = ops.select_mask(tu, k, ta, eps, ui=tui, **kw).numpy()
    want = jref.select_ref(key, k, jnp.asarray(avail), eps, _jax_ui(leaves), **kw)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.sum() == min(k, avail.sum()) and not (got & ~avail).any()


@pytest.mark.parametrize("n_nan", [1, 3, 12, 40])
@pytest.mark.parametrize("eps", [0.0, 0.25, 1.0])
def test_nan_and_signed_zero_masks_match_oracle(eps, n_nan):
    """NaN utilities (a NaN update landed in θ: the screen off under
    corruption) and ±0 ones, held against the reference's CPU path
    (`select_ref`: `lax.top_k`, the IEEE total order): a negative NaN
    (what x86 arithmetic makes) below every value, the unavailable
    devices' -1e30 included, so a NaN device is selected only when fewer
    than K devices of the fleet have a number; +0 above -0. Masks
    bitwise. The
    reference's Pallas kernel does not define this case (with a NaN
    among the utilities it selects no device at all), and ties ±0."""
    S = 100
    avail, leaves, _ = _case(n_nan, S, "random")
    nan = np.random.RandomState(n_nan).permutation(S)[:2 * n_nan]
    leaves[0][nan[:n_nan]] = -np.float32(np.nan)
    leaves[0][nan[n_nan::2]] = 0.0
    leaves[0][nan[n_nan + 1::2]] = -0.0
    avail[nan[::2]] = True
    if n_nan == 40:   # one number and the NaNs available
        avail[:] = False
        avail[nan[:n_nan + 1]] = True
    key = jax.random.PRNGKey(n_nan)
    u = np.array(jax.random.uniform(key, (S,)))
    kw = dict(T_round=60.0, alpha=1.0, beta=1.0)
    ta, tui, tu = _port(avail, leaves, u)
    got = ops.select_mask(tu, K, ta, eps, ui=tui, **kw).numpy()
    want = jref.select_ref(key, K, jnp.asarray(avail), eps, _jax_ui(leaves), **kw)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert not (got & ~avail).any()
    numbers = ~np.isnan(leaves[0])
    if eps == 0.0:   # NaN ranks below even the unavailable devices' -1e30
        assert got.sum() == min(K, (avail & numbers).sum()) and not (got & ~numbers).any()


def test_positive_nan_ranks_last_too():
    """A positive NaN ranks last like a negative one (`lax.top_k` would put
    it first: the sign a NaN carries depends on each library's ops)."""
    v = torch.tensor([1.0, float("nan"), -float("nan"), 2.0, -0.0, 0.0, -np.inf])
    assert sel.desc_order(v).tolist() == [3, 0, 5, 4, 6, 1, 2]


@pytest.mark.parametrize("eps", [0.0, 0.5])
def test_nan_and_signed_zero_scores_match_reference(eps):
    """The scores path (oort, autofl) in the same total order."""
    S = 40
    rng = np.random.RandomState(7)
    scores = rng.uniform(0, 10, S).astype(np.float32)
    scores[[1, 2, 5, 6]] = -np.float32(np.nan)
    scores[[3, 7, 8]] = [0.0, -0.0, 0.0]
    scores[[4, 9]] = [np.inf, -np.inf]
    avail = rng.uniform(0, 1, S) >= 0.2
    key = jax.random.PRNGKey(3)
    u = np.array(jax.random.uniform(key, (S,)))
    for k in (4, 12, 38):
        got = ops.select_mask(torch.from_numpy(u), k, torch.from_numpy(avail), eps,
                              scores=torch.from_numpy(scores)).numpy()
        want = jops.select_mask(key, k, jnp.asarray(avail), eps,
                                scores=jnp.asarray(scores), backend="xla")
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=str(k))


@pytest.mark.parametrize("k", [257, 300])
def test_large_k_mask_matches_pallas_interpret(k):
    """S 300, K 257 and K = S, against the Pallas kernel in interpret mode
    (at ε = 0: its unrolled K-pass merges make each further compile slow),
    for each case on one compile."""
    S = 300
    key = jax.random.PRNGKey(k)
    u = np.array(jax.random.uniform(key, (S,)))
    kw = dict(T_round=60.0, alpha=1.0, beta=1.0)
    for case in ("random", "ties", "under_k"):
        avail, leaves, _ = _case(k + len(case), S, case, k)
        ta, tui, tu = _port(avail, leaves, u)
        got = ops.select_mask(tu, k, ta, 0.0, ui=tui, **kw).numpy()
        pallas = jops.select_mask(key, k, jnp.asarray(avail), 0.0, ui=_jax_ui(leaves),
                                  backend="pallas", interpret=True, **kw)
        np.testing.assert_array_equal(got, np.asarray(pallas), err_msg=case)


@pytest.mark.parametrize("k_exploit,k_explore", [(8, 0), (6, 2), (0, 8)])
@pytest.mark.parametrize("case", ["random", "ties", "under_k"])
def test_slots_match_pallas_kernel_bitwise(k_exploit, k_explore, case):
    """The plain version returns what the kernel returns: (K,) indices
    and live flags, exploit slots first, each half in rank order. Live
    flags and live indices are bitwise the reference kernel's; a dead
    slot's index is 0 in the port and unspecified in the reference (only
    the mask reads it, through the live flag). S = 200 runs the
    reference kernel over two 128-tiles (padded with unavailable
    devices), so its cross-tile merge is in it."""
    S = 200
    avail, leaves, u = _case(7 + k_explore, S, case)
    kw = dict(k_exploit=k_exploit, k_explore=k_explore, T_round=60.0, alpha=1.0,
              beta=1.0)
    pad = 256 - S

    def p(x, v=0.0):
        return jnp.pad(jnp.asarray(x, jnp.float32), (0, pad), constant_values=v)

    jidx, jlive = jkernel.select_topk(
        p(leaves[0]), p(leaves[1], 1.0), p(leaves[2], 1.0), p(leaves[3]),
        p(leaves[4]), p(avail), p(u), block_s=128, interpret=True, **kw)
    idx, live = ref.select_topk(*_port(avail, leaves, u), **kw)
    jlive = np.asarray(jlive)
    np.testing.assert_array_equal(live.numpy(), jlive)
    np.testing.assert_array_equal(idx.numpy(), np.where(jlive > 0, np.asarray(jidx), 0))
    assert idx.dtype == live.dtype == torch.int32


def test_non_unit_exponents_match_oracle():
    avail, leaves, u = _case(3, 150, "random")
    key = jax.random.PRNGKey(1)
    kw = dict(T_round=60.0, alpha=2.0, beta=0.5)
    got = ops.select_mask(torch.from_numpy(np.array(jax.random.uniform(key, (150,)))),
                          K, torch.from_numpy(avail), 0.25,
                          ui=UtilityInputs(*map(torch.from_numpy, leaves)), **kw)
    want = jref.select_ref(key, K, jnp.asarray(avail), 0.25, _jax_ui(leaves), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("eps", [0.0, 0.1, 0.5, 1.0])
@pytest.mark.parametrize("k", [0, 3, 8, 40])
def test_selection_functions_match_reference(eps, k):
    """top_k_select / random_select / epsilon_greedy on plain scores,
    with ties (scores rounded to a few values) and k beyond S."""
    S = 33
    rng = np.random.RandomState(k)
    scores = np.round(rng.uniform(0, 4, S)).astype(np.float32)
    avail = rng.uniform(0, 1, S) >= 0.25
    key = jax.random.PRNGKey(k)
    u = np.asarray(jax.random.uniform(key, (S,)))
    ts, ta, tu = torch.from_numpy(scores), torch.from_numpy(avail), torch.tensor(u)
    js, ja = jnp.asarray(scores), jnp.asarray(avail)
    np.testing.assert_array_equal(sel.top_k_select(ts, k, ta).numpy(),
                                  np.asarray(jsel.top_k_select(js, k, ja)))
    np.testing.assert_array_equal(sel.random_select(tu, k, ta).numpy(),
                                  np.asarray(jsel.random_select(key, k, ja)))
    np.testing.assert_array_equal(sel.epsilon_greedy(tu, ts, k, ta, eps).numpy(),
                                  np.asarray(jsel.epsilon_greedy(key, js, k, ja, eps)))
    for kk in range(0, 9):
        assert sel._explore_slots(eps, kk) == jsel._explore_slots(eps, kk)


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    avail, leaves, u = _case(0, 50, "random")
    before = ops.launches
    idx, live = ops.select_topk(*_port(avail, leaves, u), k_exploit=4, k_explore=1,
                                T_round=60.0, alpha=1.0, beta=1.0)
    assert ops.launches == before and idx.shape == live.shape == (5,)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.select_topk(*(x.to("meta") if isinstance(x, torch.Tensor) else
                          UtilityInputs(*(y.to("meta") for y in x))
                          for x in _port(avail, leaves, u)),
                        k_exploit=4, k_explore=1, T_round=60.0, alpha=1.0, beta=1.0)


def _scores_case(seed, S, case, k):
    """(scores, avail) as numpy; `case` adds ties (scores on three
    values), all-zero scores, fewer than k available, or none."""
    rng = np.random.RandomState(seed)
    scores = rng.uniform(0, 1e3, S).astype(np.float32)
    avail = rng.uniform(0, 1, S) >= 0.2
    if case == "ties":
        scores = np.round(rng.uniform(0, 2, S)).astype(np.float32)
    elif case == "zeros":     # autofl's bandit before any reward, say
        scores[:] = 0.0
    elif case == "under_k":
        avail[:] = False
        avail[rng.permutation(S)[:max(0, k - 2)]] = True
    elif case == "none":
        avail[:] = False
    return scores, avail


@pytest.mark.parametrize("case", ["random", "ties", "zeros", "under_k", "none"])
@pytest.mark.parametrize("S", [1, 10, 300])
@pytest.mark.parametrize("eps", [0.0, 0.1, 1.0])
def test_scores_path_matches_reference(eps, S, case):
    """`select_mask(..., scores=)` against the reference's: bitwise, for
    K below, at and above the explore quota's rounding, ties to the
    lower index."""
    for k in sorted({1, 4, 20} | {S}):
        scores, avail = _scores_case(S + k + len(case), S, case, k)
        key = jax.random.PRNGKey(S * 31 + k)
        u = torch.from_numpy(np.array(jax.random.uniform(key, (S,))))
        got = ops.select_mask(u, k, torch.from_numpy(avail), eps,
                              scores=torch.from_numpy(scores))
        want = jops.select_mask(key, k, jnp.asarray(avail), eps,
                                scores=jnp.asarray(scores), backend="xla")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=str(k))
        assert got.sum() == min(k, S, avail.sum()) and not (got.numpy() & ~avail).any()


def test_select_mask_takes_exactly_one_scoring():
    avail, leaves, u = _case(0, 20, "random")
    ta, tui, tu = _port(avail, leaves, u)
    with pytest.raises(ValueError, match="exactly one"):
        ops.select_mask(tu, 4, ta, 0.0)
    with pytest.raises(ValueError, match="exactly one"):
        ops.select_mask(tu, 4, ta, 0.0, scores=tu, ui=tui)


def _aggregate_case(seed, S, P, case, k):
    avail, leaves, _ = _case(seed, S, case, k)
    rng = np.random.RandomState(seed + 1)
    deltas = rng.standard_normal((S, P)).astype(np.float32)
    weights = (rng.uniform(0, 1, S) + 0.5).astype(np.float32)
    return avail, leaves, deltas, weights


def _select_aggregate_both(key, k, eps, avail, leaves, deltas, weights, kw, **jkw):
    S = avail.shape[0]
    u = torch.from_numpy(np.array(jax.random.uniform(key, (S,))))
    ta, tui, _ = _port(avail, leaves, u.numpy())
    got = ops.select_aggregate(u, k, ta, eps, tui, torch.from_numpy(deltas),
                               torch.from_numpy(weights), **kw)
    plain = ref.select_aggregate(u, k, ta, eps, tui, torch.from_numpy(deltas),
                                 torch.from_numpy(weights), **kw)
    args = (key, k, jnp.asarray(avail), eps, _jax_ui(leaves), jnp.asarray(deltas),
            jnp.asarray(weights))
    want = (jops.select_aggregate(*args, **kw, **jkw) if jkw
            else jref.select_aggregate_ref(*args, **kw))
    return got, plain, want


def _assert_aggregate(got, want, avail, k):
    mask, agg = got
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want[0]))
    assert mask.dtype == torch.bool and agg.dtype == torch.float32
    np.testing.assert_allclose(agg.numpy(), np.asarray(want[1]), rtol=0, atol=1e-5)
    assert mask.sum() == min(k, avail.sum())


@pytest.mark.parametrize("case", ["random", "ties", "under_k"])
@pytest.mark.parametrize("k", [0, 1, 8])
def test_select_aggregate_matches_pallas_interpret(case, k):
    """At ε 0: the reference's fused pass (the select kernel in interpret
    mode, a K-row gather, its fedavg kernel in interpret mode)."""
    S, P = 200, 48
    avail, leaves, deltas, weights = _aggregate_case(k + len(case), S, P, case, 8)
    kw = dict(T_round=60.0, alpha=1.0, beta=1.0)
    got, plain, want = _select_aggregate_both(
        jax.random.PRNGKey(k), k, 0.0, avail, leaves, deltas, weights, kw,
        backend="pallas", interpret=True)
    _assert_aggregate(got, want, avail, k)
    _assert_aggregate(plain, want, avail, k)


@pytest.mark.parametrize("case", ["random", "ties", "under_k"])
@pytest.mark.parametrize("S,k", [(10, 4), (200, 8), (300, 257)])
@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_select_aggregate_matches_oracle(eps, S, k, case):
    """Against `select_aggregate_ref` (the dense masked S-row sum), with
    explore slots at ε 0.1 and above 256 selected rows."""
    avail, leaves, deltas, weights = _aggregate_case(S + k + len(case), S, 40, case, k)
    kw = dict(T_round=60.0, alpha=2.0, beta=0.5)
    got, plain, want = _select_aggregate_both(
        jax.random.PRNGKey(S + k), k, eps, avail, leaves, deltas, weights, kw)
    _assert_aggregate(got, want, avail, k)
    _assert_aggregate(plain, want, avail, k)


@pytest.mark.parametrize("case", ["random", "under_k"])
def test_select_aggregate_nan_row_zero_matches_pallas_interpret(case):
    """A NaN in row 0 of the deltas, device 0 unavailable: the reference's
    fused pass reads each dead slot as row 0 at weight 0 (0 · NaN = NaN),
    and so does the port's. NaN at the same positions (none when every
    slot is live), the rest within atol 1e-5. (The dense plain version,
    like the reference's dense oracle, multiplies every row: NaN wherever
    row 0 is.)"""
    S, P, k = 200, 48, 8
    avail, leaves, deltas, weights = _aggregate_case(11 + len(case), S, P, case, k)
    avail[0] = False
    deltas[0, ::5] = np.nan
    kw = dict(T_round=60.0, alpha=1.0, beta=1.0)
    (mask, agg), _, want = _select_aggregate_both(
        jax.random.PRNGKey(3), k, 0.0, avail, leaves, deltas, weights, kw,
        backend="pallas", interpret=True)
    nan = np.isnan(np.asarray(want[1]))
    assert int(nan.sum()) == (0 if case == "random" else -(-P // 5))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(np.isnan(agg.numpy()), nan)
    np.testing.assert_allclose(agg.numpy()[~nan], np.asarray(want[1])[~nan],
                               rtol=0, atol=1e-5)


def test_select_aggregate_runs_plain_versions_on_cpu_without_counting():
    from repro_torch.kernels.fedavg import ops as fedavg_ops
    avail, leaves, deltas, weights = _aggregate_case(5, 30, 7, "random", 4)
    ta, tui, tu = _port(avail, leaves, np.linspace(0, 1, 30, dtype=np.float32))
    before = ops.launches, fedavg_ops.launches
    mask, agg = ops.select_aggregate(tu, 4, ta, 0.5, tui, torch.from_numpy(deltas),
                                     torch.from_numpy(weights), T_round=60.0,
                                     alpha=1.0, beta=1.0)
    assert (ops.launches, fedavg_ops.launches) == before
    assert mask.shape == (30,) and agg.shape == (7,) and int(mask.sum()) == 4


@pytest.mark.parametrize("k_exploit,k_explore", [(8, 0), (6, 2), (0, 8)])
@pytest.mark.parametrize("case", ["random", "ties", "under_k"])
def test_vmap_runs_the_batched_selection_equal_to_single_calls(k_exploit, k_explore,
                                                               case):
    """Under `torch.func.vmap` (a seed batch) the selection op's vmap rule
    runs the batched op once (one launch on the card): bitwise the loop
    of single selections, with a leaf shared (unbatched) too; the
    batched plain version is each selection's plain version."""
    B, S = 4, 60
    cases = [_case(b * 7 + len(case), S, case) for b in range(B)]
    avail = torch.from_numpy(np.stack([c[0] for c in cases]))
    leaves = UtilityInputs(*(torch.from_numpy(np.stack([c[1][i] for c in cases]))
                             for i in range(5)))
    u = torch.from_numpy(np.stack([c[2] for c in cases]))
    kw = dict(k_exploit=k_exploit, k_explore=k_explore, T_round=60.0, alpha=1.0,
              beta=1.0)

    def one(a, stat, t, e, r, e0, uu):
        return ops.select_topk(a, UtilityInputs(stat, t, e, r, e0), uu, **kw)

    # e0 shared by every selection: an unbatched argument
    got = torch.func.vmap(one, in_dims=(0, 0, 0, 0, 0, None, 0))(
        avail, *leaves[:4], leaves.e0[0], u)
    want = [ops.select_topk(avail[b], UtilityInputs(*(x[b] for x in leaves[:4]),
                                                    leaves.e0[0]), u[b], **kw)
            for b in range(B)]
    for i in range(2):
        assert torch.equal(got[i], torch.stack([w[i] for w in want]))
    e0 = UtilityInputs(*leaves[:4], leaves.e0[0].expand(B, S))
    for fn in (ref.select_topk_batched, ops.select_topk_batched):
        out = fn(avail, e0, u, **kw)
        assert all(torch.equal(out[i], got[i]) for i in range(2))


@pytest.mark.parametrize("eps", [0.0, 0.1, 1.0])
def test_select_traced_is_the_static_selection(eps):
    """`select_traced`, the campaign grid's selection with a tensor ε,
    gives the static `select_mask(scores=)` masks at equal ε, and under
    vmap over cells each cell's."""
    masks = []
    for b in range(3):
        scores, avail = _scores_case(b, 40, "ties", 8)
        u = torch.from_numpy(np.array(jax.random.uniform(jax.random.PRNGKey(b), (40,))))
        got = ops.select_traced(u, torch.from_numpy(scores), 8,
                                torch.from_numpy(avail), torch.tensor(eps))
        want = ops.select_mask(u, 8, torch.from_numpy(avail), eps,
                               scores=torch.from_numpy(scores))
        assert torch.equal(got, want)
        masks.append((u, torch.from_numpy(scores), torch.from_numpy(avail), got))
    u, s, a, m = (torch.stack(x) for x in zip(*masks))
    v = torch.func.vmap(lambda u, s, a, e: ops.select_traced(u, s, 8, a, e))(
        u, s, a, torch.full((3,), eps))
    assert torch.equal(v, m)
