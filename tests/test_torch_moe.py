"""Parity of the port's moe family (`nn/moe`, the MoE blocks, the moe
serving path) with the reference, on the CPU.

The reference runs off-mesh (`UNSHARDED`), where `moe_forward` is the
dense oracle; its weights are carried across by `params_from_jax`.
Inputs come from numpy seeds. Tolerances:
- `route`: the choice exactly on every token whose k-th and (k+1)-th
  probabilities are more than ROUTE_GAP (1e-6) apart, and on exact ties
  (to the lower index); gates, `lb_loss` and `z_loss` within ROUTE_TOL
  (1e-6, absolute and relative): two libraries sum the f32 logits and
  the softmax in other orders.
- `moe_forward_dense` on the same inputs: with f32 weights within
  MOE_F32_REL (1e-5) of the output's scale (max |out|); with bf16
  weights within MOE_BF16_REL (2**-6) of it: both sides round to bf16
  five times in a chain (the gate and up products, silu(g)·u, the down
  product, the combine, the shared expert's sum), and a value on a
  rounding boundary lands one bf16 step (2**-8 relative) apart at each
  (measured up to 1.2e-2). Both run the router in f32 on the same inputs,
  so a flip there is held to ROUTE_GAP.
- Prefill and four greedy decode steps of reduced olmoe-1b-7b (2 MoE
  layers of 4 experts, top 2) and kimi-k2-1t-a32b (a dense prefix layer,
  then one MoE layer with a shared expert) at `test_torch_lm.py`'s
  tolerances: f32 weights prefill logits within 1e-5 and decode logits
  within 2e-4 of their scale, bf16 weights within 3e-2; argmax ids
  exactly; caches as there. Under the flip rule (`tests/moe_flip_rule.py`):
  a first-order flip within GAP_BOUND of a tie on the reference side,
  every router input no flip reached within the logits' tolerance of its
  scale, and the logits, ids and cache slots that no flip reached at the
  tolerances above. GAP_BOUND from the router inputs' difference: with
  f32 weights the inputs agree within 2e-4 of their scale (decode reads
  bf16 caches), so a logit (a sum over d_model of x·w, |x·w| ~ 1) moves by
  less than ~1e-4 and a probability by less than a quarter of that:
  GAP_BOUND_F32 = 1e-4 leaves a margin of four; with bf16 weights the
  inputs agree within 3e-2 of their scale, one to a few bf16 steps, so a
  probability moves by up to ~1e-2: GAP_BOUND_BF16 = 2**-5.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import get_model_api as j_get_model_api
from repro.nn import moe as jmoe
from repro.nn.sharding import UNSHARDED
from repro_torch.configs import get_config, list_archs, param_count
from repro_torch.launch.serve import serve
from repro_torch.models.api import get_model_api
from repro_torch.models.lm import params_from_jax
from repro_torch.nn import moe
from moe_flip_rule import check_flip_rule, check_served, record_port_routes

ROUTE_GAP, ROUTE_TOL = 1e-6, 1e-6
MOE_F32_REL, MOE_BF16_REL = 1e-5, 2.0 ** -6
PREFILL_REL, DECODE_REL, BF16_REL = 1e-5, 2e-4, 3e-2
DECODE_CACHE_ATOL, BF16_CACHE_REL, BF16_RTOL = 1e-3, 2e-2, 2.0 ** -7
GAP_BOUND_F32, GAP_BOUND_BF16 = 1e-4, 2.0 ** -5
B, S, DECODE = 2, 12, 4
MOE_ARCHS = ["olmoe-1b-7b", "kimi-k2-1t-a32b"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32) if hasattr(x, "astype") else x)


def _rel_err(got, want):
    got, want = _np(got), _np(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@contextlib.contextmanager
def record_reference_routes():
    """Record every call of the reference's router, as
    `record_port_routes` does the port's: a host callback, in call order,
    from inside the reference's layer scan and its jitted decode."""
    orig, log = jmoe.route, []

    def route(router_params, x_flat, cfg):
        out = orig(router_params, x_flat, cfg)
        xf = x_flat.astype(jnp.float32)
        probs = jax.nn.softmax(xf @ router_params["w"], axis=-1)
        jax.debug.callback(lambda x, p, i: log.append(
            (np.asarray(x), np.asarray(p), np.asarray(i))), xf, probs, out[0],
            ordered=True)
        return out

    jmoe.route = route
    try:
        yield log
    finally:
        jmoe.route = orig


def _moe_cfgs(E, K, D=64, F=32, shared=0):
    return (jmoe.MoECfg(D, F, E, K, shared_d_ff=shared),
            moe.MoECfg(D, F, E, K, shared_d_ff=shared))


# ------------------------------------------------------------------ route

def _tie_inputs(N, D, E, rng):
    """Integer inputs and router columns, a power of two apart, so every
    logit is exact in f32 in any sum order; columns repeated in pairs,
    and every fourth row zero: exact ties within and across the top k."""
    x = rng.randint(-2, 3, (N, D)).astype(np.float32)
    x[::4] = 0.0
    w = rng.randint(-2, 3, (D, E // 2)).astype(np.float32) * 0.125
    return x, np.repeat(w, 2, axis=1)


@pytest.mark.parametrize("E,K,case", [(8, 2, "random"), (16, 4, "random"),
                                      (4, 2, "random"), (8, 2, "ties"),
                                      (16, 4, "ties")])
def test_route_matches_reference(E, K, case):
    rng = np.random.RandomState(E + K)
    N, D = 96, 64
    if case == "ties":
        x, w = _tie_inputs(N, D, E, rng)
    else:
        x = rng.standard_normal((N, D)).astype(np.float32) * 2
        w = (rng.standard_normal((D, E)) / np.sqrt(D)).astype(np.float32)
    jcfg, cfg = _moe_cfgs(E, K)
    jtop, jgates, jaux = jmoe.route({"w": jnp.asarray(w)}, jnp.asarray(x), jcfg)
    top, gates, aux = moe.route({"w": _t(w)}, _t(x), cfg)
    assert top.shape == (N, K) and gates.dtype == torch.float32
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(w), axis=-1)
    srt = -np.sort(-np.asarray(probs), axis=-1)
    far = srt[:, K - 1] - srt[:, K] > ROUTE_GAP
    if case == "ties":   # exact ties go to the lower index on both sides
        far[:] = True
        assert (srt[:, K - 1] == srt[:, K]).sum() >= N // 4
    np.testing.assert_array_equal(top.numpy()[far], np.asarray(jtop)[far])
    np.testing.assert_allclose(gates.numpy(), np.asarray(jgates), rtol=ROUTE_TOL,
                               atol=ROUTE_TOL)
    for k in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=ROUTE_TOL,
                                   atol=ROUTE_TOL)


# -------------------------------------------------------- moe_forward_dense

@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared", [0, 48])
@pytest.mark.parametrize("E,K", [(8, 2), (16, 4), (4, 2)])
def test_moe_forward_dense_matches_reference(E, K, shared, param_dtype):
    jcfg, cfg = _moe_cfgs(E, K, shared=shared)
    jdt = getattr(jnp, param_dtype)
    jparams = jmoe.moe_init(jax.random.PRNGKey(E * 10 + K + shared), jcfg, dtype=jdt)
    params = params_from_jax(jparams, device="cpu")
    assert params["router"]["w"].dtype == torch.float32   # f32 whatever the model's
    assert params["experts"]["w_gate"].dtype == getattr(torch, param_dtype)
    x = np.random.RandomState(E + shared).standard_normal((2, 10, 64)).astype(np.float32)
    jx = jnp.asarray(x).astype(jdt)
    with record_reference_routes() as rlog:
        jout, jaux = jmoe.moe_forward(jparams, jx, jcfg, UNSHARDED)
    with record_port_routes() as plog:
        out, aux = moe.moe_forward(params, _t(np.asarray(jx.astype(jnp.float32))).to(
            getattr(torch, param_dtype)), cfg)
    assert out.dtype == getattr(torch, param_dtype) and out.shape == x.shape
    rep = check_flip_rule(plog, rlog, batch=2, prompt_len=10, n_moe=1,
                          gap_bound=ROUTE_GAP, state_rel=0.0)
    keep = np.ones(20, bool)
    keep[[f.seq * 10 + f.pos for f in rep.flips]] = False
    rel = MOE_F32_REL if param_dtype == "float32" else MOE_BF16_REL
    got, want = _np(out).reshape(20, -1), _np(jout).reshape(20, -1)
    err = np.abs(got[keep] - want[keep]).max() / np.abs(want).max()
    assert err <= rel, (err, rel, rep.lines("moe_forward_dense"))
    for k in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=ROUTE_TOL,
                                   atol=ROUTE_TOL)


def test_an_unselected_expert_that_overflows_gives_nan_as_in_the_reference():
    """The dense oracle weighs every unselected expert's output by 0, and
    0 · inf is NaN: a property of the reference the port keeps."""
    jcfg, cfg = _moe_cfgs(4, 2)
    jparams = jmoe.moe_init(jax.random.PRNGKey(5), jcfg)
    jparams["router"]["w"] = jparams["router"]["w"].at[:, 3].set(-1e3)   # never chosen
    jparams["experts"]["w_down"] = jparams["experts"]["w_down"].at[3].set(1e38)
    params = params_from_jax(jparams, device="cpu")
    x = np.abs(np.random.RandomState(0).standard_normal((1, 6, 64))).astype(np.float32)
    jout, _ = jmoe.moe_forward(jparams, jnp.asarray(x), jcfg, UNSHARDED)
    out, _ = moe.moe_forward(params, _t(x), cfg)
    np.testing.assert_array_equal(np.isnan(out.numpy()), np.isnan(np.asarray(jout)))
    assert np.isnan(out.numpy()).any()


# ------------------------------------------------------------ the serving path

def _assert_cache_close(got, want, clean, *, bf16, decoded):
    """Held where `clean` (a (..., B, W) mask over the stacked caches'
    slots) says no flip reached the slot."""
    got, want = _np(got)[clean], _np(want)[clean]
    if bf16:
        assert np.abs(got - want).max() <= BF16_CACHE_REL * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL,
                                   atol=DECODE_CACHE_ATOL if decoded else 1e-6)


def _clean_slots(rep, pos, n_layers, first_call):
    """(L, B, W) mask of the stacked caches' slots no flip reached: layer
    l's slot at position p is written by the call before layer `first_call
    + l`'s router at p (the prefix stack's layers come before any MoE
    call: first_call None)."""
    out = np.zeros((n_layers, B, pos.shape[-1]), bool)
    for l in range(n_layers):
        for b in range(B):
            for j, p in enumerate(pos[l].tolist()):
                call = 0 if first_call is None else rep.call_of(first_call + l, p)
                out[l, b, j] = rep.clean(b, p, call)
    return out


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_and_greedy_decode_match_reference(arch, param_dtype):
    jcfg, cfg = j_get_config(arch, reduced=True), get_config(arch, reduced=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jcfg = dataclasses.replace(jcfg, param_dtype=param_dtype)
    cfg = dataclasses.replace(cfg, param_dtype=param_dtype)
    bf16 = param_dtype == "bfloat16"
    prefill_rel, decode_rel = (BF16_REL,) * 2 if bf16 else (PREFILL_REL, DECODE_REL)
    n_moe = cfg.n_layers - cfg.moe.n_dense_prefix
    japi, api = j_get_model_api(jcfg), get_model_api(cfg)
    jparams = japi.init_params(jax.random.PRNGKey(7), jcfg, UNSHARDED)
    params = params_from_jax(jparams, device="cpu")
    tokens = np.random.RandomState(11).randint(0, cfg.vocab, (B, S)).astype(np.int32)
    jdecode = jax.jit(lambda p, b, s: japi.decode_step(p, b, s, jcfg, UNSHARDED))
    logits = []
    with record_reference_routes() as rlog, record_port_routes() as plog:
        jl, jstate = japi.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, UNSHARDED)
        l, state = api.prefill(params, {"tokens": _t(tokens).long()}, cfg)
        assert l.shape == (B, 1, cfg.vocab) and l.dtype == getattr(torch, param_dtype)
        assert (state["prefix"] is None) == (jstate["prefix"] is None)
        # decode writes the caches in place: keep the prefill's
        pre = ({k: None if c is None else c._replace(k=c.k.clone(), v=c.v.clone(),
                                                      pos=c.pos.clone())
                for k, c in state.items()}, jstate)
        logits.append((l, jl))
        for _ in range(DECODE):
            tok = jnp.argmax(jl[:, -1, :], -1).astype(jnp.int32)[:, None]
            jl, jstate = jdecode(jparams, {"tokens": tok}, jstate)
            l, state = api.decode_step(params, {"tokens": _t(tok).long()}, state, cfg)
            logits.append((l, jl))
        jax.effects_barrier()
    rel = BF16_REL if bf16 else DECODE_REL
    rep = check_flip_rule(plog, rlog, batch=B, prompt_len=S, n_moe=n_moe,
                          gap_bound=GAP_BOUND_BF16 if bf16 else GAP_BOUND_F32,
                          state_rel=rel, name=f"{arch} {param_dtype}")
    print("\n".join(rep.lines(f"{arch} {param_dtype}")))
    # logits and greedy ids of every row no flip reached
    for step, (l, jl) in enumerate(logits):
        pos, call = S - 1 + step, n_moe * (step + 1)
        for b in range(B):
            if rep.clean(b, pos, call):
                assert _rel_err(l[b], jl[b]) <= (prefill_rel if step == 0 else decode_rel)
                assert int(l[b, -1].argmax()) == int(jnp.argmax(jl[b, -1]))
    # the caches: dtype, shape, positions and length exactly, slots no flip reached
    for (st, jst), decoded in ((pre, False), ((state, jstate), True)):
        for key, first_call in (("prefix", None), ("moe", 0)):
            c, jc = st[key], jst.get(key)
            if c is None:
                continue
            assert c.k.dtype == torch.bfloat16 and tuple(c.k.shape) == jc.k.shape
            np.testing.assert_array_equal(c.pos.numpy(), np.asarray(jc.pos))
            assert c.length == int(jc.length)
            clean = _clean_slots(rep, c.pos.numpy(), c.k.shape[0], first_call)
            for a, ja in ((c.k, jc.k), (c.v, jc.v)):
                _assert_cache_close(a, ja, clean, bf16=bf16, decoded=decoded)
    assert state["moe"].length == S + DECODE
    # the ring wrapped: slots 0..DECODE-1 now hold positions S..S+DECODE-1
    assert state["moe"].pos[0, :DECODE].tolist() == list(range(S, S + DECODE))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_init_decode_state_matches_reference(arch):
    jcfg, cfg = j_get_config(arch, reduced=True), get_config(arch, reduced=True)
    jstate = j_get_model_api(jcfg).init_decode_state(jcfg, 2, 16, UNSHARDED)
    state = get_model_api(cfg).init_decode_state(cfg, 2, 16, device="cpu")
    assert sorted(state) == sorted(jstate)
    for key in state:
        c, jc = state[key], jstate[key]
        assert tuple(c.k.shape) == jc.k.shape and c.length == int(jc.length)
        np.testing.assert_array_equal(c.pos.numpy(), np.asarray(jc.pos))
        assert c.k.dtype == torch.float32 and not c.k.any() and not c.v.any()


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_configs_match_reference(arch, reduced):
    from repro.configs import param_count as j_param_count
    cfg, jcfg = get_config(arch, reduced=reduced), j_get_config(arch, reduced=reduced)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert param_count(cfg) == j_param_count(jcfg)
    assert arch in list_archs()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_get_model_api_serves_the_moe_family(arch):
    from repro_torch.models import lm
    api = get_model_api(get_config(arch, reduced=True))
    assert (api.prefill, api.decode_step, api.init_decode_state, api.init_params) == (
        lm.moe_prefill, lm.moe_decode_step, lm.moe_init_decode_state, lm.moe_init)


def test_moe_loss_raises_naming_the_roadmap():
    cfg = get_config("olmoe-1b-7b", reduced=True)
    with pytest.raises(NotImplementedError, match="ROADMAP A16"):
        get_model_api(cfg).loss_fn({}, {}, cfg)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_init_leaves_match_the_reference_tree(arch):
    """The port's init draws the reference's tree: the same key paths,
    shapes and dtypes (the routers f32 in a bf16 model)."""
    jcfg, cfg = j_get_config(arch, reduced=True), get_config(arch, reduced=True)
    jcfg = dataclasses.replace(jcfg, param_dtype="bfloat16")
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    jparams = j_get_model_api(jcfg).init_params(jax.random.PRNGKey(0), jcfg, UNSHARDED)
    params = get_model_api(cfg).init_params(torch.Generator().manual_seed(0), cfg)

    def leaves(tree, path=()):
        for k, v in tree.items():
            yield from (leaves(v, path + (k,)) if isinstance(v, dict)
                        else [(path + (k,), tuple(v.shape), str(v.dtype).split(".")[-1])])
    assert sorted(leaves(params)) == sorted(leaves(jparams))
    assert params["moe_stack"]["moe"]["router"]["w"].dtype == torch.float32


def test_moe_serve_cpu_runs_the_example_loop():
    kw = dict(reduced=True, batch=2, prompt_len=10, tokens=3, seed=1, device="cpu")
    res = serve("olmoe-1b-7b", **kw)
    assert res.ids.shape == (2, 4) and res.last_logits.shape == (2, 512)
    assert res.flash_launches == 0 and torch.isfinite(res.last_logits).all()
    again = serve("olmoe-1b-7b", **kw)
    assert torch.equal(res.ids, again.ids)
    assert torch.equal(res.last_logits, again.last_logits)


# ------------------------------------------------------------- the flip rule

def _calls(B_, S_, n_moe, steps, E=4, K=2, seed=0):
    """Synthetic router calls: a prefill and `steps` decode steps; each
    token's probabilities far from a tie (gap >= 0.1)."""
    rng = np.random.RandomState(seed)
    out = []
    for c in range(n_moe * (1 + steps)):
        N = B_ * S_ if c < n_moe else B_
        p = np.tile(np.array([0.4, 0.3, 0.2, 0.1], np.float32), (N, 1))
        x = rng.standard_normal((N, 8)).astype(np.float32)
        out.append((x, p, np.tile(np.arange(K), (N, 1))))
    return out


def _flip(calls, c, n):
    """A copy of `calls` whose call c routes token n to experts {0, 2}."""
    calls = [tuple(a.copy() for a in call) for call in calls]
    calls[c][2][n] = [0, 2]
    return calls


def test_flip_rule_takes_a_near_tie_and_refuses_a_far_flip():
    ref = _calls(2, 3, 2, 1)
    ref[0][1][4] = [0.4, 0.3, 0.3 - 1e-7, 0.0]   # seq 1, pos 1: within 1e-7 of a tie
    rep = check_flip_rule(_flip(ref, 0, 4), ref, batch=2, prompt_len=3, n_moe=2,
                          gap_bound=1e-6, state_rel=0.0)
    assert [(f.call, f.seq, f.pos, f.first_order) for f in rep.flips] == [(0, 1, 1, True)]
    with pytest.raises(AssertionError, match="first-order flip"):
        check_flip_rule(_flip(ref, 0, 3), ref, batch=2, prompt_len=3, n_moe=2,
                        gap_bound=1e-6, state_rel=0.0)
    # a swap inside the top k is no flip
    swapped = [tuple(a.copy() for a in call) for call in ref]
    swapped[1][2][0] = [1, 0]
    assert check_flip_rule(swapped, ref, batch=2, prompt_len=3, n_moe=2,
                           gap_bound=0.0, state_rel=0.0).flips == []


def test_flip_rule_exempts_what_a_flip_reached_and_holds_the_rest():
    ref = _calls(2, 3, 2, 2)
    near = [0.4, 0.3, 0.3, 0.0]
    ref[0][1][1] = near                           # seq 0, pos 1: an exact tie
    port = _flip(ref, 0, 1)
    # what the flip reached: seq 0 at pos >= 1 from call 1 on, and every
    # later decode token of seq 0, moves; a downstream flip at a far gap
    for c in range(1, len(port)):
        N = port[c][0].shape[0]
        hit = [n for n in range(N) if (c < 2 and n // 3 == 0 and n % 3 >= 1)
               or (c >= 2 and n == 0)]
        port[c][0][hit] += 10.0
    port[1][2][2] = [0, 2]                        # call 1, seq 0, pos 2: downstream
    port[2][2][0] = [0, 3]                        # decode step 0, seq 0: downstream
    rep = check_flip_rule(port, ref, batch=2, prompt_len=3, n_moe=2,
                          gap_bound=1e-6, state_rel=1e-6)
    assert [(f.call, f.seq, f.pos, f.first_order) for f in rep.flips] == [
        (0, 0, 1, True), (1, 0, 2, False), (2, 0, 3, False)]
    assert rep.clean(1, 4, 6) and rep.clean(0, 0, 6) and not rep.clean(0, 1, 1)
    assert rep.clean(0, 1, 0) and rep.call_of(1, 4) == 5
    # an input the flip could not reach must agree
    port[3][0][1] += 1.0                          # decode step 0, layer 1, seq 1
    with pytest.raises(AssertionError, match="router inputs"):
        check_flip_rule(port, ref, batch=2, prompt_len=3, n_moe=2,
                        gap_bound=1e-6, state_rel=1e-6)


def test_check_served_holds_a_cpu_serve_to_itself():
    """The card's check (`check_served`) on two CPU serves of reduced
    kimi-k2-1t-a32b from the same weights: no flip, every id and the last
    logits held, and one router call a MoE layer and step recorded."""
    cfg = get_config("kimi-k2-1t-a32b", reduced=True)
    params = get_model_api(cfg).init_params(torch.Generator().manual_seed(3), cfg)
    kw = dict(reduced=True, batch=2, prompt_len=9, tokens=3, seed=5, device="cpu",
              params=params)
    with record_port_routes() as a_log:
        a = serve("kimi-k2-1t-a32b", **kw)
    with record_port_routes() as b_log:
        b = serve("kimi-k2-1t-a32b", **kw)
    assert len(a_log) == len(b_log) == 1 + 3   # one MoE layer: the prefill, 3 steps
    rep = check_served(a, b, a_log, b_log, n_moe=1, dtype="float32")
    assert rep.flips == [] and rep.logit_err == 0.0 and rep.max_state_err == 0.0
