"""Parity of the port's xLSTM blocks (`repro_torch.nn.xlstm`) and of its
xlstm-1.3b serving path (`repro_torch.models.lm` xlstm family) with the
reference, on the CPU.

Blocks at small widths (d 64, 4 heads) with f32 weights, the reference's
parameters carried across by `params_from_jax`: `mlstm_forward` at L = 40,
64 and 128 (one chunk of 40, one of 64, two of 64 with the state carried
across), `mlstm_decode_step`, `slstm_forward` (its recurrence through the
kernel wrapper's plain version) and `slstm_decode_step`, outputs and
states within atol 1e-5 (measured ≤ 1.2e-6: other summation orders and
last-bit differences of exp and tanh); `causal_depthwise_conv1d` within
1e-6; and the mLSTM chunk rule (L = 100 raises).

The whole slice: reduced xlstm-1.3b (8 layers, d 256, 4 groups of 1 sLSTM
+ 1 mLSTM) through the reference's `get_model_api` and the port's, with
f32 and with bf16 weights: prefill logits, then four greedy decode steps.
Ids equal. With f32 weights the logits and every state leaf lie within
1e-4 of their scale (measured ≤ 5.9e-6). With bf16 weights every matmul,
norm and activation rounds to bf16 on both sides, but not always at the
same places (XLA may keep f32 between fused elementwise ops), so a value
one bf16 step apart travels through the layers: logits within 3e-2 of
their scale (measured ≤ 1.1e-2), the states of the deeper layers within
8e-2 (measured ≤ 4.0e-2), while the first sLSTM layer, whose inputs agree
bitwise, keeps its state within 1e-5 of scale (measured ≤ 2e-7). The conv
buffers are exactly zero after prefill, as the reference resets them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import param_count as j_param_count
from repro.models import get_model_api as j_get_model_api
from repro.nn import layers as jlayers
from repro.nn import xlstm as jx
from repro.nn.sharding import UNSHARDED
from repro_torch.configs import get_config, param_count
from repro_torch.launch.serve import serve
from repro_torch.models.api import get_model_api
from repro_torch.models.lm import params_from_jax
from repro_torch.nn import layers, xlstm

ATOL = 1e-5
F32_REL, BF16_REL = 1e-4, 3e-2
BF16_STATE_REL = 8e-2
B, D, NH = 2, 64, 4


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a).astype(np.float32)))


def _x(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=1e-5)


def _close_to_scale(got, want, rel):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("L", [40, 64, 128])
def test_mlstm_forward_matches_reference(L):
    md = jx.mlstm_dims(D, NH)
    jp = jx.mlstm_init(jax.random.PRNGKey(L), md)
    x = _x((B, L, D), L)
    jout, jst = jx.mlstm_forward(jp, jnp.asarray(x), md, return_state=True)
    out, st = xlstm.mlstm_forward(params_from_jax(jp, "cpu"), _t(x), xlstm.mlstm_dims(D, NH),
                                  return_state=True)
    _close(out, jout)
    for got, want in zip(st, jst):
        _close(got, want)


def test_mlstm_chunk_rule_raises():
    md = xlstm.mlstm_dims(D, NH)
    p = xlstm.mlstm_init(torch.Generator().manual_seed(0), md)
    with pytest.raises(ValueError, match="chunk"):
        xlstm.mlstm_forward(p, torch.zeros(B, 100, D), md)


def test_mlstm_decode_step_matches_reference():
    md = jx.mlstm_dims(D, NH)
    jp = jx.mlstm_init(jax.random.PRNGKey(1), md)
    p = params_from_jax(jp, "cpu")
    # a state reached by a prefill, and a conv buffer of earlier tokens
    _, jst = jx.mlstm_forward(jp, jnp.asarray(_x((B, 64, D), 2)), md, return_state=True)
    buf = _x((B, md.d_conv - 1, md.d_inner), 3)
    jcache = jx.MLSTMCache(jst, jnp.asarray(buf))
    cache = xlstm.MLSTMCache(xlstm.MLSTMState(*(_t(a) for a in jst)), _t(buf))
    for step in range(3):
        x = _x((B, 1, D), 10 + step)
        jout, jcache = jx.mlstm_decode_step(jp, jnp.asarray(x), jcache, md)
        out, cache = xlstm.mlstm_decode_step(p, _t(x), cache, xlstm.mlstm_dims(D, NH))
        _close(out, jout)
        for got, want in zip(cache.state, jcache.state):
            _close(got, want)
        _close(cache.conv_buf, jcache.conv_buf)


def test_slstm_forward_and_decode_match_reference():
    sd = jx.slstm_dims(D, NH)
    jp = jx.slstm_init(jax.random.PRNGKey(4), sd)
    p = params_from_jax(jp, "cpu")
    x = _x((B, 24, D), 5)
    jout, jst = jx.slstm_forward(jp, jnp.asarray(x), sd, return_state=True)
    out, st = xlstm.slstm_forward(p, _t(x), xlstm.slstm_dims(D, NH), return_state=True)
    _close(out, jout)
    for got, want in zip(st, jst):
        _close(got, want)
    for step in range(3):
        x = _x((B, 1, D), 20 + step)
        jout, jst = jx.slstm_decode_step(jp, jnp.asarray(x), jst, sd)
        out, st = xlstm.slstm_decode_step(p, _t(x), st, xlstm.slstm_dims(D, NH))
        _close(out, jout)
        for got, want in zip(st, jst):
            _close(got, want)


def test_causal_depthwise_conv1d_matches_reference():
    w, b, x = _x((4, 1, 32), 6), _x((32,), 7), _x((B, 9, 32), 8)
    want = jlayers.causal_depthwise_conv1d({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                           jnp.asarray(x))
    got = layers.causal_depthwise_conv1d({"w": _t(w), "b": _t(b)}, _t(x))
    _close(got, want, atol=1e-6)


S, DECODE = 16, 4


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_prefill_and_greedy_decode_match_reference(param_dtype):
    jcfg, cfg = j_get_config("xlstm-1.3b", reduced=True), get_config("xlstm-1.3b", reduced=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.n_layers, cfg.d_model, cfg.n_layers // cfg.slstm_group) == (8, 256, 4)
    jcfg = dataclasses.replace(jcfg, param_dtype=param_dtype)
    cfg = dataclasses.replace(cfg, param_dtype=param_dtype)
    rel = BF16_REL if param_dtype == "bfloat16" else F32_REL
    japi, api = j_get_model_api(jcfg), get_model_api(cfg)
    jparams = japi.init_params(jax.random.PRNGKey(7), jcfg, UNSHARDED)
    params = params_from_jax(jparams, device="cpu")
    tokens = np.random.RandomState(11).randint(0, cfg.vocab, (B, S)).astype(np.int32)

    jlogits, jstate = japi.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, UNSHARDED)
    logits, state = api.prefill(params, {"tokens": _t(tokens).long()}, cfg)
    assert logits.shape == (B, 1, cfg.vocab) and logits.dtype == getattr(torch, param_dtype)
    _close_to_scale(logits, jlogits, rel)
    _assert_state_close(state, jstate, BF16_STATE_REL if param_dtype == "bfloat16" else rel)
    assert not state[1].conv_buf.any()
    # the first sLSTM layer sees the same inputs on both sides: its state
    # agrees to the last bits whatever the weights' dtype
    for got, want in zip(state[0], jstate[0]):
        _close_to_scale(got[0], want[0], 1e-5)

    jdecode = jax.jit(lambda p, b, s: japi.decode_step(p, b, s, jcfg, UNSHARDED))
    tok = jnp.argmax(jlogits[:, -1, :], -1).astype(jnp.int32)[:, None]
    assert torch.equal(logits[:, -1].argmax(-1), _t(tok[:, 0]).long())
    for _ in range(DECODE):
        jlogits, jstate = jdecode(jparams, {"tokens": tok}, jstate)
        logits, state = api.decode_step(params, {"tokens": _t(tok).long()}, state, cfg)
        _close_to_scale(logits, jlogits, rel)
        tok = jnp.argmax(jlogits[:, -1, :], -1).astype(jnp.int32)[:, None]
        assert torch.equal(logits[:, -1].argmax(-1), _t(tok[:, 0]).long())
    _assert_state_close(state, jstate, BF16_STATE_REL if param_dtype == "bfloat16" else rel)


def _assert_state_close(state, jstate, rel):
    (sst, mst), (jsst, jmst) = state, jstate
    for got, want in zip(list(sst) + list(mst.state) + [mst.conv_buf],
                         list(jsst) + list(jmst.state) + [jmst.conv_buf]):
        assert tuple(got.shape) == want.shape, (tuple(got.shape), want.shape)
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        if np.abs(np.asarray(jnp.asarray(want).astype(jnp.float32))).max() > 0:
            _close_to_scale(got, want, rel)


def test_init_decode_state_matches_reference():
    jcfg, cfg = j_get_config("xlstm-1.3b", reduced=True), get_config("xlstm-1.3b", reduced=True)
    jstate = j_get_model_api(jcfg).init_decode_state(jcfg, 2, 16, UNSHARDED)
    state = get_model_api(cfg).init_decode_state(cfg, 2, 16, device="cpu")
    for got, want in zip(jax.tree.leaves(state), jax.tree.leaves(jstate)):
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_param_count_and_init_match_reference():
    assert param_count(get_config("xlstm-1.3b")) == j_param_count(j_get_config("xlstm-1.3b"))
    cfg = get_config("xlstm-1.3b", reduced=True)
    jcfg = j_get_config("xlstm-1.3b", reduced=True)
    params = get_model_api(cfg).init_params(torch.Generator().manual_seed(0), cfg)
    jshapes = jax.eval_shape(lambda: j_get_model_api(jcfg).init_params(
        jax.random.PRNGKey(0), jcfg, UNSHARDED))
    got = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype).split(".")[-1])
           for k, v in jax.tree_util.tree_leaves_with_path(params)}
    want = {jax.tree_util.keystr(k): (v.shape, str(v.dtype))
            for k, v in jax.tree_util.tree_leaves_with_path(jshapes)}
    assert got == want
    assert sum(v.numel() for v in jax.tree.leaves(params)) == param_count(cfg)


def test_serve_cpu_runs_xlstm():
    res = serve("xlstm-1.3b", reduced=True, batch=2, prompt_len=16, tokens=3, seed=1,
                device="cpu")
    assert res.ids.shape == (2, 4) and res.last_logits.shape == (2, 512)
    assert res.flash_launches == res.slstm_launches == 0
    assert torch.isfinite(res.last_logits).all()
