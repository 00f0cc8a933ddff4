"""Parity of the port's hybrid (zamba2) serving path with the reference,
on the CPU.

Reduced zamba2-7b (d 256, one group of 2 Mamba2 layers of 16 heads of 32,
state 16, then the shared attention block with 4 heads of 64 and window
8) runs through the reference's `get_model_api` and through the port's,
with the reference's weights carried across by `params_from_jax`, with
f32 weights (what `reduced()` gives) and with bf16 weights (what the full
config serves), at prompt 40 (one partial SSD chunk) and 128 (two
chunks); the window of 8 makes the ring wrap. A third layer (a Mamba2
tail without attention, as zamba2-7b's 81 = 13 × 6 + 3 has) is covered
by a variant of the reduced config. Prefill, then 10 greedy decode steps:
- greedy ids equal at every step; cache positions and length exactly;
- f32 weights: logits, SSM states and the ring caches within 1e-4 of
  their scale (measured <= 5.2e-6: the frameworks sum in other orders);
  the hybrid cache is f32 here (the model's dtype; the dense family's
  prefill caches are always bf16);
- bf16 weights: every matmul, norm and activation rounds to bf16 on both
  sides, not always at the same places (XLA keeps f32 between some fused
  ops), so a value one bf16 step apart travels through the layers: logits
  within 3e-2 of their scale (measured <= 7.9e-3), SSM states and caches
  within 5e-2 (measured <= 1.5e-2);
- conv buffers exactly zero after prefill, as the reference hands decode.
Also `init_decode_state`, `param_count` full and reduced, the init tree's
leaf names, shapes and dtypes, `params_from_jax` leaf for leaf,
`zamba_loss` raising, `get_model_api`, the prompt-length rule, and a CPU
`serve` that repeats bitwise. `param_count` (the reference's analytic
count) exceeds the init tree by d_model a Mamba2 layer, on both sides.
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
from repro.nn.sharding import UNSHARDED
from repro_torch.configs import get_config, param_count
from repro_torch.launch.serve import serve
from repro_torch.models import lm
from repro_torch.models.api import get_model_api
from repro_torch.models.lm import params_from_jax

ARCH = "zamba2-7b"
F32_REL = 1e-4
BF16_REL, BF16_STATE_REL = 3e-2, 5e-2
B, DECODE = 2, 10


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the parallel test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_to_scale(got, want, rel):
    got, want = _np(got), _np(want)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, (err, scale)


def _cfgs(param_dtype="float32", n_layers=None):
    jcfg, cfg = j_get_config(ARCH, reduced=True), get_config(ARCH, reduced=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    kw = dict(param_dtype=param_dtype)
    if n_layers is not None:
        kw["n_layers"] = n_layers
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(cfg, **kw)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _check_state(state, jstate, rel, state_rel):
    for key in ("mamba_groups", "mamba_tail"):
        assert (key in state) == (key in jstate)
        if key in state:
            _close_to_scale(state[key].state, jstate[key].state, state_rel)
            assert state[key].state.dtype == torch.float32
            assert state[key].conv_buf.shape == jstate[key].conv_buf.shape
            _close_to_scale(state[key].conv_buf, jstate[key].conv_buf, rel)
    kv, jkv = state["attn"], jstate["attn"]
    assert tuple(kv.k.shape) == jkv.k.shape
    assert str(kv.k.dtype).removeprefix("torch.") == str(jkv.k.dtype)
    _close_to_scale(kv.k, jkv.k, state_rel)
    _close_to_scale(kv.v, jkv.v, state_rel)
    np.testing.assert_array_equal(kv.pos.numpy(), np.asarray(jkv.pos))
    assert kv.length == int(jkv.length)


@pytest.mark.parametrize("param_dtype,prompt,n_layers", [
    ("float32", 40, None), ("float32", 128, None),
    ("bfloat16", 40, None), ("bfloat16", 128, None),
    ("float32", 40, 3),   # one group of 2, then a Mamba2 tail layer
])
def test_prefill_and_greedy_decode_match_reference(param_dtype, prompt, n_layers):
    jcfg, cfg = _cfgs(param_dtype, n_layers)
    bf16 = param_dtype == "bfloat16"
    rel, state_rel = (BF16_REL, BF16_STATE_REL) if bf16 else (F32_REL, F32_REL)
    japi, api = j_get_model_api(jcfg), get_model_api(cfg)
    jparams = japi.init_params(jax.random.PRNGKey(7), jcfg, UNSHARDED)
    params = params_from_jax(jparams, device="cpu")
    tokens = np.random.RandomState(11).randint(0, cfg.vocab, (B, prompt)).astype(np.int32)

    jlogits, jstate = japi.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, UNSHARDED)
    logits, state = api.prefill(params, {"tokens": torch.from_numpy(tokens).long()}, cfg)
    assert logits.shape == (B, 1, cfg.vocab) and logits.dtype == getattr(torch, param_dtype)
    _close_to_scale(logits, jlogits, rel)
    _check_state(state, jstate, rel, state_rel)
    W = min(prompt + 1, cfg.window)
    assert state["attn"].k.shape[2] == W and state["attn"].length == prompt
    for key in ("mamba_groups", "mamba_tail"):
        if key in state:   # decode starts from zero conv buffers
            assert not state[key].conv_buf.any()
    assert ("mamba_tail" in state) == (n_layers == 3)

    jdecode = jax.jit(lambda p, b, s: japi.decode_step(p, b, s, jcfg, UNSHARDED))
    tok = jnp.argmax(jlogits[:, -1, :], -1).astype(jnp.int32)[:, None]
    assert torch.equal(logits[:, -1].argmax(-1), torch.from_numpy(np.array(tok[:, 0])).long())
    for step in range(DECODE):
        jlogits, jstate = jdecode(jparams, {"tokens": tok}, jstate)
        logits, state = api.decode_step(
            params, {"tokens": torch.from_numpy(np.array(tok)).long()}, state, cfg)
        _close_to_scale(logits, jlogits, rel)
        tok = jnp.argmax(jlogits[:, -1, :], -1).astype(jnp.int32)[:, None]
        assert torch.equal(logits[:, -1].argmax(-1),
                           torch.from_numpy(np.array(tok[:, 0])).long()), step
        _check_state(state, jstate, rel, state_rel)
    assert state["attn"].length == prompt + DECODE


def test_init_decode_state_matches_reference():
    jcfg, cfg = _cfgs("bfloat16", 3)
    jstate = j_get_model_api(jcfg).init_decode_state(jcfg, 2, 16, UNSHARDED)
    state = get_model_api(cfg).init_decode_state(cfg, 2, 16, device="cpu")
    assert sorted(state) == sorted(jstate)
    for key in ("mamba_groups", "mamba_tail"):
        for got, want in zip(state[key], jstate[key]):
            assert tuple(got.shape) == want.shape and not got.any()
            assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    kv, jkv = state["attn"], jstate["attn"]
    assert tuple(kv.k.shape) == jkv.k.shape == (1, 2, cfg.window, cfg.n_kv, cfg.hd)
    assert kv.k.dtype == torch.bfloat16 and not kv.k.any() and not kv.v.any()
    np.testing.assert_array_equal(kv.pos.numpy(), np.asarray(jkv.pos))
    assert kv.length == int(jkv.length) == 15


def test_layout_and_param_count_full_and_reduced():
    full = get_config(ARCH)
    assert lm._zamba_layout(full) == (13, 6, 3)
    assert lm._zamba_layout(get_config(ARCH, reduced=True)) == (1, 2, 0)
    assert full.hd == 112
    n = param_count(full)
    assert n == j_param_count(j_get_config(ARCH))
    assert round(n / 1e9, 2) == 6.64
    for n_layers in (None, 3):
        jcfg, cfg = _cfgs("float32", n_layers)
        assert param_count(cfg) == j_param_count(jcfg)
        params = get_model_api(cfg).init_params(torch.Generator().manual_seed(0), cfg)
        jparams = j_get_model_api(jcfg).init_params(jax.random.PRNGKey(0), jcfg, UNSHARDED)
        n_tree = sum(v.numel() for _, v in _leaves(params))
        assert n_tree == sum(v.size for _, v in _leaves(jparams))
        # the reference's analytic count holds one d_model a Mamba2 layer
        # more than its tree (and the port's) has
        assert param_count(cfg) - n_tree == cfg.n_layers * cfg.d_model


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_init_tree_matches_reference_and_crosses_leaf_for_leaf(param_dtype):
    jcfg, cfg = _cfgs(param_dtype, 3)
    jparams = j_get_model_api(jcfg).init_params(jax.random.PRNGKey(0), jcfg, UNSHARDED)
    params = get_model_api(cfg).init_params(torch.Generator().manual_seed(0), cfg)
    jl, tl = dict(_leaves(jparams)), dict(_leaves(params))
    assert sorted(jl) == sorted(tl)
    for k, v in jl.items():
        assert tuple(tl[k].shape) == v.shape, k
        assert str(tl[k].dtype).removeprefix("torch.") == str(v.dtype), k
    assert tl["mamba_groups_inner/core/A_log"].dtype == torch.float32
    carried = dict(_leaves(params_from_jax(jparams, device="cpu")))
    assert sorted(carried) == sorted(jl)
    for k, v in jl.items():
        assert str(carried[k].dtype).removeprefix("torch.") == str(v.dtype), k
        np.testing.assert_array_equal(_np(carried[k]), _np(v))


def test_api_is_the_hybrid_one_and_training_raises_naming_the_roadmap():
    cfg = get_config(ARCH, reduced=True)
    api = get_model_api(cfg)
    assert (api.prefill, api.decode_step) == (lm.zamba_prefill, lm.zamba_decode_step)
    with pytest.raises(NotImplementedError, match="ROADMAP A16"):
        api.loss_fn({}, {}, cfg)


@pytest.mark.parametrize("prompt", [65, 100])
def test_prompt_length_rule_raises_naming_the_chunk(prompt):
    with pytest.raises(ValueError, match="SSD chunk 64"):
        serve(ARCH, reduced=True, batch=1, prompt_len=prompt, tokens=1, device="cpu")


def test_serve_cpu_repeats_bitwise():
    kw = dict(reduced=True, batch=2, prompt_len=40, tokens=4, seed=1, device="cpu")
    res, again = serve(ARCH, **kw), serve(ARCH, **kw)
    assert res.ids.shape == (2, 5) and res.last_logits.shape == (2, 512)
    assert res.flash_launches == 0 and torch.isfinite(res.last_logits).all()
    assert torch.equal(res.ids, again.ids) and torch.equal(res.last_logits, again.last_logits)
