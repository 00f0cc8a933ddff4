"""Parity of the port's dense-LLM serving path with the reference, on the
CPU.

Reduced configs (2 layers, d_model 256) of `llama3.2-3b` (GQA),
`gemma2-27b` (alternating windows, attention and final softcaps,
post-norms, `embed_scale`), `granite-34b` (MQA) and `llava-next-34b`
(vlm: image embeddings before the text) run through the reference's
`get_model_api` and through the port's, with the reference's weights
carried across by `params_from_jax`; with f32 weights (what `reduced()`
gives) and with bf16 weights (what the full configs serve). Held equal
with f32 weights:
- the prefill's last logits within 1e-5 of their scale (max |logit|;
  measured ≤ 1.7e-6): two frameworks sum the f32 matmuls in other orders;
- its bf16 caches within rtol 2**-7: k and v are computed in f32 on both
  sides and rounded once, so a value that lies on a rounding boundary
  may land one bf16 step apart;
- the caches' positions and length, exactly;
- four greedy decode steps: argmax ids, ring positions and length
  exactly, through the ring's wrap (the first decode after a prefill of
  S tokens writes slot 0); logits within 2e-4 of their scale (measured
  ≤ 4.1e-5) and the caches within rtol 2**-7, atol 1e-3, because decode
  reads the bf16 caches, so a one-step difference in a cached k or v
  moves the next layer's activations by about 1e-4.
With bf16 weights every matmul, norm and activation rounds to bf16 on
both sides, and a value one bf16 step apart (2**-8 relative) travels
through the layers: logits within 3e-2 of their scale (measured ≤ 1.4e-2,
gemma2, whose softcaps and post-norms add roundings), caches within 2e-2
of their scale (measured ≤ 8.5e-3); argmax ids, positions and lengths
exactly.
Also the port's `rmsnorm`, `rope` and `attend` against the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import get_model_api as j_get_model_api
from repro.nn import attention as jattn
from repro.nn import layers as jlayers
from repro.nn.sharding import UNSHARDED
from repro_torch.configs import get_config, param_count
from repro_torch.launch.serve import serve
from repro_torch.models.api import get_model_api
from repro_torch.models.lm import params_from_jax
from repro_torch.nn import attention as attn
from repro_torch.nn import layers

PREFILL_REL, DECODE_REL = 1e-5, 2e-4
DECODE_CACHE_ATOL = 1e-3
BF16_LOGIT_REL, BF16_CACHE_REL = 3e-2, 2e-2   # bf16 weights
F32_ATOL = 1e-5
BF16_RTOL = 2.0 ** -7
B, S, DECODE = 2, 12, 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_close_to_scale(got, want, rel):
    """max |got − want| ≤ rel · max |want|: the error relative to the
    values' scale (an elementwise rtol fails on values near zero)."""
    got, want = _np(got), _np(want)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, (err, scale)


def _assert_cache_close(got, want, *, bf16_weights, decoded):
    if bf16_weights:
        _assert_close_to_scale(got, want, BF16_CACHE_REL)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_RTOL,
                                   atol=DECODE_CACHE_ATOL if decoded else 1e-6)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x.astype(jnp.float32) if hasattr(x, "astype") else x)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "gemma2-27b", "granite-34b",
                                  "llava-next-34b"])
def test_prefill_and_greedy_decode_match_reference(arch, param_dtype):
    jcfg, cfg = j_get_config(arch, reduced=True), get_config(arch, reduced=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jcfg = dataclasses.replace(jcfg, param_dtype=param_dtype)
    cfg = dataclasses.replace(cfg, param_dtype=param_dtype)
    bf16 = param_dtype == "bfloat16"
    prefill_rel, decode_rel = (BF16_LOGIT_REL,) * 2 if bf16 else (PREFILL_REL, DECODE_REL)
    japi, api = j_get_model_api(jcfg), get_model_api(cfg)
    jparams = japi.init_params(jax.random.PRNGKey(7), jcfg, UNSHARDED)
    params = params_from_jax(jparams, device="cpu")
    rng = np.random.RandomState(11)
    tokens = rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)
    jbatch, batch = {"tokens": jnp.asarray(tokens)}, {"tokens": _t(tokens).long()}
    if cfg.family == "vlm":
        img = rng.standard_normal((B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
        jbatch["image_embeds"], batch["image_embeds"] = jnp.asarray(img), _t(img)
    S_all = S + cfg.n_img_tokens

    jlogits, jstate = japi.prefill(jparams, jbatch, jcfg, UNSHARDED)
    logits, state = api.prefill(params, batch, cfg)
    assert logits.shape == (B, 1, cfg.vocab)
    assert logits.dtype == getattr(torch, param_dtype) and str(jlogits.dtype) == param_dtype
    _assert_close_to_scale(logits, jlogits, prefill_rel)
    # the reference emits bf16 caches of exactly S slots, even for f32 weights
    assert state.k.dtype == state.v.dtype == torch.bfloat16
    assert tuple(state.k.shape) == jstate.k.shape == (
        cfg.n_layers, B, S_all, cfg.n_kv, cfg.hd)
    _assert_cache_close(state.k, jstate.k, bf16_weights=bf16, decoded=False)
    _assert_cache_close(state.v, jstate.v, bf16_weights=bf16, decoded=False)
    np.testing.assert_array_equal(state.pos.numpy(), np.asarray(jstate.pos))
    assert state.length == int(jstate.length) == S_all

    jdecode = jax.jit(lambda p, b, s: japi.decode_step(p, b, s, jcfg, UNSHARDED))
    tok = jnp.argmax(jlogits[:, -1, :], -1).astype(jnp.int32)[:, None]
    assert torch.equal(logits[:, -1].argmax(-1), _t(tok[:, 0]).long())
    for step in range(DECODE):
        jlogits, jstate = jdecode(jparams, {"tokens": tok}, jstate)
        logits, state = api.decode_step(params, {"tokens": _t(tok).long()}, state, cfg)
        _assert_close_to_scale(logits, jlogits, decode_rel)
        tok = jnp.argmax(jlogits[:, -1, :], -1).astype(jnp.int32)[:, None]
        assert torch.equal(logits[:, -1].argmax(-1), _t(tok[:, 0]).long())
        np.testing.assert_array_equal(state.pos.numpy(), np.asarray(jstate.pos))
        assert state.length == int(jstate.length) == S_all + step + 1
        _assert_cache_close(state.k, jstate.k, bf16_weights=bf16, decoded=True)
    # the ring wrapped: slots 0..DECODE-1 now hold positions S..S+DECODE-1
    assert state.pos[0, :DECODE].tolist() == list(range(S_all, S_all + DECODE))
    assert state.pos[0, DECODE:].tolist() == list(range(DECODE, S_all))


@pytest.mark.parametrize("arch", ["llama3.2-3b", "gemma2-27b"])
def test_init_decode_state_matches_reference(arch):
    jcfg, cfg = j_get_config(arch, reduced=True), get_config(arch, reduced=True)
    jstate = j_get_model_api(jcfg).init_decode_state(jcfg, 2, 16, UNSHARDED)
    state = get_model_api(cfg).init_decode_state(cfg, 2, 16, device="cpu")
    assert tuple(state.k.shape) == jstate.k.shape and state.length == int(jstate.length)
    np.testing.assert_array_equal(state.pos.numpy(), np.asarray(jstate.pos))
    assert state.k.dtype == torch.float32 and not state.k.any()


def test_serving_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_config("llama3.2-3b", reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model_api(cfg).init_decode_state(cfg, 2, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve("llama3.2-3b", reduced=True, batch=1, prompt_len=4, tokens=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({"w": np.zeros(2, np.float32)})


@pytest.mark.parametrize("arch", ["llama3.2-3b", "gemma2-27b", "granite-34b",
                                  "deepseek-7b", "llava-next-34b", "olmoe-1b-7b",
                                  "kimi-k2-1t-a32b"])
def test_param_count_matches_reference_and_init(arch):
    from repro.configs import param_count as j_param_count
    cfg = get_config(arch, reduced=True)
    assert param_count(get_config(arch)) == j_param_count(j_get_config(arch))
    params = get_model_api(cfg).init_params(torch.Generator().manual_seed(0), cfg)
    n = 0
    stack = [params]
    while stack:
        node = stack.pop()
        for v in node.values():
            if isinstance(v, dict):
                stack.append(v)
            else:
                n += v.numel()
    assert n == param_count(cfg)


@pytest.mark.parametrize("arch", ["whisper-base"])
def test_unported_families_raise_naming_the_roadmap(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model_api(get_config(arch, reduced=True))


def test_serve_cpu_runs_the_example_loop():
    res = serve("gemma2-27b", reduced=True, batch=2, prompt_len=10, tokens=3,
                seed=1, device="cpu")
    assert res.ids.shape == (2, 4) and res.last_logits.shape == (2, 512)
    assert res.flash_launches == 0 and torch.isfinite(res.last_logits).all()
    again = serve("gemma2-27b", reduced=True, batch=2, prompt_len=10, tokens=3,
                  seed=1, device="cpu")
    assert torch.equal(res.ids, again.ids)


@pytest.mark.parametrize("plus_one", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(plus_one, dtype):
    rng = np.random.RandomState(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    s = rng.standard_normal(64).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = jlayers.rmsnorm({"scale": jnp.asarray(s)}, jx, scale_plus_one=plus_one)
    got = layers.rmsnorm({"scale": _t(s)}, _t(x).to(getattr(torch, dtype)),
                         scale_plus_one=plus_one)
    assert got.dtype == getattr(torch, dtype)
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else dict(rtol=BF16_RTOL, atol=1e-6)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("positions", ["1d", "2d", "large"])
def test_rope_matches_reference(positions):
    rng = np.random.RandomState(2)
    x = rng.standard_normal((2, 6, 3, 64)).astype(np.float32)
    pos = {"1d": np.arange(6), "2d": rng.randint(0, 100, (2, 6)),
           "large": np.arange(6) + 2040}[positions].astype(np.int32)
    want = jattn.rope(jnp.asarray(x), jnp.asarray(pos), theta=500000.0)
    got = attn.rope(_t(x), _t(pos), theta=500000.0)
    # cos/sin of angles up to ~2e3 rad: f32 argument reduction may differ
    # in the last bit between XLA and PyTorch
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["valid_len", "ring", "rows"])
def test_attend_matches_reference(dtype, case):
    rng = np.random.RandomState(3)
    Sq = {"valid_len": 1, "ring": 1, "rows": 12}[case]
    Sk = 10 if case != "rows" else 12
    q = rng.standard_normal((2, Sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, Sk, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, Sk, 2, 16)).astype(np.float32)
    kw = {}
    if case == "valid_len":
        kw = dict(q_positions=np.array([6], np.int32),
                  k_positions=np.arange(Sk, dtype=np.int32), kv_valid_len=6)
    elif case == "ring":   # a wrapped ring with an unwritten slot
        kp = np.array([10, 11, 2, 3, 4, 5, 6, 7, 8, jattn.POS_SENTINEL], np.int32)
        kw = dict(q_positions=np.array([11], np.int32), k_positions=kp,
                  window=6, logit_softcap=50.0)
    else:
        kw = dict(window=4)   # 12 query rows, which the reference chunks
    jkw = {n: jnp.asarray(a) if isinstance(a, np.ndarray) else a for n, a in kw.items()}
    tkw = {n: _t(a) if isinstance(a, np.ndarray) else a for n, a in kw.items()}
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jattn.attend(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)), **jkw)
    got = attn.attend(*(_t(a).to(tdt) for a in (q, k, v)), **tkw)
    assert got.dtype == tdt and got.shape == q.shape
    tol = dict(rtol=0, atol=F32_ATOL) if dtype == "float32" else dict(rtol=2 * BF16_RTOL, atol=1e-6)
    np.testing.assert_allclose(_np(got), _np(want), **tol)

