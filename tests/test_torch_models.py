"""Parity of the port's FL models with the reference: the image CNN, the
HAR 1-D CNN and the char-LSTM.

The reference's params (`model.init(PRNGKey)`) cross to the port leaf
for leaf (`params_from_jax`: HWIO conv weights, fc1 rows in NHWC-flatten
order, 1-D conv weights transposed to the port's (c_out, c_in, k)); the
port's logits, per-sample losses, loss, accuracy and grads must then
match within atol 1e-5 (two frameworks, two summation orders in the
convolutions and matmuls). The HAR CNN and the char-LSTM, at small and
paper widths, within rtol 1e-5 of each tensor's scale (max |reference|):
their grads run to 1e-3, where a plain atol would say nothing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro.models.fl_models import make_fl_model as j_make_model
from repro_torch.models.fl_models import (make_fl_model, params_from_jax,
                                          params_to_jax)

ATOL = 1e-5


def _batch(task, B, seed):
    rng = np.random.RandomState(seed)
    if task == "lstm@shakespeare":    # (B, T) char ids; y unused
        return (rng.randint(0, 64, (B, 80)).astype(np.int32),
                np.zeros(B, np.int32))
    shape = {"cnn@mnist": (28, 28, 1), "cnn@cifar10": (32, 32, 3),
             "cnn@har": (128, 9)}[task]
    return (rng.standard_normal((B,) + shape).astype(np.float32),
            rng.randint(0, 6 if task == "cnn@har" else 10, B).astype(np.int32))


def _torch_batch(x, y):
    tx = torch.from_numpy(x)
    return {"x": tx.long() if x.dtype.kind == "i" else tx,
            "y": torch.from_numpy(y).long()}


def _close_to_scale(got, want, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()), err_msg=err_msg)


def _port_shape(shape):
    """A reference leaf's shape in the port: 1-D conv weights transposed."""
    return shape[::-1] if len(shape) == 3 else shape


def _pair(task, small, seed=2):
    jmodel, model = j_make_model(task, small=small), make_fl_model(task, small=small)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    return jmodel, model, jparams, params_from_jax(jparams, device="cpu")


@pytest.mark.parametrize("task", ["cnn@mnist", "cnn@cifar10", "cnn@har",
                                  "lstm@shakespeare"])
@pytest.mark.parametrize("small", [True, False])
def test_layout_and_param_bits(task, small):
    jmodel, model, jparams, params = _pair(task, small)
    assert model.param_bits == jmodel.param_bits
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    names = tuple(".".join(k.key for k in path) for path, _ in flat)
    assert model.layout.names == names          # the reference's leaf order
    for (path, leaf), name in zip(flat, names):
        assert tuple(params[name].shape) == _port_shape(leaf.shape)
    back = params_to_jax(params)
    for (path, leaf) in flat:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    if not small:      # the paper-width models' sizes
        assert model.layout.size == {"cnn@mnist": 206_922, "cnn@cifar10": 268_650,
                                     "cnn@har": 36_998,
                                     "lstm@shakespeare": 92_736}[task]
    np.testing.assert_array_equal(
        model.layout.flatten(params).numpy(),
        np.concatenate([params[n].numpy().ravel() for n in names]))
    if task.startswith("cnn@") and task != "cnn@har":   # the reference layout
        np.testing.assert_array_equal(
            model.layout.flatten(params).numpy(),
            np.concatenate([np.asarray(leaf).ravel() for _, leaf in flat]))


@pytest.mark.parametrize("task", ["cnn@mnist", "cnn@cifar10"])
def test_forward_losses_and_accuracy(task):
    jmodel, model, jparams, params = _pair(task, small=True)
    x, y = _batch(task, 12, 0)
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    b = {"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()}
    np.testing.assert_allclose(model.apply(params, b["x"]).numpy(),
                               np.asarray(jmodel.apply(jparams, jb["x"])), atol=ATOL)
    np.testing.assert_allclose(model.per_sample_loss(params, b).numpy(),
                               np.asarray(jmodel.per_sample_loss(jparams, jb)), atol=ATOL)
    np.testing.assert_allclose(model.loss(params, b).item(),
                               float(jmodel.loss(jparams, jb)), atol=ATOL)
    assert model.accuracy(params, b).item() == float(jmodel.accuracy(jparams, jb))


@pytest.mark.parametrize("task", ["cnn@mnist", "cnn@cifar10"])
def test_grads(task):
    jmodel, model, jparams, params = _pair(task, small=True)
    x, y = _batch(task, 8, 1)
    jg = jax.grad(jmodel.loss)(jparams, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    g = grad(lambda p: model.loss(p, {"x": torch.from_numpy(x),
                                      "y": torch.from_numpy(y).long()}))(params)
    for layer, leaves in jg.items():
        for leaf, want in leaves.items():
            np.testing.assert_allclose(g[f"{layer}.{leaf}"].numpy(), np.asarray(want),
                                       atol=ATOL, err_msg=f"{layer}.{leaf}")


def test_vmapped_grads_over_client_params():
    """The round trains K clients at once: vmap(grad) over (K, ...) leaves
    viewed out of one (K, P) buffer equals K separate reference grads."""
    jmodel, model, jparams, params = _pair("cnn@mnist", small=True)
    K = 3
    flat = model.layout.flatten(params)
    stack = flat.expand(K, -1).clone() + 0.01 * torch.arange(K)[:, None]
    xs, ys = zip(*(_batch("cnn@mnist", 4, 10 + k) for k in range(K)))
    g = vmap(grad(lambda p, x, y: model.loss(p, {"x": x, "y": y})))(
        model.layout.views(stack), torch.from_numpy(np.stack(xs)),
        torch.from_numpy(np.stack(ys)).long())
    for k in range(K):
        jp = jax.tree.map(lambda a: a + 0.01 * k, jparams)
        jg = jax.grad(jmodel.loss)(jp, {"x": jnp.asarray(xs[k]), "y": jnp.asarray(ys[k])})
        for layer, leaves in jg.items():
            for leaf, want in leaves.items():
                np.testing.assert_allclose(g[f"{layer}.{leaf}"][k].numpy(),
                                           np.asarray(want), atol=ATOL)


def test_port_init_shapes_and_scale():
    model = make_fl_model("cnn@mnist", small=False)
    params = model.init(torch.Generator().manual_seed(0))
    assert set(params) == set(model.layout.names)
    for name, shape in zip(model.layout.names, model.layout.shapes):
        assert tuple(params[name].shape) == shape
        if name.endswith(".b"):
            assert not params[name].any()
    w = params["fc1.w"]          # fan-in-scaled normal: std 1/sqrt(1568)
    assert abs(w.std().item() * np.sqrt(w.shape[0]) - 1.0) < 0.02
    with pytest.raises(ValueError):
        make_fl_model("cnn@svhn")


NEW_TASKS = ["cnn@har", "lstm@shakespeare"]


@pytest.mark.parametrize("task", NEW_TASKS)
@pytest.mark.parametrize("small", [True, False])
def test_new_task_forward_losses_and_accuracy(task, small):
    jmodel, model, jparams, params = _pair(task, small=small)
    x, y = _batch(task, 12, 0)
    jb, b = {"x": jnp.asarray(x), "y": jnp.asarray(y)}, _torch_batch(x, y)
    _close_to_scale(model.apply(params, b["x"]).numpy(),
                    jmodel.apply(jparams, jb["x"]))
    _close_to_scale(model.per_sample_loss(params, b).numpy(),
                    jmodel.per_sample_loss(jparams, jb))
    assert model.per_sample_loss(params, b).shape == (12,)
    _close_to_scale(model.loss(params, b).item(), jmodel.loss(jparams, jb))
    assert model.accuracy(params, b).item() == pytest.approx(
        float(jmodel.accuracy(jparams, jb)), abs=1e-7)


@pytest.mark.parametrize("task", NEW_TASKS)
@pytest.mark.parametrize("small", [True, False])
def test_new_task_grads(task, small):
    jmodel, model, jparams, params = _pair(task, small=small)
    x, y = _batch(task, 8, 1)
    jg = jax.grad(jmodel.loss)(jparams, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    g = params_to_jax(grad(lambda p: model.loss(p, _torch_batch(x, y)))(params))
    for layer, leaves in jg.items():
        for leaf, want in leaves.items():
            _close_to_scale(g[layer][leaf], want, err_msg=f"{layer}.{leaf}")


@pytest.mark.parametrize("task", NEW_TASKS)
def test_new_task_vmapped_grads_over_client_params(task):
    """The round's vmap(grad) over K client models, with the LSTM's loop
    over T and the 1-D convolutions inside."""
    jmodel, model, jparams, params = _pair(task, small=True)
    K = 3
    flat = model.layout.flatten(params)
    stack = flat.expand(K, -1).clone() + 0.01 * torch.arange(K)[:, None]
    xs, ys = zip(*(_batch(task, 4, 10 + k) for k in range(K)))
    bt = _torch_batch(np.stack(xs), np.stack(ys))
    g = vmap(grad(lambda p, x, y: model.loss(p, {"x": x, "y": y})))(
        model.layout.views(stack), bt["x"], bt["y"])
    for k in range(K):
        jp = jax.tree.map(lambda a: a + 0.01 * k, jparams)
        jg = jax.grad(jmodel.loss)(jp, {"x": jnp.asarray(xs[k]), "y": jnp.asarray(ys[k])})
        gk = params_to_jax({n: v[k] for n, v in g.items()})
        for layer, leaves in jg.items():
            for leaf, want in leaves.items():
                _close_to_scale(gk[layer][leaf], want, err_msg=f"{k} {layer}.{leaf}")


def test_char_lstm_matches_the_reference_cell_state():
    """The LSTM layer alone: hidden states and final (h, c) from zero
    states, against `repro.nn.recurrent.lstm_forward` (gate order i, f,
    g, o; the forget gate's +1; one bias)."""
    from repro.nn import recurrent as jrec
    from repro_torch.nn import recurrent
    rng = np.random.RandomState(3)
    d_in, dh, B, T = 5, 7, 3, 11
    p = {"w": rng.standard_normal((d_in, 4 * dh)), "r": rng.standard_normal((dh, 4 * dh)),
         "b": rng.standard_normal(4 * dh)}
    p = {k: (0.5 * v).astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((B, T, d_in)).astype(np.float32)
    jhs, jst = jrec.lstm_forward({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    hs, (h, c) = recurrent.lstm_forward({k: torch.from_numpy(v) for k, v in p.items()},
                                        torch.from_numpy(x))
    for got, want in ((hs, jhs), (h, jst.h), (c, jst.c)):
        _close_to_scale(got.numpy(), want)
