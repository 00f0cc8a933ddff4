"""Parity of the port's FL CNN with the reference.

The reference's params (`model.init(PRNGKey)`) cross to the port leaf
for leaf (`params_from_jax`: HWIO conv weights, fc1 rows in NHWC-flatten
order); the port's logits, per-sample losses, loss, accuracy and grads
must then match within atol 1e-5 (two frameworks, two summation orders
in the convolutions and matmuls).
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
    shape = (28, 28, 1) if task == "cnn@mnist" else (32, 32, 3)
    return (rng.standard_normal((B,) + shape).astype(np.float32),
            rng.randint(0, 10, B).astype(np.int32))


def _pair(task, small, seed=2):
    jmodel, model = j_make_model(task, small=small), make_fl_model(task, small=small)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    return jmodel, model, jparams, params_from_jax(jparams, device="cpu")


@pytest.mark.parametrize("task", ["cnn@mnist", "cnn@cifar10"])
@pytest.mark.parametrize("small", [True, False])
def test_layout_and_param_bits(task, small):
    jmodel, model, jparams, params = _pair(task, small)
    assert model.param_bits == jmodel.param_bits
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    names = tuple(".".join(k.key for k in path) for path, _ in flat)
    assert model.layout.names == names          # the reference's leaf order
    for (path, leaf), name in zip(flat, names):
        assert tuple(params[name].shape) == leaf.shape
    back = params_to_jax(params)
    for (path, leaf) in flat:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    if task == "cnn@mnist" and not small:      # the main path's model
        assert model.layout.size == 206_922
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
    with pytest.raises(NotImplementedError):
        make_fl_model("lstm@shakespeare")
