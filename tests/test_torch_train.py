"""Port parity for the training path: loss, gradients, Adam and the epoch.

The same flax parameters (the JAX package's ``init_params`` through the
bridge) and the same seeded batch go through ``jax.value_and_grad`` of the
JAX loss and through the port's module with ``train=False``, for each
family (IMDB at ``maxlen=32``): the loss and every parameter's gradient
agree within rtol 2e-4 / atol 2e-5 (the JAX package's own bound between
its IMDB attention cores; the convnets sum in other orders too). Five Adam
updates from the same gradients agree with optax's ``adam_like_keras``
within 1e-6. The epoch's keras-fit semantics (held-out tail, ragged final
batch) are held against the JAX package's plan and masked loss. Training
itself is RNG-driven and is held here on the port alone: accuracy on a
separable set, determinism per seed, and the ensemble against single runs.
The JAX package's training loops are not run (XLA:CPU compile and scan
take tens of seconds a call).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from simple_tip_tpu.models import Cifar10ConvNet as FlaxCifar10ConvNet
from simple_tip_tpu.models import ImdbTransformer as FlaxImdbTransformer
from simple_tip_tpu.models import MnistConvNet as FlaxMnistConvNet
from simple_tip_tpu.models import train as jax_train
from simple_tip_tpu_torch.bridge import params_from_jax, params_to_jax
from simple_tip_tpu_torch.data import synthetic
from simple_tip_tpu_torch.models import Cifar10ConvNet, ImdbTransformer, MnistConvNet
from simple_tip_tpu_torch.models import train
from simple_tip_tpu_torch.parallel.ensemble import stack_params, train_ensemble, unstack
from test_torch_cifar import cifar_flax_params
from test_torch_model import flax_params
from test_torch_transformer import imdb_flax_params
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

MAXLEN = 32


def _imdb_params(seed: int):
    params = imdb_flax_params(seed)
    emb = params["TokenAndPositionEmbedding_0"]["Embed_1"]
    emb["embedding"] = emb["embedding"][:MAXLEN]
    return params


def _images(n, shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, size=(n, *shape)).astype(np.float32)


# family: (flax model, port model, params, batch of inputs, classes)
FAMILIES = {
    "mnist": (FlaxMnistConvNet(), MnistConvNet(), lambda: flax_params(5),
              lambda: _images(9, (28, 28, 1), 5), 10),
    "cifar10": (FlaxCifar10ConvNet(), Cifar10ConvNet(), lambda: cifar_flax_params(5),
                lambda: _images(7, (32, 32, 3), 5), 10),
    "imdb": (FlaxImdbTransformer(maxlen=MAXLEN), ImdbTransformer(maxlen=MAXLEN),
             lambda: _imdb_params(5),
             lambda: np.random.default_rng(5).integers(0, 2000, size=(8, MAXLEN)).astype(np.int32),
             2),
}


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _port_loss_and_grads(net, params, x, y):
    net.load_state_dict(params_from_jax(params)["module"])
    xs = torch.as_tensor(x, dtype=torch.int64) if x.dtype.kind == "i" else torch.from_numpy(x)
    probs, _ = net(xs)
    loss = train.categorical_crossentropy(probs, torch.from_numpy(y)).mean()
    named = dict(net.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    return float(loss.detach()), params_to_jax(net.family, dict(zip(named, grads)))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_one_step_loss_and_gradients_match_jax(family):
    flax_model, net, make_params, make_x, classes = FAMILIES[family]
    params, x = make_params(), make_x()
    y = np.eye(classes, dtype=np.float32)[np.random.default_rng(1).integers(0, classes, len(x))]

    def loss_fn(p):
        probs, _ = flax_model.apply({"params": p}, jnp.asarray(x), train=False)
        return jnp.mean(jax_train.categorical_crossentropy(probs, jnp.asarray(y)))

    want_loss, want = jax.value_and_grad(loss_fn)(params)
    loss, got = _port_loss_and_grads(net, params, x, y)
    np.testing.assert_allclose(loss, float(want_loss), rtol=2e-4, atol=2e-5)
    got_leaves, want_leaves = _leaves(got), _leaves(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g, np.asarray(w), rtol=2e-4, atol=2e-5,
                                   err_msg=jax.tree_util.keystr(path))
    if family == "imdb":
        attn = got["TransformerBlock_0"]["MultiHeadDotProductAttention_0"]
        assert all(np.abs(attn[n]["kernel"]).max() > 0 for n in ("query", "key", "value"))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_five_adam_updates_match_optax(family):
    _, net, make_params, _, _ = FAMILIES[family]
    params = make_params()
    rng = np.random.default_rng(2)
    grads = [jax.tree_util.tree_map(
        lambda a: rng.normal(0, 0.1, a.shape).astype(np.float32), params) for _ in range(5)]
    tx = jax_train.adam_like_keras(1e-3)
    update = jax.jit(tx.update)
    want, state = params, tx.init(params)
    for g in grads:
        updates, state = update(g, state, want)
        want = optax.apply_updates(want, updates)
    net.load_state_dict(params_from_jax(params)["module"])
    opt = train.adam_like_keras(net.parameters(), 1e-3)
    named = dict(net.named_parameters())
    for g in grads:
        for name, grad in params_from_jax(g)["module"].items():
            named[name].grad = grad.clone()
        opt.step()
    got = params_to_jax(net.family, net)
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


def test_categorical_crossentropy_matches_jax_with_clipping():
    probs = np.array([[0.7, 0.3, 0.0], [1e-9, 0.5, 0.5], [0.2, 0.2, 0.6]], np.float32)
    y = np.eye(3, dtype=np.float32)[[0, 0, 2]]
    want = np.asarray(jax_train.categorical_crossentropy(jnp.asarray(probs), jnp.asarray(y)))
    got = train.categorical_crossentropy(torch.from_numpy(probs), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[1] == pytest.approx(-np.log(np.float32(1e-7)), rel=1e-6)


@pytest.mark.parametrize("n,split,batch", [(100, 0.1, 32), (61, 0.25, 8), (10, 0.0, 4)])
def test_epoch_plan_and_held_out_tail_match_jax(n, split, batch):
    n_train = train.training_rows(n, split)
    assert n_train == n - int(n * split)
    assert train._epoch_plan(n_train, batch) == jax_train._epoch_plan(n_train, batch)[0]


def test_ragged_final_batch_is_the_masked_mean():
    rng = np.random.default_rng(4)
    probs = rng.dirichlet(np.ones(10), size=32).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 32)]
    mask = (np.arange(32) < 13).astype(np.float32)  # a final batch of 13 real rows
    losses = jax_train.categorical_crossentropy(jnp.asarray(probs), jnp.asarray(y))
    want = float(jnp.sum(losses * mask) / jnp.maximum(jnp.sum(mask), 1.0))
    got = train.categorical_crossentropy(torch.from_numpy(probs[:13]), torch.from_numpy(y[:13]))
    np.testing.assert_allclose(float(got.mean()), want, rtol=1e-6)


def _separable(seed: int):
    (x, y), (x_test, y_test) = synthetic.image_classification(
        seed=seed, n_train=330, n_test=100, shape=(28, 28, 1))
    return x, np.eye(10, dtype=np.float32)[y], x_test, y_test


CFG = train.TrainConfig(batch_size=32, epochs=3, learning_rate=2e-3, validation_split=0.1)


@pytest.mark.parametrize("seed", [0, 1])
def test_train_model_learns_a_separable_set(seed):
    x, y, x_test, y_test = _separable(7)
    history = []
    params = train.train_model(MnistConvNet(), x, y, CFG, seed, device="cpu", history=history)
    assert [h["steps"] for h in history] == [10, 10, 10]  # 297 rows: a ragged batch of 9
    assert history[-1]["mean_loss"] < history[0]["first_loss"]
    acc = train.evaluate_accuracy(MnistConvNet(), params, x_test, y_test, device="cpu")
    assert acc >= 0.6, acc


def test_training_is_deterministic_per_seed_and_the_ensemble_equals_single_runs():
    x, y, _, _ = _separable(8)
    cfg = train.TrainConfig(batch_size=64, epochs=1, learning_rate=1e-3, validation_split=0.1)
    runs = {s: train.train_model(MnistConvNet(), x, y, cfg, s, device="cpu") for s in (3, 4)}
    again = train.train_model(MnistConvNet(), x, y, cfg, 3, device="cpu")
    stacked = train_ensemble(MnistConvNet(), x, y, cfg, seeds=[3, 4], device="cpu")
    assert stacked["Conv_0"]["kernel"].shape == (2, 3, 3, 1, 32)
    for (_, a), (_, b) in zip(_leaves(runs[3]), _leaves(again)):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(runs[3]["Dense_0"]["kernel"], runs[4]["Dense_0"]["kernel"])
    for i, seed in enumerate((3, 4)):
        for (_, a), (_, b) in zip(_leaves(unstack(stacked, i)), _leaves(runs[seed])):
            np.testing.assert_array_equal(a, b)
    restacked = stack_params([unstack(stacked, 0), unstack(stacked, 1)])
    for (_, a), (_, b) in zip(_leaves(restacked), _leaves(stacked)):
        np.testing.assert_array_equal(a, b)
