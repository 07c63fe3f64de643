"""Port parity for the CIFAR-10 convnet, its bridge and kernel B3.

The same seeded numpy inputs and the same flax parameters (the JAX
package's ``init_params``, biases drawn non-zero so their layout is
exercised) go through the JAX package and the port on the CPU:

- ``Cifar10ConvNet`` probabilities and taps 0-7 (NHWC) against flax, atol
  1e-5;
- ``fused_cifar10_probs_plain`` (what the wrapper runs for CPU tensors)
  against the Pallas kernel in interpret mode at float32
  (``fused_cifar10_probs(..., compute_dtype=jnp.float32, interpret=True)``)
  and against flax, atol 1e-5.

The CUDA kernel itself is held against the plain version on the card in
``test_torch_kernels_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_tip_tpu.models import Cifar10ConvNet as FlaxCifar10ConvNet
from simple_tip_tpu.models import ImdbTransformer as FlaxImdbTransformer
from simple_tip_tpu.models import MnistConvNet as FlaxMnistConvNet
from simple_tip_tpu.models.train import init_params
from simple_tip_tpu.ops.fused_forward import fused_cifar10_probs as pallas_fused_cifar10_probs
from simple_tip_tpu_torch.bridge import family_of, glorot_params, params_from_jax
from simple_tip_tpu_torch.engine.model_handler import BaseModel
from simple_tip_tpu_torch.models import Cifar10ConvNet
from simple_tip_tpu_torch.models import predict as predict_module
from simple_tip_tpu_torch.ops import fused_forward
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def cifar_flax_params(seed: int = 0):
    """Flax ``Cifar10ConvNet`` params as numpy, with non-zero biases."""
    x0 = jnp.zeros((1, 32, 32, 3), jnp.float32)
    params = jax.tree_util.tree_map(
        np.asarray, init_params(FlaxCifar10ConvNet(), jax.random.PRNGKey(seed), x0)
    )
    rng = np.random.default_rng(seed)
    for name in params:
        width = params[name]["bias"].shape[0]
        params[name]["bias"] = rng.uniform(-0.05, 0.05, width).astype(np.float32)
    return params


def cifar_inputs(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, size=(n, 32, 32, 3)).astype(np.float32)


def port_net(params) -> Cifar10ConvNet:
    net = Cifar10ConvNet().eval()
    net.load_state_dict(params_from_jax(params)["module"])
    return net


@pytest.mark.parametrize("seed", [0, 1])
def test_probs_and_taps_match_flax(seed):
    params = cifar_flax_params(seed)
    x = cifar_inputs(6, seed)
    want_probs, want_taps = FlaxCifar10ConvNet().apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        probs, taps = port_net(params)(torch.from_numpy(x))
    np.testing.assert_allclose(probs.numpy(), np.asarray(want_probs), atol=1e-5, rtol=0)
    assert sorted(taps) == list(range(8))
    for i in range(8):
        assert tuple(taps[i].shape) == want_taps[i].shape, i
        np.testing.assert_allclose(
            taps[i].numpy(), np.asarray(want_taps[i]), atol=1e-5, rtol=0, err_msg=f"tap {i}"
        )


def test_fused_plain_matches_pallas_interpret_and_flax():
    params = cifar_flax_params(2)
    x = cifar_inputs(6, 2)
    fused = params_from_jax(params)["fused"]
    before = fused_forward.CIFAR_LAUNCHES
    got = fused_forward.fused_cifar10_probs(fused, torch.from_numpy(x)).numpy()
    assert fused_forward.CIFAR_LAUNCHES == before, "a CPU tensor must not launch the kernel"
    pallas = pallas_fused_cifar10_probs(
        params, jnp.asarray(x), compute_dtype=jnp.float32, tile=4, interpret=True
    )
    flax_probs, _ = FlaxCifar10ConvNet().apply({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, np.asarray(flax_probs), atol=1e-5, rtol=0)


def test_bridge_layouts():
    params = cifar_flax_params()
    bridged = params_from_jax(params)
    module, fused = bridged["module"], bridged["fused"]
    w3 = params["Conv_2"]["kernel"]
    # OIHW for the module, im2col rows in (dy, dx, c) order for the kernel
    assert module["conv3.weight"][5, 7, 1, 2].item() == w3[1, 2, 7, 5]
    assert fused["w3"][(1 * 3 + 2) * 64 + 7, 5].item() == w3[1, 2, 7, 5]
    assert tuple(fused["w1"].shape) == (27, 32)
    np.testing.assert_array_equal(fused["wd1"].numpy(), params["Dense_0"]["kernel"])
    np.testing.assert_array_equal(module["dense2.weight"].numpy(), params["Dense_1"]["kernel"].T)
    with pytest.raises(ValueError):
        params_from_jax({**params, "Conv_2": {"kernel": np.zeros((3, 3, 32, 64)), "bias": np.zeros(64)}})


def test_predict_goes_through_the_cifar_wrapper(monkeypatch):
    params = cifar_flax_params(1)
    x = cifar_inputs(7, 1)
    monkeypatch.setattr(predict_module, "PREDICT_BATCH", 3)
    calls = []
    real = fused_forward.fused_cifar10_probs

    def spy(fused, xb):
        calls.append(xb.shape[0])
        return real(fused, xb)

    monkeypatch.setitem(predict_module._FUSED_FORWARD, Cifar10ConvNet, spy)
    got = predict_module.predict(
        port_net(params), params_from_jax(params)["fused"], x, torch.device("cpu")
    )
    want, _ = FlaxCifar10ConvNet().apply({"params": params}, jnp.asarray(x))
    assert calls == [3, 3, 1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_model_without_dropout_writes_no_vr():
    model = BaseModel(Cifar10ConvNet(), params_from_jax(cifar_flax_params(0)), device="cpu")
    pred, unc, times = model.get_pred_and_uncertainty(cifar_inputs(5, 3), seed=0)
    assert set(unc) == set(times) == {"softmax", "pcs", "softmax_entropy", "deep_gini"}
    assert pred.shape == (5,)


@pytest.mark.parametrize(
    "family,flax_model,example",
    [
        ("mnist", FlaxMnistConvNet(), np.zeros((1, 28, 28, 1), np.float32)),
        ("cifar10", FlaxCifar10ConvNet(), np.zeros((1, 32, 32, 3), np.float32)),
        ("imdb", FlaxImdbTransformer(), np.zeros((1, 100), np.int32)),
    ],
)
def test_glorot_params_have_the_flax_layout(family, flax_model, example):
    ours = glorot_params(5, family)
    theirs = init_params(flax_model, jax.random.PRNGKey(0), example)
    assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(theirs)
    for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
        assert a.shape == b.shape and a.dtype == np.float32
    assert family_of(ours) == family
    np.testing.assert_array_equal(
        jax.tree_util.tree_leaves(glorot_params(5, family))[0], jax.tree_util.tree_leaves(ours)[0]
    )
    with pytest.raises(ValueError):
        glorot_params(5, "svhn")
