"""Port parity: the torch ``MnistConvNet`` and the weight bridge against flax.

The same seeded numpy inputs and the same flax parameters (the JAX
package's ``init_params``, biases drawn non-zero so their layout is
exercised) go through ``MnistConvNet.apply`` and through the port's module
on the CPU; probabilities and taps 0-6 (NHWC) agree to atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_tip_tpu.models import MnistConvNet as FlaxMnistConvNet
from simple_tip_tpu.models.train import init_params
from simple_tip_tpu_torch import device as port_device
from simple_tip_tpu_torch.bridge import glorot_params, params_from_jax
from simple_tip_tpu_torch.engine.model_handler import BaseModel
from simple_tip_tpu_torch.models import MnistConvNet
from simple_tip_tpu_torch.models.convnet import dropout
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def flax_params(seed: int = 0):
    """Flax ``MnistConvNet`` params as numpy, with non-zero biases."""
    x0 = jnp.zeros((1, 28, 28, 1), jnp.float32)
    params = jax.tree_util.tree_map(
        np.asarray, init_params(FlaxMnistConvNet(), jax.random.PRNGKey(seed), x0)
    )
    rng = np.random.default_rng(seed)
    for name, width in (("Conv_0", 32), ("Conv_1", 64), ("Dense_0", 10)):
        params[name]["bias"] = rng.uniform(-0.05, 0.05, width).astype(np.float32)
    return params


def port_net(params) -> MnistConvNet:
    net = MnistConvNet().eval()
    net.load_state_dict(params_from_jax(params)["module"])
    return net


@pytest.mark.parametrize("seed", [0, 1])
def test_probs_and_taps_match_flax(seed):
    params = flax_params(seed)
    x = np.random.default_rng(seed).uniform(0, 1, size=(12, 28, 28, 1)).astype(np.float32)
    want_probs, want_taps = FlaxMnistConvNet().apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        probs, taps = port_net(params)(torch.from_numpy(x))
    np.testing.assert_allclose(probs.numpy(), np.asarray(want_probs), atol=1e-5, rtol=0)
    assert sorted(taps) == list(range(7))
    for i in range(7):
        assert tuple(taps[i].shape) == want_taps[i].shape, i
        np.testing.assert_allclose(
            taps[i].numpy(), np.asarray(want_taps[i]), atol=1e-5, rtol=0, err_msg=f"tap {i}"
        )


def test_bridge_layouts():
    params = flax_params()
    bridged = params_from_jax(params)
    module, fused = bridged["module"], bridged["fused"]
    w2 = params["Conv_1"]["kernel"]
    # OIHW for the module
    np.testing.assert_array_equal(module["conv2.weight"][5, 7, 1, 2].item(), w2[1, 2, 7, 5])
    # im2col rows in (dy, dx, c) order for the kernel
    np.testing.assert_array_equal(fused["w2"][(1 * 3 + 2) * 32 + 7, 5].item(), w2[1, 2, 7, 5])
    np.testing.assert_array_equal(fused["wd"].numpy(), params["Dense_0"]["kernel"])
    np.testing.assert_array_equal(module["dense.weight"].numpy(), params["Dense_0"]["kernel"].T)
    with pytest.raises(ValueError):
        params_from_jax({**params, "Dense_0": {"kernel": np.zeros((10, 10)), "bias": np.zeros(10)}})


def test_glorot_params_shapes_and_limits():
    params = glorot_params(3)
    assert params["Conv_1"]["kernel"].shape == (3, 3, 32, 64)
    limit = np.sqrt(6.0 / (9 * 32 + 9 * 64))
    assert np.abs(params["Conv_1"]["kernel"]).max() <= limit
    np.testing.assert_array_equal(glorot_params(3)["Dense_0"]["kernel"], params["Dense_0"]["kernel"])


def test_dropout_is_seeded_and_flax_shaped():
    x = torch.ones(4, 1600)
    a = dropout(x, 0.5, torch.Generator().manual_seed(7))
    b = dropout(x, 0.5, torch.Generator().manual_seed(7))
    torch.testing.assert_close(a, b)
    assert set(torch.unique(a).tolist()) <= {0.0, 2.0}
    with pytest.raises(ValueError):
        MnistConvNet()(torch.zeros(1, 28, 28, 1), train=True)


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_device.resolve(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BaseModel(MnistConvNet(), params_from_jax(flax_params()))
    assert port_device.resolve("cpu") == torch.device("cpu")
