"""Port parity for kernel B1, the fused MNIST forward.

On the CPU the wrapper runs the kernel's plain PyTorch version; it is held
against the JAX package's Pallas kernel run in interpret mode
(``fused_mnist_probs(..., compute_dtype=None, interpret=True)``) and against
flax, at atol 1e-5. The CUDA kernel itself is held against the plain
version on the card in ``test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_tip_tpu.models import MnistConvNet as FlaxMnistConvNet
from simple_tip_tpu.ops.fused_forward import fused_mnist_probs as pallas_fused_mnist_probs
from simple_tip_tpu_torch.bridge import params_from_jax
from simple_tip_tpu_torch.models import MnistConvNet
from simple_tip_tpu_torch.models.predict import predict
from simple_tip_tpu_torch.ops import fused_forward
from test_torch_model import flax_params
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _inputs(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, size=(n, 28, 28, 1)).astype(np.float32)


def test_plain_matches_pallas_interpret_and_flax():
    params = flax_params(2)
    x = _inputs(10, 2)
    fused = params_from_jax(params)["fused"]
    before = fused_forward.LAUNCHES
    got = fused_forward.fused_mnist_probs(fused, torch.from_numpy(x)).numpy()
    assert fused_forward.LAUNCHES == before, "a CPU tensor must not launch the kernel"
    pallas = pallas_fused_mnist_probs(
        params, jnp.asarray(x), compute_dtype=None, tile=8, interpret=True
    )
    flax_probs, _ = FlaxMnistConvNet().apply({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, np.asarray(flax_probs), atol=1e-5, rtol=0)


def test_predict_batches_through_the_wrapper(monkeypatch):
    params = flax_params(1)
    x = _inputs(7, 1)
    monkeypatch.setattr("simple_tip_tpu_torch.models.predict.PREDICT_BATCH", 3)
    fused = params_from_jax(params)["fused"]
    got = predict(MnistConvNet(), fused, x, torch.device("cpu")).numpy()
    want, _ = FlaxMnistConvNet().apply({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


def test_wrapper_rejects_unknown_devices():
    fused = params_from_jax(flax_params())["fused"]
    with pytest.raises(ValueError):
        fused_forward.fused_mnist_probs(fused, torch.zeros(1, 28, 28, 1, device="meta"))

