"""Weight bridge from the flax parameter tree of ``MnistConvNet``.

The flax tree arrives as nested dicts of numpy arrays (``Conv_0``, ``Conv_1``,
``Dense_0`` -> ``kernel``, ``bias``); the port needs two layouts of it:

- ``"module"``: the ``state_dict`` of the port's ``MnistConvNet``. Conv
  kernels go from HWIO to OIHW. The dense kernel keeps its ``[in, out]`` row
  order, stored transposed as ``nn.Linear``'s ``[out, in]``; its rows already
  follow the NHWC flatten that the module reproduces.
- ``"fused"``: the operands of the fused forward kernel. ``w1`` is conv1 as
  ``[9, 32]`` (tap ``dy*3+dx``), ``w2`` conv2 as the im2col matrix
  ``[288, 64]`` with rows in ``(dy, dx, c)`` order (``HWIO.reshape(288, 64)``),
  ``wd`` the dense kernel ``[1600, 10]`` in NHWC flatten order.

All tensors are float32 on the CPU; callers move them to their device.
"""

from typing import Dict

import numpy as np
import torch


def _f32(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def params_from_jax(params) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"module": state_dict, "fused": kernel operands}`` from a flax tree."""
    w1 = np.asarray(params["Conv_0"]["kernel"], dtype=np.float32)
    w2 = np.asarray(params["Conv_1"]["kernel"], dtype=np.float32)
    wd = np.asarray(params["Dense_0"]["kernel"], dtype=np.float32)
    if w1.shape != (3, 3, 1, 32) or w2.shape != (3, 3, 32, 64) or wd.shape != (1600, 10):
        raise ValueError(
            "bridge mirrors the MNIST convnet only: got "
            f"{w1.shape}, {w2.shape}, {wd.shape}"
        )
    b1 = params["Conv_0"]["bias"]
    b2 = params["Conv_1"]["bias"]
    bd = params["Dense_0"]["bias"]
    module = {
        "conv1.weight": _f32(w1.transpose(3, 2, 0, 1)),
        "conv1.bias": _f32(b1),
        "conv2.weight": _f32(w2.transpose(3, 2, 0, 1)),
        "conv2.bias": _f32(b2),
        "dense.weight": _f32(wd.T),
        "dense.bias": _f32(bd),
    }
    fused = {
        "w1": _f32(w1.reshape(9, 32)),
        "b1": _f32(b1),
        "w2": _f32(w2.reshape(288, 64)),
        "b2": _f32(b2),
        "wd": _f32(wd),
        "bd": _f32(bd),
    }
    return {"module": module, "fused": fused}


def glorot_params(seed: int) -> Dict[str, Dict[str, np.ndarray]]:
    """A flax-layout ``MnistConvNet`` tree drawn with numpy from ``seed``.

    Glorot-uniform kernels (Keras' default, as ``convnet.py`` initialises
    them; fan-in and fan-out include the receptive field) and small uniform
    biases, so that every layer's bias path is exercised.
    """
    rng = np.random.default_rng(seed)

    def glorot(shape, fan_in, fan_out):
        limit = np.sqrt(6.0 / (fan_in + fan_out))
        return rng.uniform(-limit, limit, size=shape).astype(np.float32)

    def bias(n):
        return rng.uniform(-0.05, 0.05, size=n).astype(np.float32)

    return {
        "Conv_0": {"kernel": glorot((3, 3, 1, 32), 9, 9 * 32), "bias": bias(32)},
        "Conv_1": {"kernel": glorot((3, 3, 32, 64), 9 * 32, 9 * 64), "bias": bias(64)},
        "Dense_0": {"kernel": glorot((1600, 10), 1600, 10), "bias": bias(10)},
    }
