"""A fresh model's parameters, drawn as flax initialises the JAX models.

The port's modules start from PyTorch's defaults (kaiming-uniform), which
is not what the JAX package trains from. ``init_params`` draws every leaf of
a family's flax parameter tree with flax's initializer for it:

- kernels: glorot-uniform, ``U(-limit, limit)`` with
  ``limit = sqrt(6 / (fan_in + fan_out))`` (Keras' default, as
  ``models/convnet.py`` and ``models/transformer.py`` of the JAX package set
  it). A conv kernel HWIO has ``fan_in = kh*kw*c_in`` and
  ``fan_out = kh*kw*c_out``. IMDB's ``DenseGeneral`` kernels are drawn
  flattened, as flax's ``kernel_init_wrap`` does: q/k/v ``[E, (H, dh)]``
  and out ``[(H, dh), E]``;
- biases 0, embeddings ``U(-0.05, 0.05)`` (Keras' ``Embedding``), layer-norm
  scale 1 and bias 0.

The tree comes back in the flax numpy layout (every dict's keys sorted, as
a jitted flax ``init`` returns them), so the bridge and the checkpoint codec
take it. Draws come from an explicit CPU ``torch.Generator``: the same
seed gives the same tree on every device, and different numbers from JAX's
(its RNG is another), with the same distributions.
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from simple_tip_tpu_torch.bridge import family_model, params_to_jax


def _fans(name: str, shape: Tuple[int, ...]) -> Tuple[int, int]:
    """flax glorot fans of the kernel of module ``name`` (the
    ``DenseGeneral`` kernels flattened, as ``kernel_init_wrap`` does)."""
    if len(shape) == 4:  # conv HWIO
        field = shape[0] * shape[1]
        return field * shape[2], field * shape[3]
    if len(shape) == 3:
        if name == "out":  # [H, dh, E]
            return shape[0] * shape[1], shape[2]
        return shape[0], shape[1] * shape[2]  # q/k/v [E, H, dh]
    return shape[0], shape[1]


def init_params(
    family: str, generator: torch.Generator, model: Optional[nn.Module] = None
) -> Dict:
    """A fresh flax-layout tree of ``family`` ("mnist", "cifar10", "imdb").

    The shapes are those of ``model`` (one of the port's models) or, by
    default, of the family's model at the JAX registry's widths; leaves are
    drawn in sorted key order.
    """
    template = params_to_jax(family, model if model is not None else family_model(family)())

    def uniform(shape, limit):
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return ((2 * u - 1) * limit).numpy()

    def walk(node: Dict, module_name: str) -> Dict:
        out = {}
        for key in sorted(node):
            if isinstance(node[key], dict):
                out[key] = walk(node[key], key)
                continue
            shape = tuple(node[key].shape)
            if key == "kernel":
                fan_in, fan_out = _fans(module_name, shape)
                out[key] = uniform(shape, np.sqrt(6.0 / (fan_in + fan_out)))
            elif key == "embedding":
                out[key] = uniform(shape, 0.05)
            elif key == "scale":
                out[key] = np.ones(shape, np.float32)
            else:
                out[key] = np.zeros(shape, np.float32)
        return out

    return walk(template, "")
