"""The convnets of the JAX package's ``models/convnet.py`` as torch modules.

- ``MnistConvNet``: Conv 32 3x3 relu -> MaxPool 2x2 -> Conv 64 3x3 relu ->
  MaxPool 2x2 -> Flatten -> Dropout 0.5 -> Dense 10 softmax; NHWC
  ``[B, 28, 28, 1]`` in, taps 0-6.
- ``Cifar10ConvNet``: Conv 32 -> MaxPool -> Conv 64 -> MaxPool (13 floors
  to 6) -> Conv 64 -> Flatten -> Dense 64 relu -> Dense 10 softmax; NHWC
  ``[B, 32, 32, 3]`` in, taps 0-7, no dropout (so no VR, as in the JAX
  package).

The convolutions run NCHW inside, and every tap is returned NHWC under its
Keras layer index. The flatten before the first dense layer is NHWC too, so
the dense kernel's rows and the neuron order of the coverage profiles and
the SA features match the reference.

Dropout is active only with ``train=True`` and draws from an explicit
``torch.Generator`` (flax semantics: keep with probability ``1 - rate`` and
scale kept values by ``1 / (1 - rate)``).

``compute_dtype="bfloat16"`` is the JAX models' bf16 scoring mode
(``models/precision.py``): convolutions and dense layers in bfloat16 with
their biases added in bfloat16, relu, pools and dropout on bfloat16, taps
cast to float32 and the softmax on float32 logits. The default (None) is
float32.
"""

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from simple_tip_tpu_torch.models.precision import (
    DtypeLike,
    as_compute_dtype,
    conv2d,
    linear,
    repr_suffix,
)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Flax ``nn.Dropout`` with an explicit generator."""
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class MnistConvNet(nn.Module):
    """LeNet-style convnet for MNIST/FMNIST; taps 0-3 are conv/pool outputs."""

    family = "mnist"
    has_dropout = True
    sa_layers = (3,)
    nc_layers = (0, 1, 2, 3)
    all_layers = (0, 1, 2, 3, 4, 5, 6)

    def __init__(self, num_classes: int = 10, dropout_rate: float = 0.5,
                 compute_dtype: DtypeLike = None):
        super().__init__()
        self.num_classes = num_classes
        self.dropout_rate = dropout_rate
        self.compute_dtype = as_compute_dtype(compute_dtype)
        self.conv1 = nn.Conv2d(1, 32, 3)
        self.conv2 = nn.Conv2d(32, 64, 3)
        self.dense = nn.Linear(1600, num_classes)

    def extra_repr(self) -> str:
        return repr_suffix(self.compute_dtype)

    def _trunk(self, x: torch.Tensor) -> Tuple[Dict[int, torch.Tensor], torch.Tensor]:
        """Taps 0-3 (NHWC, float32) and the flattened features in the
        compute dtype."""
        cdt = self.compute_dtype
        h = x.permute(0, 3, 1, 2)
        if cdt is not None:
            h = h.to(cdt)
        taps: Dict[int, torch.Tensor] = {}
        h = F.relu(conv2d(self.conv1, h, cdt))
        taps[0] = h.permute(0, 2, 3, 1).float()
        h = F.max_pool2d(h, 2)
        taps[1] = h.permute(0, 2, 3, 1).float()
        h = F.relu(conv2d(self.conv2, h, cdt))
        taps[2] = h.permute(0, 2, 3, 1).float()
        h = F.max_pool2d(h, 2)
        taps[3] = h.permute(0, 2, 3, 1).float()
        return taps, h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)

    def features(self, x: torch.Tensor) -> Dict[int, torch.Tensor]:
        """Taps 0-4 (NHWC, float32) of the deterministic trunk before dropout."""
        taps, flat = self._trunk(x)
        taps[4] = flat.float()
        return taps

    def head(
        self,
        flat: torch.Tensor,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(dropout output, probabilities) from the NHWC-flattened features
        (in the compute dtype, which a float32 copy of them is cast back to)."""
        cdt = self.compute_dtype
        if cdt is not None:
            flat = flat.to(cdt)
        if train:
            if generator is None:
                raise ValueError("train=True needs an explicit torch.Generator")
            flat = dropout(flat, self.dropout_rate, generator)
        probs = torch.softmax(linear(self.dense, flat, cdt).float(), dim=-1)
        return flat, probs

    def forward(
        self,
        x: torch.Tensor,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Dict[int, torch.Tensor]]:
        """``(probs, taps)`` for NHWC input ``x``."""
        taps, flat = self._trunk(x)
        taps[4] = flat.float()
        flat, probs = self.head(flat, train=train, generator=generator)
        taps[5] = flat.float()
        taps[6] = probs
        return probs, taps

    def vote_prefix(self, x: torch.Tensor) -> torch.Tensor:
        """The deterministic part of a stochastic forward: everything before
        the only dropout site (the flattened features, in the compute dtype)."""
        return self._trunk(x)[1]

    def vote_probs(self, flat: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """Probabilities of one stochastic forward from ``vote_prefix``'s output."""
        return self.head(flat, train=True, generator=generator)[1]


class Cifar10ConvNet(nn.Module):
    """3-conv CNN for CIFAR-10; no stochastic layers (VR intentionally absent)."""

    family = "cifar10"
    has_dropout = False
    sa_layers = (3,)
    nc_layers = (0, 1, 2, 3)
    all_layers = (0, 1, 2, 3, 4, 5, 6, 7)

    def __init__(self, num_classes: int = 10, compute_dtype: DtypeLike = None):
        super().__init__()
        self.num_classes = num_classes
        self.compute_dtype = as_compute_dtype(compute_dtype)
        self.conv1 = nn.Conv2d(3, 32, 3)
        self.conv2 = nn.Conv2d(32, 64, 3)
        self.conv3 = nn.Conv2d(64, 64, 3)
        self.dense1 = nn.Linear(1024, 64)
        self.dense2 = nn.Linear(64, num_classes)

    def forward(
        self,
        x: torch.Tensor,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Dict[int, torch.Tensor]]:
        """``(probs, taps)`` for NHWC input ``x`` ``[B, 32, 32, 3]``; the
        model has no dropout, so ``train`` and ``generator`` change nothing
        (they keep the training loop's call the same for every family)."""
        cdt = self.compute_dtype
        h = x.permute(0, 3, 1, 2)
        if cdt is not None:
            h = h.to(cdt)
        taps: Dict[int, torch.Tensor] = {}
        h = F.relu(conv2d(self.conv1, h, cdt))
        taps[0] = h.permute(0, 2, 3, 1).float()
        h = F.max_pool2d(h, 2)
        taps[1] = h.permute(0, 2, 3, 1).float()
        h = F.relu(conv2d(self.conv2, h, cdt))
        taps[2] = h.permute(0, 2, 3, 1).float()
        h = F.max_pool2d(h, 2)
        taps[3] = h.permute(0, 2, 3, 1).float()
        h = F.relu(conv2d(self.conv3, h, cdt))
        taps[4] = h.permute(0, 2, 3, 1).float()
        flat = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        taps[5] = flat.float()
        hd = F.relu(linear(self.dense1, flat, cdt))
        taps[6] = hd.float()
        probs = torch.softmax(linear(self.dense2, hd, cdt).float(), dim=-1)
        taps[7] = probs
        return probs, taps

    def extra_repr(self) -> str:
        return repr_suffix(self.compute_dtype)
