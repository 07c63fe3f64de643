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
"""

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


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

    def __init__(self, num_classes: int = 10, dropout_rate: float = 0.5):
        super().__init__()
        self.num_classes = num_classes
        self.dropout_rate = dropout_rate
        self.conv1 = nn.Conv2d(1, 32, 3)
        self.conv2 = nn.Conv2d(32, 64, 3)
        self.dense = nn.Linear(1600, num_classes)

    def features(self, x: torch.Tensor) -> Dict[int, torch.Tensor]:
        """Taps 0-4 (NHWC) of the deterministic trunk before dropout."""
        h = x.permute(0, 3, 1, 2)
        taps: Dict[int, torch.Tensor] = {}
        h = F.relu(self.conv1(h))
        taps[0] = h.permute(0, 2, 3, 1)
        h = F.max_pool2d(h, 2)
        taps[1] = h.permute(0, 2, 3, 1)
        h = F.relu(self.conv2(h))
        taps[2] = h.permute(0, 2, 3, 1)
        h = F.max_pool2d(h, 2)
        taps[3] = h.permute(0, 2, 3, 1)
        taps[4] = taps[3].reshape(h.shape[0], -1)
        return taps

    def head(
        self,
        flat: torch.Tensor,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(dropout output, probabilities) from the NHWC-flattened features."""
        if train:
            if generator is None:
                raise ValueError("train=True needs an explicit torch.Generator")
            flat = dropout(flat, self.dropout_rate, generator)
        probs = torch.softmax(self.dense(flat), dim=-1)
        return flat, probs

    def forward(
        self,
        x: torch.Tensor,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Dict[int, torch.Tensor]]:
        """``(probs, taps)`` for NHWC input ``x``."""
        taps = self.features(x)
        taps[5], probs = self.head(taps[4], train=train, generator=generator)
        taps[6] = probs
        return probs, taps

    def vote_prefix(self, x: torch.Tensor) -> torch.Tensor:
        """The deterministic part of a stochastic forward: everything before
        the only dropout site (the flattened features)."""
        return self.features(x)[4]

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

    def __init__(self, num_classes: int = 10):
        super().__init__()
        self.num_classes = num_classes
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
        h = x.permute(0, 3, 1, 2)
        taps: Dict[int, torch.Tensor] = {}
        h = F.relu(self.conv1(h))
        taps[0] = h.permute(0, 2, 3, 1)
        h = F.max_pool2d(h, 2)
        taps[1] = h.permute(0, 2, 3, 1)
        h = F.relu(self.conv2(h))
        taps[2] = h.permute(0, 2, 3, 1)
        h = F.max_pool2d(h, 2)
        taps[3] = h.permute(0, 2, 3, 1)
        h = F.relu(self.conv3(h))
        taps[4] = h.permute(0, 2, 3, 1)
        taps[5] = taps[4].reshape(h.shape[0], -1)
        taps[6] = F.relu(self.dense1(taps[5]))
        probs = torch.softmax(self.dense2(taps[6]), dim=-1)
        taps[7] = probs
        return probs, taps
