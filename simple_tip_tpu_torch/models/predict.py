"""Batched inference helpers: probabilities, taps and MC-dropout votes.

Counterparts of ``make_predict_fn``, ``make_taps_fn`` and
``mc_dropout_votes`` of the JAX package's ``models/train.py``. Inputs arrive
as host numpy (NHWC images, or integer token ids) and are moved to the
model's device once per call; results stay on that device.

- ``predict`` goes through the family's fused forward where the JAX package
  has one (``ops/fused_forward.py``: kernel B1 for the MNIST convnet, B3 for
  the CIFAR-10 convnet, on the card; their plain versions on the CPU), and
  through the module otherwise (the IMDB transformer, whose attention core
  is kernel B4). A module in the bf16 scoring mode (``compute_dtype``
  bfloat16) takes the bf16 fused forwards (B1 and B3 in bf16) and B4's bf16
  forward.
- Taps come from the module (cuDNN convolutions on the card; the JAX package
  computes them in XLA outside any Pallas kernel too).
- The MC-dropout votes run a model's deterministic prefix (``vote_prefix``:
  everything before its first dropout site) once per batch and the rest
  (``vote_probs``) once per sample: the same function as a full stochastic
  forward per sample, with the masks from one seeded ``torch.Generator``.
"""

from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch
from torch import nn

from simple_tip_tpu_torch.models.convnet import Cifar10ConvNet, MnistConvNet
from simple_tip_tpu_torch.ops.fused_forward import (
    fused_cifar10_probs,
    fused_cifar10_probs_bf16,
    fused_mnist_probs,
    fused_mnist_probs_bf16,
)

PREDICT_BATCH = 8192
_FUSED_FORWARD = {MnistConvNet: fused_mnist_probs, Cifar10ConvNet: fused_cifar10_probs}
# the bf16 scoring mode's (a module with compute_dtype bfloat16)
_FUSED_FORWARD_BF16 = {MnistConvNet: fused_mnist_probs_bf16,
                       Cifar10ConvNet: fused_cifar10_probs_bf16}


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a contiguous tensor on ``device``: integer arrays
    (token ids) as int64, everything else as float32."""
    x = np.asarray(x)
    dtype = np.int64 if np.issubdtype(x.dtype, np.integer) else np.float32
    return torch.as_tensor(np.ascontiguousarray(x, dtype=dtype)).to(device)


@torch.no_grad()
def predict(
    net: nn.Module, fused: Dict[str, torch.Tensor], x: np.ndarray, device: torch.device
) -> torch.Tensor:
    """Softmax probabilities ``[N, classes]`` on ``device``: the family's
    fused forward (of the module's compute dtype) over the bridge's
    operands ``fused``, or the module."""
    xs = to_device(x, device)
    bf16 = getattr(net, "compute_dtype", None) is not None
    fused_fn = (_FUSED_FORWARD_BF16 if bf16 else _FUSED_FORWARD).get(type(net))
    outs = []
    for start in range(0, xs.shape[0], PREDICT_BATCH):
        xb = xs[start : start + PREDICT_BATCH]
        outs.append(fused_fn(fused, xb) if fused_fn is not None else net(xb)[0])
    return torch.cat(outs, dim=0)


def tap_ids(activation_layers: Sequence) -> List[int]:
    """Integer tap indices (tuple entries are ignored, as in the JAX package)."""
    return [i for i in activation_layers if isinstance(i, int)]


@torch.no_grad()
def walk_taps(
    net: nn.Module,
    x: np.ndarray,
    layer_ids: Sequence[int],
    include_last_layer: bool,
    batch_size: int,
    device: torch.device,
) -> Iterator[List[torch.Tensor]]:
    """Per batch, the requested taps (NHWC) plus the probabilities if asked."""
    xs = to_device(x, device)
    for start in range(0, xs.shape[0], batch_size):
        probs, taps = net(xs[start : start + batch_size])
        outs = [taps[i] for i in layer_ids]
        if include_last_layer:
            outs.append(probs)
        yield outs


@torch.no_grad()
def mc_dropout_votes(
    net: nn.Module,
    x: np.ndarray,
    n_samples: int,
    generator: torch.Generator,
    batch_size: int,
    device: torch.device,
) -> torch.Tensor:
    """Class-vote counts ``[N, classes]`` (int64) over stochastic passes."""
    xs = to_device(x, device)
    counts = []
    for start in range(0, xs.shape[0], batch_size):
        prefix = net.vote_prefix(xs[start : start + batch_size])
        n = min(batch_size, xs.shape[0] - start)
        c = torch.zeros(n, net.num_classes, dtype=torch.int64, device=device)
        ones = torch.ones(n, 1, dtype=torch.int64, device=device)
        for _ in range(n_samples):
            probs = net.vote_probs(prefix, generator)
            c.scatter_add_(1, probs.argmax(dim=1, keepdim=True), ones)
        counts.append(c)
    return torch.cat(counts, dim=0)
