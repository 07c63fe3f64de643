"""Batched inference helpers: probabilities, taps and MC-dropout votes.

Counterparts of ``make_predict_fn``, ``make_taps_fn`` and
``mc_dropout_votes`` of the JAX package's ``models/train.py``. Inputs arrive
as host numpy (NHWC) and are moved to the model's device once per call;
results stay on that device.

- ``predict`` goes through the fused forward (``ops/fused_forward.py``): the
  CUDA kernel on the card, its plain version on the CPU.
- Taps come from the module (cuDNN convolutions on the card; the JAX package
  computes them in XLA outside any Pallas kernel too).
- The MC-dropout votes run the deterministic trunk once per batch and only
  the dropout, dense and softmax head once per sample: dropout sits after
  the last convolution, so this is the same function as a full stochastic
  forward per sample. The masks come from one seeded ``torch.Generator``.
"""

from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch

from simple_tip_tpu_torch.models.convnet import MnistConvNet
from simple_tip_tpu_torch.ops.fused_forward import fused_mnist_probs

PREDICT_BATCH = 8192


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a contiguous float32 tensor on ``device``."""
    return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32)).to(device)


@torch.no_grad()
def predict(fused: Dict[str, torch.Tensor], x: np.ndarray, device: torch.device) -> torch.Tensor:
    """Softmax probabilities ``[N, 10]`` on ``device`` from the fused forward."""
    xs = to_device(x, device)
    outs = [
        fused_mnist_probs(fused, xs[start : start + PREDICT_BATCH])
        for start in range(0, xs.shape[0], PREDICT_BATCH)
    ]
    return torch.cat(outs, dim=0)


def tap_ids(activation_layers: Sequence) -> List[int]:
    """Integer tap indices (tuple entries are ignored, as in the JAX package)."""
    return [i for i in activation_layers if isinstance(i, int)]


@torch.no_grad()
def walk_taps(
    net: MnistConvNet,
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
    net: MnistConvNet,
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
        flat = net.features(xs[start : start + batch_size])[4]
        c = torch.zeros(flat.shape[0], net.num_classes, dtype=torch.int64, device=device)
        ones = torch.ones(flat.shape[0], 1, dtype=torch.int64, device=device)
        for _ in range(n_samples):
            _, probs = net.head(flat, train=True, generator=generator)
            c.scatter_add_(1, probs.argmax(dim=1, keepdim=True), ones)
        counts.append(c)
    return torch.cat(counts, dim=0)
