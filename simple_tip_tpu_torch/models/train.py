"""Training loops of the port (single-model path).

Counterpart of the JAX package's ``models/train.py`` with its keras-``fit``
semantics (``model.fit(x, y, batch_size, epochs, validation_split)``):

- the last ``validation_split`` of the data is held out before any
  shuffling; the head is the training set, reshuffled every epoch;
- categorical cross-entropy on the softmax outputs, clipped at 1e-7;
- Adam with keras' eps 1e-7 (``torch.optim.Adam``'s update is optax's
  algebra: bias-corrected moments, eps added to the corrected root);
- the ragged final batch is taken as it is: its loss is the mean over its
  real rows, the value of the JAX package's padded-and-masked loss;
- dropout is active while training and draws from a ``torch.Generator`` on
  the model's device.

A model trains from ``init.init_params`` (flax's initializers) drawn from
the run's seed; the epochs (shuffles and dropout) draw from ``seed +
10_000``, the streams the JAX ensemble gives its members. Trained
parameters come back as a flax-layout numpy tree (``bridge.params_to_jax``)
that the checkpoint codec writes and the bridge loads. The IMDB transformer
trains through ``ops/flash_attention.FlashAttention``: kernels B4, B5 and
B6 on the card.
"""

import copy
import logging
import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from simple_tip_tpu_torch.bridge import params_from_jax, params_to_jax
from simple_tip_tpu_torch.device import DeviceLike, resolve, synchronize
from simple_tip_tpu_torch.models.init import init_params
from simple_tip_tpu_torch.models.predict import predict, to_device

logger = logging.getLogger(__name__)

EPOCH_SEED_OFFSET = 10_000


@dataclass(frozen=True)
class TrainConfig:
    """Hyperparameters of one keras-``fit``-equivalent training run."""

    batch_size: int = 128
    epochs: int = 15
    learning_rate: float = 1e-3
    validation_split: float = 0.1


def adam_like_keras(params, learning_rate: float = 1e-3) -> torch.optim.Adam:
    """Adam with tf.keras defaults (eps=1e-7)."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-7)


def categorical_crossentropy(probs: torch.Tensor, y_onehot: torch.Tensor) -> torch.Tensor:
    """Per-sample keras categorical cross-entropy on softmax outputs."""
    return -(y_onehot * torch.log(probs.clamp(1e-7, 1.0))).sum(dim=-1)


def _epoch_plan(n_train: int, batch_size: int) -> int:
    """Steps of one epoch, as the JAX package plans it (the ragged final
    batch is one step)."""
    return math.ceil(n_train / batch_size)


def training_rows(n: int, validation_split: float) -> int:
    """Rows kept for training: the held-out tail is ``int(n * split)`` rows."""
    return n - int(n * validation_split)


def train_epoch(
    net: nn.Module,
    opt: torch.optim.Optimizer,
    x: torch.Tensor,
    y_onehot: torch.Tensor,
    batch_size: int,
    generator: torch.Generator,
) -> torch.Tensor:
    """One epoch over the device-resident training set; returns the
    per-step losses ``[steps]`` on the device (no host sync per step)."""
    n = x.shape[0]
    steps = _epoch_plan(n, batch_size)
    perm = torch.randperm(n, generator=generator, device=x.device)
    losses = torch.empty(steps, device=x.device)
    net.train()
    for step in range(steps):
        idx = perm[step * batch_size : (step + 1) * batch_size]
        probs, _ = net(x[idx], train=True, generator=generator)
        loss = categorical_crossentropy(probs, y_onehot[idx]).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses[step] = loss.detach()
    net.eval()
    return losses


class Trainer:
    """Trains fresh models of one configuration on one device."""

    def __init__(self, model: nn.Module, cfg: TrainConfig, device: DeviceLike = None):
        self.model = model
        self.cfg = cfg
        self.device = resolve(device)

    def fresh(self, seed: int) -> nn.Module:
        """The model with flax-initialised weights drawn from ``seed``."""
        net = copy.deepcopy(self.model)
        tree = init_params(net.family, torch.Generator().manual_seed(seed), net)
        net.load_state_dict(params_from_jax(tree)["module"])
        return net.to(self.device).eval()

    def train(
        self,
        x: np.ndarray,
        y_onehot: np.ndarray,
        seed: int,
        history: Optional[List[Dict]] = None,
    ) -> Dict:
        """Train a fresh model (keras-fit semantics), returning its flax
        tree. Per epoch, ``{"epoch", "steps", "seconds", "first_loss",
        "mean_loss"}`` is appended to ``history`` if one is given."""
        n_train = training_rows(x.shape[0], self.cfg.validation_split)
        xs = to_device(x[:n_train], self.device)
        ys = torch.as_tensor(np.asarray(y_onehot[:n_train], np.float32)).to(self.device)
        return self.fit(xs, ys, seed, history)

    def fit(self, xs: torch.Tensor, ys: torch.Tensor, seed: int,
            history: Optional[List[Dict]] = None) -> Dict:
        """``train`` on training rows already on the device (the AL
        ensemble gathers them there)."""
        cfg = self.cfg
        net = self.fresh(seed)
        opt = adam_like_keras(net.parameters(), cfg.learning_rate)
        generator = torch.Generator(device=self.device).manual_seed(seed + EPOCH_SEED_OFFSET)
        for epoch in range(cfg.epochs):
            synchronize(self.device)
            t0 = time.perf_counter()
            losses = train_epoch(net, opt, xs, ys, cfg.batch_size, generator)
            synchronize(self.device)
            record = {
                "epoch": epoch + 1,
                "steps": int(losses.shape[0]),
                "seconds": time.perf_counter() - t0,
                "first_loss": float(losses[0]),
                "mean_loss": float(losses.mean()),
            }
            logger.info("seed %d epoch %d/%d loss=%.4f (%.2f s)", seed, epoch + 1,
                        cfg.epochs, record["mean_loss"], record["seconds"])
            if history is not None:
                history.append(record)
        return params_to_jax(net.family, net)


def train_model(
    model: nn.Module,
    x: np.ndarray,
    y_onehot: np.ndarray,
    cfg: TrainConfig,
    seed: int,
    device: DeviceLike = None,
    history: Optional[List[Dict]] = None,
) -> Dict:
    """Train a fresh ``model`` (one of the port's models; its own weights
    are not used) from ``seed``, returning its flax-layout tree."""
    return Trainer(model, cfg, device).train(x, y_onehot, seed, history)


def evaluate_accuracy(
    model: nn.Module,
    params: Dict,
    x: np.ndarray,
    labels: np.ndarray,
    device: DeviceLike = None,
) -> float:
    """Top-1 accuracy of ``model`` with the flax tree ``params`` on (x, labels)."""
    return accuracy(model, params_from_jax(params), x, labels, device)


def accuracy(
    model: nn.Module,
    bridged: Dict,
    x: np.ndarray,
    labels: np.ndarray,
    device: DeviceLike = None,
) -> float:
    """``evaluate_accuracy`` with the bridge's output ``bridged``
    (``{"module", "fused"}``) in place of the flax tree."""
    dev = resolve(device)
    net = copy.deepcopy(model).to(dev).eval()
    net.load_state_dict(bridged["module"])
    fused = {k: v.to(dev) for k, v in bridged["fused"].items()}
    pred = predict(net, fused, x, dev).argmax(dim=1).cpu().numpy()
    return float(np.mean(pred == np.asarray(labels).flatten()))
