"""The active-learning retrains of one run on one card.

Counterpart of the JAX package's ``parallel/al_ensemble.py``
``al_retrain_ensemble``. Every retrain of an AL run trains a fresh model on
the same base training set plus its own ``k`` selected rows, shuffled with
``RandomState(seed)``; keras' ``fit`` then holds out the last
``validation_split`` of the shuffled rows, so a selected row can land in the
held-out tail. The base set goes to the card once. Per member only its
``k`` extra rows go up, and its training rows are gathered on the card:
``member_perm`` = ``RandomState(seed).permutation(n + k)[:n_train]`` maps
its training slots to rows of base + extras, the head of the JAX package's
host-side shuffle (``engine/eval_active_learning.py`` ``_retrain``). Each
member trains through ``models/train.Trainer.fit`` with the streams
``Trainer.train`` draws from its seed, so on the CPU its parameters are
bit-equal to that shuffle followed by ``train_model``.

Members train one after another. The JAX package vmaps groups of 16;
training members together (``torch.func`` or grouped convolutions) is not
done.
"""

import logging
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from simple_tip_tpu_torch.device import DeviceLike, resolve
from simple_tip_tpu_torch.models.predict import to_device
from simple_tip_tpu_torch.models.train import Trainer, TrainConfig, training_rows

logger = logging.getLogger(__name__)


def member_perm(seed: int, total: int, n_train: int) -> np.ndarray:
    """A member's training slots -> rows of base + extras: the head of the
    host-side shuffle."""
    return np.random.RandomState(seed).permutation(total)[:n_train]


def al_retrain_ensemble(
    model: nn.Module,
    cfg: TrainConfig,
    train_x: np.ndarray,
    train_y_onehot: np.ndarray,
    selections: List[Tuple[np.ndarray, np.ndarray, int]],
    device: DeviceLike = None,
) -> List[Tuple[Dict, List[Dict]]]:
    """Train one fresh ``model`` per ``(x_sel, y_sel_onehot, seed)``
    selection on the base set plus the selection; every selection has the
    same number of rows. Returns, in selection order, each member's flax
    tree and its per-epoch records (``Trainer.train``'s ``history``)."""
    dev = resolve(device)
    n = train_x.shape[0]
    k = selections[0][0].shape[0]
    if not all(s[0].shape[0] == k for s in selections):
        raise ValueError("al_retrain_ensemble needs selections of equal size")
    total = n + k
    n_train = training_rows(total, cfg.validation_split)
    trainer = Trainer(model, cfg, dev)
    base_x = to_device(train_x, dev)
    base_y = torch.as_tensor(np.asarray(train_y_onehot, np.float32)).to(dev)

    results = []
    for x_sel, y_sel, seed in selections:
        rows = torch.as_tensor(member_perm(seed, total, n_train)).to(dev)
        xs = torch.cat((base_x, to_device(x_sel, dev)))[rows]
        ys = torch.cat((base_y, torch.as_tensor(np.asarray(y_sel, np.float32)).to(dev)))[rows]
        history: List[Dict] = []
        results.append((trainer.fit(xs, ys, seed, history), history))
    logger.info("AL ensemble: %d members trained", len(results))
    return results
