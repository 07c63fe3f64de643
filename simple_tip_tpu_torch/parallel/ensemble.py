"""Training an ensemble of independent models on one card.

Counterpart of the JAX package's ``parallel/ensemble.py``. There, all
requested models train in one jitted program, a vmap of the epoch function
over a stacked parameter tree, laid out over a device mesh. Here, on one
card, the members train one after another through ``models/train.py``;
each keeps its own streams (init from its seed, epochs from ``seed +
10_000``), so the ensemble equals ``len(seeds)`` independent
``train_model`` calls. The result has the JAX layout: one tree whose every
leaf is ``[G, ...]``, member g at index g.
"""

from typing import Dict, List, Optional

import numpy as np
from torch import nn

from simple_tip_tpu_torch.device import DeviceLike
from simple_tip_tpu_torch.models.train import Trainer, TrainConfig


def _map(fn, *trees):
    """``fn`` over the leaves of nested dicts of the same structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def stack_params(params_list: List[Dict]) -> Dict:
    """Per-member trees stacked into one tree with a leading member axis
    (``np.stack``, so every leaf keeps its dtype)."""
    if not params_list:
        raise ValueError("stack_params needs at least one member")
    return _map(lambda *leaves: np.stack([np.asarray(l) for l in leaves]), *params_list)


def unstack(stacked: Dict, i: int) -> Dict:
    """Member ``i``'s tree from a stacked tree (host copies)."""
    return _map(lambda leaf: np.ascontiguousarray(leaf[i]), stacked)


def train_ensemble(
    model: nn.Module,
    x: np.ndarray,
    y_onehot: np.ndarray,
    cfg: TrainConfig,
    seeds: List[int],
    device: DeviceLike = None,
    histories: Optional[Dict[int, List[Dict]]] = None,
) -> Dict:
    """Train ``len(seeds)`` independent models; returns the stacked tree
    (leading axis ordered like ``seeds``). Each member's per-epoch records
    go to ``histories[seed]`` if a dict is given."""
    trainer = Trainer(model, cfg, device)
    members = []
    for seed in seeds:
        history = histories.setdefault(seed, []) if histories is not None else None
        members.append(trainer.train(x, y_onehot, seed, history))
    return stack_params(members)
