"""Activation-trace dump (the ``at_collection`` phase).

Counterpart of the JAX package's ``engine/activation_persistor.py``: every
tap of ``model_def.all_layers`` and the labels, in badges of 100, to
``activations/{cs}/model_{id}/{ds}/layer_{i}/badge_{j}.npy`` and
``.../labels/badge_{j}.npy``, with ``ds`` one of ``train``,
``test_nominal`` and ``test_nominal_and_corrupted``. Taps are float32 NHWC
arrays (the transformer's as the JAX package shapes them); labels keep the
caller's dtype. The full dump of a study is terabytes.
"""

import os
from typing import Tuple

import numpy as np

from simple_tip_tpu_torch.config import output_folder
from simple_tip_tpu_torch.device import DeviceLike
from simple_tip_tpu_torch.engine.model_handler import BaseModel

BADGE_SIZE = 100


def _persist_badge(case_study, model_id, dataset, badge_id, activations, labels):
    path = os.path.join(
        output_folder(), "activations", case_study, f"model_{model_id}", dataset
    )
    for layer_i, layer_at in enumerate(activations):
        folder = os.path.join(path, f"layer_{layer_i}")
        os.makedirs(folder, exist_ok=True)
        np.save(os.path.join(folder, f"badge_{badge_id}.npy"), layer_at)
    labels_folder = os.path.join(path, "labels")
    os.makedirs(labels_folder, exist_ok=True)
    np.save(os.path.join(labels_folder, f"badge_{badge_id}.npy"), labels)


def persist(
    model_def,
    params,
    case_study: str,
    model_id: int,
    train_set: Tuple[np.ndarray, np.ndarray],
    test_nominal: Tuple[np.ndarray, np.ndarray],
    test_corrupted: Tuple[np.ndarray, np.ndarray],
    device: DeviceLike = None,
) -> None:
    """Persist all layer activations of the model (``params`` the bridge's
    output) for the three datasets. ``device=None`` runs on the card and
    raises without one."""
    transparent_model = BaseModel(
        model_def,
        params,
        activation_layers=list(model_def.all_layers),
        include_last_layer=False,
        batch_size=BADGE_SIZE,
        device=device,
    )
    for ds, (x, y) in {
        "train": train_set,
        "test_nominal": test_nominal,
        "test_nominal_and_corrupted": test_corrupted,
    }.items():
        for badge_id, start in enumerate(range(0, x.shape[0], BADGE_SIZE)):
            badge_x = x[start : start + BADGE_SIZE]
            badge_y = y[start : start + BADGE_SIZE]
            activations = [a.cpu().numpy() for a in transparent_model.get_activations(badge_x)]
            _persist_badge(case_study, model_id, ds, badge_id, activations, badge_y)
