"""Surprise-adequacy engine: fit DSA on the training traces, score every test
set, and derive the surprise-coverage CAM order.

Counterpart of the JAX package's ``engine/surprise_handler.py`` flow
(``evaluate_all``: fit -> score -> SC-CAM per dataset) with the registry
limited to DSA at 30% subsampling (``dsa_badge_size`` chunks its scoring,
as in the JAX package); the four other variants (pc-lsa,
pc-mdsa, pc-mlsa, pc-mmdsa) are not ported yet. Train traces and
predictions come from one forward pass over ``sa_layers`` plus the output;
the time record is ``[setup, pred, quant, cam]`` with setup including the
train-trace collection; the SC bucket upper bound is the maximum finite
score.
"""

import logging
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from simple_tip_tpu_torch.device import DeviceLike
from simple_tip_tpu_torch.engine.model_handler import BaseModel
from simple_tip_tpu_torch.ops.prioritizers import cam
from simple_tip_tpu_torch.ops.surprise import DSA, SurpriseCoverageMapper
from simple_tip_tpu_torch.ops.timer import Timer

logger = logging.getLogger(__name__)

NUM_SC_BUCKETS = 1000

SA_VARIANTS: Dict[str, Callable] = {
    "dsa": lambda ats, preds, badge: DSA(ats, preds, subsampling=0.3, badge_size=badge),
}

DatasetResult = Tuple[np.ndarray, np.ndarray, List[float]]
"""(sa_scores, sc_cam_order, [setup, pred, quant, cam] seconds)."""


def _sc_cam_order(sa_scores: np.ndarray) -> np.ndarray:
    """CAM order over 1000-bucket SC profiles bounded by the max finite score."""
    finite = np.asarray(sa_scores)[np.isfinite(sa_scores)]
    upper = float(finite.max()) if finite.size else 1.0
    profiles = SurpriseCoverageMapper(NUM_SC_BUCKETS, upper).get_coverage_profile(sa_scores)
    return np.fromiter(cam(sa_scores, profiles), dtype=np.int64)


class SurpriseHandler:
    """One fitted-per-run surprise engine."""

    def __init__(
        self,
        model_def,
        params,
        sa_layers: List[int],
        training_dataset: np.ndarray,
        batch_size: int = 1024,
        device: DeviceLike = None,
        dsa_badge_size: Optional[int] = None,
    ):
        self.sa_layers = list(sa_layers)
        self.dsa_badge_size = dsa_badge_size
        self.training_dataset = training_dataset
        self.base_model = BaseModel(
            model_def,
            params,
            activation_layers=self.sa_layers,
            include_last_layer=True,
            batch_size=batch_size,
            device=device,
        )
        self.device = self.base_model.device

    def _traces(self, dataset: np.ndarray) -> Tuple[List[torch.Tensor], np.ndarray]:
        """(tapped activations on the device, argmax predictions) in one pass."""
        outs = self.base_model.get_activations(dataset)
        return outs[:-1], outs[-1].argmax(dim=1).cpu().numpy()

    def evaluate_all(
        self, datasets: Dict[str, np.ndarray]
    ) -> Dict[str, Dict[str, DatasetResult]]:
        """``{sa_name: {ds_name: (scores, cam_order, times)}}``."""
        traces = {}
        for ds_name, dataset in datasets.items():
            with Timer(device=self.device) as pred_timer:
                ats, preds = self._traces(dataset)
            traces[ds_name] = (ats, preds, pred_timer.get())
        with Timer(device=self.device) as train_at_timer:
            train_ats, train_pred = self._traces(self.training_dataset)

        results: Dict[str, Dict[str, DatasetResult]] = {}
        for sa_name, constructor in SA_VARIANTS.items():
            logger.info("fitting %s", sa_name)
            with Timer(device=self.device) as fit_timer:
                scorer = constructor(train_ats, train_pred, self.dsa_badge_size)
            setup_s = train_at_timer.get() + fit_timer.get()
            per_ds: Dict[str, DatasetResult] = {}
            for ds_name, (ats, preds, pred_s) in traces.items():
                logger.info("scoring %s on %s", sa_name, ds_name)
                with Timer(device=self.device) as quant_timer:
                    scores = scorer(ats, preds)
                with Timer() as cam_timer:
                    order = _sc_cam_order(scores)
                per_ds[ds_name] = (
                    scores,
                    order,
                    [setup_s, pred_s, quant_timer.get(), cam_timer.get()],
                )
            results[sa_name] = per_ds
        return results
