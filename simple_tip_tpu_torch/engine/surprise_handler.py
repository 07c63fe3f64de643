"""Surprise-adequacy engine: fit the five SA variants on the training
traces, score every test set, and derive each variant's surprise-coverage
CAM order.

Counterpart of the JAX package's ``engine/surprise_handler.py`` flow
(``evaluate_all``: fit -> score -> SC-CAM per dataset) with its registry and
hyperparameters: DSA at 30% subsampling (``dsa_badge_size`` chunks its
scoring), per-class LSA (``max_features=300``), per-class MDSA, per-class
MLSA with 3 components, and k-means-clustered MDSA with k in 2..5 at 30%
subsampling (``subsampling_seed=0``). Train traces and predictions come
from one forward pass over ``sa_layers`` plus the output, flattened and
partitioned by class once (``engine/sa_prep.py``). The time record is
``[setup, pred, quant, cam]``, setup being the train-trace collection, the
variant's share of the shared preparation and its own fit; the SC bucket
upper bound is the maximum finite score (an LSA density that underflows
gives +inf, which lands in no bucket).
"""

import logging
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from simple_tip_tpu_torch.device import DeviceLike
from simple_tip_tpu_torch.engine.model_handler import BaseModel
from simple_tip_tpu_torch.engine.sa_prep import SharedTrainPrep, VariantFitter
from simple_tip_tpu_torch.ops.prioritizers import cam
from simple_tip_tpu_torch.ops.surprise import LSA, MDSA, MLSA, SurpriseCoverageMapper
from simple_tip_tpu_torch.ops.timer import Timer

logger = logging.getLogger(__name__)

NUM_SC_BUCKETS = 1000

# {sa_name: fitter -> scorer}, the JAX package's registry with its hyperparameters
SA_VARIANTS: Dict[str, Callable[[VariantFitter], Callable]] = {
    "dsa": lambda fit: fit.dsa(subsampling=0.3),
    "pc-lsa": lambda fit: fit.by_class(lambda a: LSA(a, device=fit.device)),
    "pc-mdsa": lambda fit: fit.by_class(lambda a: MDSA(a, device=fit.device)),
    "pc-mlsa": lambda fit: fit.by_class(lambda a: MLSA(a, num_components=3, device=fit.device)),
    "pc-mmdsa": lambda fit: fit.with_kmeans(
        lambda a: MDSA(a, device=fit.device), potential_k=range(2, 6), subsampling=0.3
    ),
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
        sa_names: Sequence[str] = tuple(SA_VARIANTS),
    ):
        self.sa_names = tuple(sa_names)
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
    ) -> Tuple[Dict[str, Dict[str, DatasetResult]], Dict[str, int]]:
        """``{sa_name: {ds_name: (scores, cam_order, times)}}`` for the
        handler's ``sa_names``, and ``{sa_name: k}`` for the variants whose
        modals come from silhouette-scored k-means (pc-mmdsa)."""
        traces = {}
        for ds_name, dataset in datasets.items():
            with Timer(device=self.device) as pred_timer:
                ats, preds = self._traces(dataset)
            traces[ds_name] = (ats, preds, pred_timer.get())
        with Timer(device=self.device) as train_at_timer:
            train_ats, train_pred = self._traces(self.training_dataset)
        prep = SharedTrainPrep(train_ats, train_pred, self.device)
        fitter = VariantFitter(prep, self.device, self.dsa_badge_size)

        results: Dict[str, Dict[str, DatasetResult]] = {}
        chosen_k: Dict[str, int] = {}
        for sa_name in self.sa_names:
            logger.info("fitting %s", sa_name)
            with Timer(device=self.device) as fit_timer:
                scorer = SA_VARIANTS[sa_name](fitter)
            setup_s = train_at_timer.get() + prep.debit_for(sa_name) + fit_timer.get()
            k = getattr(getattr(scorer, "discriminator", None), "best_k", None)
            if k is not None:
                chosen_k[sa_name] = k
                logger.info("%s chose k=%d", sa_name, k)
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
        return results, chosen_k
