"""Test-prioritization phase for one model run (the per-phase route).

Counterpart of the JAX package's ``engine/eval_prioritization.py``
``evaluate`` on its default per-phase route: fault predictors (uncertainty
quantifiers) on nominal and OOD, then the 12 neuron-coverage configurations,
then the five surprise-adequacy variants (dsa, pc-lsa, pc-mdsa, pc-mlsa,
pc-mmdsa), persisting every score, CAM order, misclassification mask and
time record of the 39 approaches under the same naming contract
``priorities/{cs}_{ds}_{model}_{type}.npy`` and
``times/{cs}_{ds}_{model}_{metric}``, with the same dtypes and shapes.
"""

import os
import pickle
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from simple_tip_tpu_torch.config import subdir
from simple_tip_tpu_torch.device import DeviceLike, resolve, synchronize
from simple_tip_tpu_torch.engine.coverage_handler import CoverageWorker
from simple_tip_tpu_torch.engine.model_handler import BaseModel
from simple_tip_tpu_torch.engine.surprise_handler import SA_VARIANTS, SurpriseHandler


def _persist(case_study: str, dataset_id: str, data_type: str, model_id: int, data):
    """Store one artifact array on the filesystem bus."""
    np.save(
        os.path.join(
            subdir("priorities"), f"{case_study}_{dataset_id}_{model_id}_{data_type}.npy"
        ),
        np.asarray(data),
    )


def _persist_times(
    case_study: str, dataset_id: str, model_id: int, metric: str, data: List[float]
):
    """Pickle one ``[setup, pred, quant, cam]`` record, atomically."""
    folder = subdir("times")
    path = os.path.join(folder, f"{case_study}_{dataset_id}_{model_id}_{metric}")
    fd, tmp = tempfile.mkstemp(dir=folder, prefix=".tmp-")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(pickle.dumps(data))
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def _persist_times_multiple_metrics(
    case_study: str, dataset_id: str, model_id: int, data: Dict[str, List[float]]
):
    for metric, times in data.items():
        _persist_times(case_study, dataset_id, model_id, metric, times)


def evaluate(
    model_id: int,
    case_study: str,
    model_def,
    params,
    training_dataset: np.ndarray,
    nominal_test_dataset: np.ndarray,
    nominal_test_labels: np.ndarray,
    ood_test_dataset: np.ndarray,
    ood_test_labels: np.ndarray,
    nc_activation_layers: List,
    sa_activation_layers: List[int],
    dsa_badge_size: Optional[int] = None,
    batch_size: int = 32,
    device: DeviceLike = None,
    sa_names: Sequence[str] = tuple(SA_VARIANTS),
) -> Tuple[Dict[str, float], Dict[str, int]]:
    """Run the test-prioritization experiments for one model.

    ``model_def`` is one of the port's models (``MnistConvNet``,
    ``Cifar10ConvNet``, ``ImdbTransformer``) and ``params`` the bridge's
    output for it (``bridge.params_from_jax``). ``dsa_badge_size`` chunks
    DSA's scoring and never changes a score. VR is written only for a model
    with dropout. ``device=None`` runs on the card and raises without one;
    ``device="cpu"`` runs the plain versions. ``sa_names`` are the SA
    variants scored (all five by default). Returns the wall seconds of each
    phase, and the k that each k-means-clustered SA variant chose.
    """
    device = resolve(device)
    phases = {}
    start = _clock(device)
    for ds_type, ds, labels in (
        ("nominal", nominal_test_dataset, nominal_test_labels),
        ("ood", ood_test_dataset, ood_test_labels),
    ):
        _eval_fault_predictors(
            case_study, model_def, params, model_id, ds, labels, ds_type, batch_size, device
        )
    phases["fault_predictors"], start = _clock(device) - start, _clock(device)
    _eval_neuron_coverage(
        case_study,
        model_def,
        params,
        model_id,
        nc_activation_layers,
        nominal_test_dataset,
        ood_test_dataset,
        training_dataset,
        batch_size,
        device,
    )
    phases["neuron_coverage"], start = _clock(device) - start, _clock(device)
    chosen_k = _eval_surprise(
        case_study,
        model_def,
        params,
        model_id,
        sa_activation_layers,
        nominal_test_dataset,
        ood_test_dataset,
        training_dataset,
        dsa_badge_size,
        device,
        sa_names,
    )
    phases["surprise"], start = _clock(device) - start, _clock(device)
    return phases, chosen_k


def _clock(device) -> float:
    """``perf_counter`` after the device's queued work has finished."""
    synchronize(device)
    return time.perf_counter()


def _eval_fault_predictors(
    case_study, model_def, params, model_id, ds, labels, ds_type, batch_size, device
):
    base_model = BaseModel(model_def, params, batch_size=batch_size, device=device)
    pred, uncertainties, times = base_model.get_pred_and_uncertainty(ds, seed=model_id)
    is_misclassified = pred != np.asarray(labels).flatten()
    _persist(case_study, ds_type, "is_misclassified", model_id, is_misclassified)
    _persist_times_multiple_metrics(case_study, ds_type, model_id, times)
    for unc_id, unc in uncertainties.items():
        _persist(case_study, ds_type, f"uncertainty_{unc_id}", model_id, unc)


def _eval_neuron_coverage(
    case_study,
    model_def,
    params,
    model_id,
    layers,
    nominal_test_dataset,
    ood_test_dataset,
    training_dataset,
    batch_size,
    device,
):
    nc_worker = CoverageWorker(
        base_model=BaseModel(
            model_def, params, activation_layers=layers, batch_size=batch_size, device=device
        ),
        training_set=training_dataset,
    )
    for name, ds in {"nominal": nominal_test_dataset, "ood": ood_test_dataset}.items():
        times, scores, cam_orders = nc_worker.evaluate_all(ds, name)
        _persist_times_multiple_metrics(case_study, name, model_id, times)
        for metric_id, score in scores.items():
            _persist(case_study, name, f"{metric_id}_scores", model_id, score)
        for metric_id, order in cam_orders.items():
            _persist(case_study, name, f"{metric_id}_cam_order", model_id, order)


def _eval_surprise(
    case_study,
    model_def,
    params,
    model_id,
    layers,
    nominal_test_dataset,
    ood_test_dataset,
    training_dataset,
    dsa_badge_size,
    device,
    sa_names,
) -> Dict[str, int]:
    sa_worker = SurpriseHandler(
        model_def,
        params,
        sa_layers=layers,
        training_dataset=training_dataset,
        device=device,
        dsa_badge_size=dsa_badge_size,
        sa_names=sa_names,
    )
    results, chosen_k = sa_worker.evaluate_all(
        datasets={"nominal": nominal_test_dataset, "ood": ood_test_dataset}
    )
    for metric, values in results.items():
        for dataset, (sa, cam_order, times) in values.items():
            _persist_times(case_study, dataset, model_id, metric, times)
            _persist(case_study, dataset, f"{metric}_scores", model_id, sa)
            _persist(case_study, dataset, f"{metric}_cam_order", model_id, cam_order)
    return chosen_k
