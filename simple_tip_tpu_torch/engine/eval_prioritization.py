"""Test-prioritization phase for one model run (the per-phase route).

Counterpart of the JAX package's ``engine/eval_prioritization.py``
``evaluate`` on its default per-phase route: fault predictors (uncertainty
quantifiers) on nominal and OOD, then the 12 neuron-coverage configurations,
then the five surprise-adequacy variants (dsa, pc-lsa, pc-mdsa, pc-mlsa,
pc-mmdsa), persisting every score, CAM order, misclassification mask and
time record of the 39 approaches under the same naming contract
``priorities/{cs}_{ds}_{model}_{type}.npy`` and
``times/{cs}_{ds}_{model}_{metric}``, with the same dtypes and shapes.

With ``TIP_FUSED_CHAIN=1`` (``engine/run_program.py``) one chain program a
badge replaces the fault-predictor and neuron-coverage phases and writes
the same artifact set; surprise adequacy stays per-phase. ``evaluate_group``
scores G models per dispatch (``TIP_CHAIN_GROUP``), the next group's
weights uploading while the current one walks.
"""

import os
import pickle
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from simple_tip_tpu_torch.config import subdir
from simple_tip_tpu_torch.device import DeviceLike, resolve, synchronize
from simple_tip_tpu_torch.engine.coverage_handler import CoverageWorker
from simple_tip_tpu_torch.engine.model_handler import BaseModel
from simple_tip_tpu_torch.engine.run_program import (
    FusedChainRunner,
    GroupChainRunner,
    chain_group_size,
    fused_chain_enabled,
)
from simple_tip_tpu_torch.engine.surprise_handler import SA_VARIANTS, SurpriseHandler
from simple_tip_tpu_torch.utils.artifacts_io import atomic_write_bytes


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
    path = os.path.join(subdir("times"), f"{case_study}_{dataset_id}_{model_id}_{metric}")
    atomic_write_bytes(path, pickle.dumps(data))


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
    phase, and the k that each k-means-clustered SA variant chose. With
    ``TIP_FUSED_CHAIN`` on, the phase ``fused_chain`` replaces
    ``fault_predictors`` and ``neuron_coverage``.
    """
    device = resolve(device)
    phases = {}
    datasets = (
        ("nominal", nominal_test_dataset, nominal_test_labels),
        ("ood", ood_test_dataset, ood_test_labels),
    )
    start = _clock(device)
    if fused_chain_enabled():
        runner = FusedChainRunner(model_def, params, training_dataset, nc_activation_layers,
                                  batch_size=batch_size, device=device)
        for ds_type, ds, labels in datasets:
            _persist_chain_result(case_study, ds_type, model_id, labels,
                                  runner.evaluate_dataset(ds, seed=model_id))
        phases["fused_chain"], start = _clock(device) - start, _clock(device)
    else:
        for ds_type, ds, labels in datasets:
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


def evaluate_group(
    model_ids: List[int],
    case_study: str,
    model_def,
    params_loader,
    training_dataset: np.ndarray,
    nominal_test_dataset: np.ndarray,
    nominal_test_labels: np.ndarray,
    ood_test_dataset: np.ndarray,
    ood_test_labels: np.ndarray,
    nc_activation_layers: List,
    sa_activation_layers: List[int],
    dsa_badge_size: Optional[int] = None,
    batch_size: int = 32,
    group_size: Optional[int] = None,
    device: DeviceLike = None,
    sa_names: Sequence[str] = tuple(SA_VARIANTS),
) -> Dict[int, Tuple[Dict[str, float], Dict[str, int]]]:
    """The grouped study walk: G models per chain dispatch.

    ``params_loader(model_id)`` returns a run's bridged weights;
    ``model_ids`` are scored in groups of ``group_size`` (``TIP_CHAIN_GROUP``
    by default), each by one ``GroupChainRunner``. While group i walks its
    badges, group i+1's weights are already uploading
    (``GroupChainRunner.stage``). Each member's artifacts are the ones
    ``evaluate`` writes on the fused route; surprise adequacy stays per
    member. Returns per model ``(phase seconds, {SA variant: chosen k})``,
    its ``fused_chain`` seconds the group's walk (the next group's loading
    and staging left out) split evenly over its members.
    """
    device = resolve(device)
    g_size = int(group_size or chain_group_size())
    ids = list(model_ids)
    groups = [ids[i : i + g_size] for i in range(0, len(ids), g_size)]
    out = {}
    params = [params_loader(mid) for mid in groups[0]]
    staged = GroupChainRunner.stage(params, g_size, device)
    for gi, group in enumerate(groups):
        cur_params, cur_staged = params, staged
        start = _clock(device)
        if gi + 1 < len(groups):
            # the next group's loading and staging are not this group's
            # walk: the clock restarts after them, without a sync (which
            # would wait for the upload meant to overlap the walk)
            params = [params_loader(mid) for mid in groups[gi + 1]]
            staged = GroupChainRunner.stage(params, g_size, device)
            start = time.perf_counter()
        runner = GroupChainRunner(
            model_def, cur_params, training_dataset, nc_activation_layers,
            batch_size=batch_size, group_size=g_size, staged_params=cur_staged, device=device,
        )
        for ds_type, ds, labels in (
            ("nominal", nominal_test_dataset, nominal_test_labels),
            ("ood", ood_test_dataset, ood_test_labels),
        ):
            results = runner.evaluate_dataset(ds, seeds=group)
            for model_id, result in zip(group, results):
                _persist_chain_result(case_study, ds_type, model_id, labels, result)
        chain_s = (_clock(device) - start) / len(group)
        for model_id, member_params in zip(group, cur_params):
            start = _clock(device)
            chosen_k = _eval_surprise(
                case_study,
                model_def,
                member_params,
                model_id,
                sa_activation_layers,
                nominal_test_dataset,
                ood_test_dataset,
                training_dataset,
                dsa_badge_size,
                device,
                sa_names,
            )
            out[model_id] = (
                {"fused_chain": chain_s, "surprise": _clock(device) - start}, chosen_k
            )
    return out


def _persist_chain_result(case_study, ds_type, model_id, labels, result) -> None:
    """The fused route's artifacts of one (model, dataset) from one runner
    result: the per-phase route's files."""
    is_misclassified = result["pred"] != np.asarray(labels).flatten()
    _persist(case_study, ds_type, "is_misclassified", model_id, is_misclassified)
    _persist_times_multiple_metrics(case_study, ds_type, model_id, result["unc_times"])
    for unc_id, unc in result["uncertainties"].items():
        _persist(case_study, ds_type, f"uncertainty_{unc_id}", model_id, unc)
    _persist_times_multiple_metrics(case_study, ds_type, model_id, result["cov_times"])
    for metric_id, score in result["scores"].items():
        _persist(case_study, ds_type, f"{metric_id}_scores", model_id, score)
    for metric_id, order in result["cam_orders"].items():
        _persist(case_study, ds_type, f"{metric_id}_cam_order", model_id, order)


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
        case_study=case_study,
        model_id=model_id,
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
