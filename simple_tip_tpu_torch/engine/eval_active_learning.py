"""Active-learning phase for one model run (the paper's Table 2).

Counterpart of the JAX package's ``engine/eval_active_learning.py``
``evaluate``, with the same behaviour:

- both test sets are split into an observed and a future part, seeded by
  the run id (the split of sklearn's ``train_test_split``, computed here);
- the original model is scored on all four splits;
- about 80 selections of ``num_selected`` observed rows are built, in this
  order: uncertainty top-k; the 12 neuron-coverage scores' top-k and their
  CAM first-k; the five SA variants' top-k and SC-CAM first-k; the random
  baseline (the first k rows of the shuffled part);
- for each selection, in that order, a fresh model is retrained on the
  training set plus the selection (shuffled with ``RandomState(model_id *
  1000 + i)``, labels one-hot), and scored on all four splits;
- every result is pickled to
  ``active_learning/{cs}_{model}_{metric}_{oodnom}.pickle``.

The selections run on the port's ``BaseModel``, ``CoverageWorker`` and
``SurpriseHandler`` on ``device``. The retrains go through
``batch_training_process`` all at once (``CaseStudy`` passes
``parallel/al_ensemble.py``, which shuffles on the device). The JAX
package's one-by-one route (``_retrain``: shuffle on the host, then one
``training_process`` call a retrain) is not ported: on an H100 it spent
46-58 ms a retrain preparing what the ensemble prepares in 6 ms
(``scripts/torch_al_retrain_routes.py``). Not ported either: the JAX
package's SA fit cache (each SA variant is fitted here anew).
"""

import logging
import math
import os
import pickle
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from simple_tip_tpu_torch.config import subdir
from simple_tip_tpu_torch.device import DeviceLike, resolve, synchronize
from simple_tip_tpu_torch.engine.coverage_handler import CoverageWorker
from simple_tip_tpu_torch.engine.model_handler import BaseModel
from simple_tip_tpu_torch.engine.surprise_handler import SA_VARIANTS, SurpriseHandler

logger = logging.getLogger(__name__)

RANDOM_SPLIT = "random"

SplitDataset = Dict[Tuple[str, str], Tuple[np.ndarray, np.ndarray]]
SplitEvaluation = Dict[Tuple[str, str], float]
MetricSelection = Dict[Tuple[str, str], List[int]]
Scores = Dict[Tuple[str, str], np.ndarray]

NOM = "nominal"
OOD = "ood"
OBS = "observed"
FUT = "future"

BatchTrainingProcess = Callable[
    [List[Tuple[np.ndarray, np.ndarray, int]]], List[Tuple[object, object, List[Dict]]]
]
"""[(x_sel, y_sel, seed)] -> [(model_def, params, epoch records)]: one fresh
model per selection, trained on the training set plus the selection."""

Evaluator = Callable[[object, object, np.ndarray, np.ndarray], float]
"""(model_def, params, x, labels) -> accuracy in [0, 1]."""


class ActiveLearningRun(NamedTuple):
    """What ``evaluate`` measured besides the pickles."""

    seconds: Dict[str, float]
    """Wall seconds of each step: ``original`` (scoring the original
    model), ``fp_selection``, ``nc_selection``, ``sa_selection``,
    ``retrain`` (all retrains) and ``evaluation`` (scoring them)."""
    retrain_epochs: List[List[Dict]]
    """Per selection, in order, its retrain's epoch records."""


def evaluate(
    model_id: int,
    case_study: str,
    model_def,
    params,
    train_x: np.ndarray,
    nominal_test_x: np.ndarray,
    nominal_test_labels: np.ndarray,
    ood_test_x: np.ndarray,
    ood_test_labels: np.ndarray,
    nc_activation_layers: List,
    sa_activation_layers: List[int],
    batch_training_process: BatchTrainingProcess,
    observed_share: float,
    num_selected: int,
    accuracy_fn: Evaluator,
    dsa_badge_size: Optional[int] = None,
    batch_size: int = 128,
    device: DeviceLike = None,
    sa_names: Sequence[str] = tuple(SA_VARIANTS),
) -> ActiveLearningRun:
    """Evaluate the active-learning capabilities of every TIP for one run.

    ``model_def`` is one of the port's models and ``params`` the bridge's
    output for it; ``batch_training_process`` returns (model_def, params)
    of the same kind, which ``accuracy_fn`` scores. ``train_x`` feeds the
    coverage and SA selections. ``device=None`` runs the selections on the
    card and raises without one; ``device="cpu"`` runs the plain versions.
    ``sa_names`` are the SA variants selecting (all five by default).
    """
    device = resolve(device)
    active_datasets = _shuffle_and_split_datasets(
        model_id,
        nominal_test_x,
        nominal_test_labels,
        ood_test_x,
        ood_test_labels,
        observed_share=observed_share,
    )

    smallest_observed = min(
        len(x) for (_, split), (x, _) in active_datasets.items() if split == OBS
    )
    if num_selected > smallest_observed:
        # Smoke-test-sized datasets cannot supply the configured selection
        # size; clamp with a warning instead of tripping the sanity check.
        logger.warning(
            "num_selected=%d exceeds the smallest observed split (%d) — clamping",
            num_selected,
            smallest_observed,
        )
        num_selected = smallest_observed

    phases: Dict[str, float] = {}
    clock = _Clock(device, phases)
    original_model_eval = _evaluate(model_def, params, active_datasets, accuracy_fn)
    clock.lap("original")

    selections: MetricSelection = {}
    fp, _ = _get_fp_selection(model_def, params, active_datasets, num_selected, batch_size, device)
    selections.update(fp)
    clock.lap("fp_selection")
    nc, _ = _get_nc_selection(
        model_def,
        params,
        train_x,
        active_datasets,
        nc_activation_layers,
        num_selected,
        batch_size,
        device,
    )
    selections.update(nc)
    clock.lap("nc_selection")
    sa, _ = _get_sa_selection(
        model_def,
        params,
        train_x,
        active_datasets,
        sa_activation_layers,
        num_selected,
        dsa_badge_size,
        device,
        sa_names,
    )
    selections.update(sa)
    clock.lap("sa_selection")
    selections.update(_get_random_section(active_datasets, num_selected))

    _selection_sanity_checks(num_selected, selections)

    sels = _retrain_inputs(selections, active_datasets, model_id)
    clock.lap(None)
    retrained = batch_training_process(sels)
    clock.lap("retrain")
    active_accuracies = {}
    for key, (new_model_def, new_params, _) in zip(selections, retrained):
        active_accuracies[key] = _evaluate(new_model_def, new_params, active_datasets, accuracy_fn)
    clock.lap("evaluation")

    _save_results_on_file(case_study, model_id, "original", "na", original_model_eval)
    for (metric, ood_or_nom), eval_res in active_accuracies.items():
        _save_results_on_file(case_study, model_id, metric, ood_or_nom, eval_res)
    return ActiveLearningRun(phases, [epochs for _, _, epochs in retrained])


class _Clock:
    """Adds the wall seconds since the last lap (the card's queued work
    finished) to ``phases[name]``; a lap named None is not counted."""

    def __init__(self, device, phases: Dict[str, float]):
        self.device, self.phases = device, phases
        self.last = self._now()

    def _now(self) -> float:
        synchronize(self.device)
        return time.perf_counter()

    def lap(self, name: Optional[str]) -> None:
        now = self._now()
        if name is not None:
            self.phases[name] = self.phases.get(name, 0.0) + now - self.last
        self.last = now


def _save_results_on_file(
    case_study: str, model_id: int, metric: str, ood_or_nom: str, eval_res: SplitEvaluation
) -> None:
    path = os.path.join(
        subdir("active_learning"),
        f"{case_study}_{model_id}_{metric}_{ood_or_nom}.pickle",
    )
    with open(path, "wb") as f:
        pickle.dump(eval_res, f)


def _selection_sanity_checks(num_selected, selections):
    """Raise unless every selection holds ``num_selected`` distinct rows."""
    for (metric, ood_or_nom), selected_idx in selections.items():
        if len(selected_idx) != num_selected:
            raise AssertionError(
                f"The number of selected indexes for {metric}, {ood_or_nom} is not "
                f"correct. Should be {num_selected}, but was {len(selected_idx)}"
            )
        if len(set(np.asarray(selected_idx).tolist())) != num_selected:
            raise AssertionError(
                f"The number of selected indexes for {metric}, {ood_or_nom} is not unique."
            )


def _retrain_inputs(
    selections: MetricSelection, datasets: SplitDataset, model_id: int
) -> List[Tuple[np.ndarray, np.ndarray, int]]:
    """(x, labels, seed) of every selection, in selection order: the
    observed rows it selected, their labels flattened, and the seed
    ``model_id * 1000 + i``."""
    out = []
    for i, ((_, ood_or_nom), rows) in enumerate(selections.items()):
        x, y = datasets[ood_or_nom, OBS]
        labels = np.asarray(y)[rows]
        if labels.shape[0] != labels.size:
            raise ValueError(f"labels must be one per row: {labels.shape}")
        out.append((x[rows], labels.flatten(), model_id * 1000 + i))
    return out


def _get_random_section(dataset: SplitDataset, num_selected: int) -> MetricSelection:
    """Random selection baseline (the arrays are already shuffled)."""
    res: MetricSelection = {}
    for (ood_or_nom, observed_or_future), _ in dataset.items():
        if observed_or_future == OBS:
            res[RANDOM_SPLIT, ood_or_nom] = list(range(num_selected))
    return res


def _get_fp_selection(
    model_def, params, datasets: SplitDataset, num_selected: int, batch_size: int, device
) -> Tuple[MetricSelection, Scores]:
    """Selection by fault-predictor (uncertainty) top-k, and the
    uncertainties it was taken from."""
    res: MetricSelection = {}
    scores: Scores = {}
    base_model = BaseModel(model_def, params, batch_size=batch_size, device=device)
    for (ood_or_nom, observed_or_future), (x, _) in datasets.items():
        if observed_or_future == OBS:
            _, uncertainties, _ = base_model.get_pred_and_uncertainty(x)
            for metric, uncertainty in uncertainties.items():
                res[metric, ood_or_nom] = np.argsort(uncertainty)[-num_selected:]
                scores[metric, ood_or_nom] = uncertainty
    return res, scores


def _get_nc_selection(
    model_def,
    params,
    train_x: np.ndarray,
    datasets: SplitDataset,
    nc_activation_layers: List,
    num_selected: int,
    batch_size: int,
    device,
) -> Tuple[MetricSelection, Scores]:
    """Selection by neuron-coverage score top-k and CAM-first-k, and the
    scores the top-k were taken from."""
    res: MetricSelection = {}
    scores: Scores = {}
    nc_worker = CoverageWorker(
        base_model=BaseModel(
            model_def, params, activation_layers=nc_activation_layers,
            batch_size=batch_size, device=device,
        ),
        training_set=train_x,
    )
    for (ood_or_nom, observed_or_future), (x, _) in datasets.items():
        if observed_or_future == OBS:
            # the second argument names the test set; the JAX package passes
            # num_selected there, as the reference does
            _, all_scores, cam_orders = nc_worker.evaluate_all(x, num_selected)
            for metric, score in all_scores.items():
                res[metric, ood_or_nom] = np.argsort(score)[-num_selected:]
                scores[metric, ood_or_nom] = score
            for metric, cam_order in cam_orders.items():
                res[f"{metric}-cam", ood_or_nom] = cam_order[:num_selected]
    return res, scores


def _get_sa_selection(
    model_def,
    params,
    train_x: np.ndarray,
    datasets: SplitDataset,
    sa_activation_layers: List[int],
    num_selected: int,
    dsa_badge_size: Optional[int],
    device,
    sa_names: Sequence[str] = tuple(SA_VARIANTS),
) -> Tuple[MetricSelection, Scores]:
    """Selection by surprise-adequacy top-k and SC-CAM-first-k, and the
    surprise values the top-k were taken from."""
    res: MetricSelection = {}
    scores: Scores = {}
    sa_worker = SurpriseHandler(
        model_def,
        params,
        sa_layers=sa_activation_layers,
        training_dataset=train_x,
        device=device,
        dsa_badge_size=dsa_badge_size,
        sa_names=sa_names,
    )
    results, _ = sa_worker.evaluate_all(
        datasets={NOM: datasets[NOM, OBS][0], OOD: datasets[OOD, OBS][0]}
    )
    for metric, values in results.items():
        for nom_or_ood, (sa, cam_order, _) in values.items():
            res[metric, nom_or_ood] = np.argsort(sa)[-num_selected:]
            res[f"{metric}-cam", nom_or_ood] = cam_order[:num_selected]
            scores[metric, nom_or_ood] = sa
    return res, scores


def split_indices(n: int, observed_share: float, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(observed, future) row indices of sklearn's ``train_test_split(...,
    test_size=observed_share, random_state=seed)``: its test part is the
    observed one, the first ``ceil(observed_share * n)`` rows of
    ``RandomState(seed).permutation(n)``."""
    perm = np.random.RandomState(seed).permutation(n)
    n_observed = math.ceil(observed_share * n)
    return perm[:n_observed], perm[n_observed:]


def _shuffle_and_split_datasets(
    model_id: int,
    nominal_x: np.ndarray,
    nominal_y: np.ndarray,
    ood_x: np.ndarray,
    ood_y: np.ndarray,
    observed_share: float,
) -> SplitDataset:
    """Shuffle and split both test sets into observed/future, seeded by run id."""
    res: SplitDataset = {}
    for name, x, y in ((NOM, nominal_x, nominal_y), (OOD, ood_x, ood_y)):
        observed, future = split_indices(len(x), observed_share, model_id)
        res[name, OBS] = (x[observed], y[observed])
        res[name, FUT] = (x[future], y[future])
    return res


def _evaluate(
    model_def, params, datasets: SplitDataset, accuracy_fn: Evaluator
) -> SplitEvaluation:
    """Accuracy of the model on all four dataset splits."""
    res: SplitEvaluation = {}
    for (ood_or_nom, observed_or_future), (x, y) in datasets.items():
        acc = accuracy_fn(model_def, params, x, y)
        if not 0 <= acc <= 1:
            raise ValueError(
                f"accuracy_fn returned {acc}, not an accuracy in [0, 1]"
            )
        res[ood_or_nom, observed_or_future] = acc
    return res
