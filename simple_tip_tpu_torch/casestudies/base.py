"""Case studies of the port: per-run training, checkpoints and ``test_prio``.

Counterpart of the JAX package's ``casestudies/base.py`` ``CaseStudy``:

- checkpoints are flax msgpack blobs under
  ``$TIP_ASSETS/models/{cs}/{id}.msgpack``, written and read by the port's
  own codec (``utils/checkpoint.py``) byte for byte as flax does, so either
  package scores the other's runs; existing runs are reused, not retrained;
- ``train`` trains the missing runs through one ``train_ensemble`` (one
  card, members in turn);
- ``run_prio_eval`` runs ``engine/eval_prioritization.evaluate`` per run
  (the per-phase route: no worker processes, no grouped chain yet);
- ``run_active_learning_eval`` runs ``engine/eval_active_learning.evaluate``
  per run, its retrains through ``parallel/al_ensemble.py``;
- ``collect_activations`` dumps every tap (``engine/activation_persistor.py``,
  the ``at_collection`` phase).

The paper registry (mnist, fmnist, cifar10, imdb) needs ``data/loaders.py``
and the corruption generators, which the port does not have yet;
``get_case_study`` resolves the mini studies (``casestudies/mini.py``) and
the ``TIP_CASE_STUDY_PROVIDER`` hook.
"""

import importlib
import logging
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from simple_tip_tpu_torch.bridge import params_from_jax, params_to_jax
from simple_tip_tpu_torch.config import subdir
from simple_tip_tpu_torch.device import DeviceLike, resolve
from simple_tip_tpu_torch.engine import (
    activation_persistor,
    eval_active_learning,
    eval_prioritization,
)
from simple_tip_tpu_torch.models.train import TrainConfig, accuracy
from simple_tip_tpu_torch.parallel.al_ensemble import al_retrain_ensemble
from simple_tip_tpu_torch.parallel.ensemble import train_ensemble, unstack
from simple_tip_tpu_torch.utils import checkpoint

logger = logging.getLogger(__name__)

PAPER_STUDIES = ("mnist", "fmnist", "cifar10", "imdb")


@dataclass(frozen=True)
class CaseStudySpec:
    """Declarative configuration of one case study (hyperparameter registry)."""

    name: str
    model_factory: Callable
    loader: Callable
    train_cfg: TrainConfig
    nc_activation_layers: Tuple
    sa_activation_layers: Tuple
    prediction_badge_size: int
    num_classes: int
    al_observed_share: float = 0.5
    al_num_selected: int = 1000
    dsa_badge_size: Optional[int] = None


def _same_layout(tree: Dict, template: Dict, path: str = "") -> None:
    """Raise unless ``tree`` has ``template``'s keys and leaf shapes."""
    if set(tree) != set(template):
        raise ValueError(f"checkpoint keys {sorted(tree)} at {path or '/'} want {sorted(template)}")
    for key, want in template.items():
        got = tree[key]
        if isinstance(want, dict):
            _same_layout(got, want, f"{path}/{key}")
        elif np.shape(got) != np.shape(want) or got.dtype != want.dtype:
            raise ValueError(f"checkpoint leaf {path}/{key}: {got.dtype}{np.shape(got)}, "
                             f"want {want.dtype}{np.shape(want)}")


class CaseStudy:
    """Runs training and the experiment phases for one case study."""

    def __init__(self, spec: CaseStudySpec):
        self.spec = spec
        self.model_def = spec.model_factory()

    # -- checkpointing -------------------------------------------------------

    def model_path(self, model_id: int) -> str:
        """Checkpoint path of one run's parameters."""
        return os.path.join(subdir(os.path.join("models", self.spec.name)), f"{model_id}.msgpack")

    def has_model(self, model_id: int) -> bool:
        """Whether run ``model_id`` has a persisted checkpoint."""
        return os.path.exists(self.model_path(model_id))

    def save_params(self, model_id: int, params: Dict) -> None:
        """Persist one run's flax-layout tree."""
        checkpoint.save(self.model_path(model_id), params)

    def load_params(self, model_id: int) -> Dict:
        """One run's flax-layout tree, checked against the model's layout."""
        params = checkpoint.load(self.model_path(model_id))
        _same_layout(params, params_to_jax(self.model_def.family, self.model_def))
        return params

    # -- phases --------------------------------------------------------------

    def train(self, model_ids: List[int], device: DeviceLike = None) -> Dict[int, List[Dict]]:
        """Train the requested runs that have no checkpoint yet, each from
        its id as seed. Returns the per-epoch records of the runs trained
        (none if all existed)."""
        todo = [m for m in model_ids if not self.has_model(m)]
        if not todo:
            logger.info("[%s] all %d requested models exist", self.spec.name, len(model_ids))
            return {}
        device = resolve(device)
        (x_train, y_train), _, _ = self.spec.loader()
        y_onehot = np.eye(self.spec.num_classes, dtype=np.float32)[
            np.asarray(y_train).astype(np.int64).flatten()
        ]
        logger.info("[%s] training runs %s", self.spec.name, todo)
        histories: Dict[int, List[Dict]] = {}
        stacked = train_ensemble(self.model_def, x_train, y_onehot, self.spec.train_cfg,
                                 seeds=todo, device=device, histories=histories)
        for i, model_id in enumerate(todo):
            self.save_params(model_id, unstack(stacked, i))
        return histories

    def run_prio_eval(self, model_ids: List[int], device: DeviceLike = None) -> Dict[int, Dict]:
        """Run the test-prioritization phase for the requested runs; returns
        each run's phase seconds."""
        device = resolve(device)
        (x_train, _), (x_test, y_test), (ood_x, ood_y) = self.spec.loader()
        phases = {}
        for model_id in model_ids:
            params = params_from_jax(self.load_params(model_id))
            logger.info("[%s] prioritization eval for run %d", self.spec.name, model_id)
            phases[model_id], _ = eval_prioritization.evaluate(
                model_id=model_id,
                case_study=self.spec.name,
                model_def=self.model_def,
                params=params,
                training_dataset=x_train,
                nominal_test_dataset=x_test,
                nominal_test_labels=y_test,
                ood_test_dataset=ood_x,
                ood_test_labels=ood_y,
                nc_activation_layers=list(self.spec.nc_activation_layers),
                sa_activation_layers=list(self.spec.sa_activation_layers),
                dsa_badge_size=self.spec.dsa_badge_size,
                batch_size=self.spec.prediction_badge_size,
                device=device,
            )
        return phases

    def run_active_learning_eval(
        self, model_ids: List[int], device: DeviceLike = None
    ) -> Dict[int, eval_active_learning.ActiveLearningRun]:
        """Run the active-learning phase for the requested runs; returns
        each run's step seconds and retrain epochs
        (``eval_active_learning.evaluate``). Each run's ~80 retrains train
        through ``al_retrain_ensemble``: one copy of the training set on the
        device, each retrain's rows gathered there."""
        device = resolve(device)
        (x_train, y_train), (x_test, y_test), (ood_x, ood_y) = self.spec.loader()
        eye = np.eye(self.spec.num_classes, dtype=np.float32)
        train_y_onehot = eye[np.asarray(y_train).astype(np.int64).flatten()]

        def batch_training_process(sels):
            prepared = [(x, eye[y.astype(np.int64)], seed) for (x, y, seed) in sels]
            trained = al_retrain_ensemble(self.model_def, self.spec.train_cfg, x_train,
                                          train_y_onehot, prepared, device)
            return [(self.model_def, params_from_jax(tree), epochs) for tree, epochs in trained]

        def accuracy_fn(model_def, params, x, labels):
            return accuracy(model_def, params, x, labels, device)

        runs = {}
        for model_id in model_ids:
            params = params_from_jax(self.load_params(model_id))
            logger.info("[%s] active-learning eval for run %d", self.spec.name, model_id)
            runs[model_id] = eval_active_learning.evaluate(
                model_id=model_id,
                case_study=self.spec.name,
                model_def=self.model_def,
                params=params,
                train_x=x_train,
                nominal_test_x=x_test,
                nominal_test_labels=y_test,
                ood_test_x=ood_x,
                ood_test_labels=ood_y,
                nc_activation_layers=list(self.spec.nc_activation_layers),
                sa_activation_layers=list(self.spec.sa_activation_layers),
                batch_training_process=batch_training_process,
                observed_share=self.spec.al_observed_share,
                num_selected=self.spec.al_num_selected,
                accuracy_fn=accuracy_fn,
                dsa_badge_size=self.spec.dsa_badge_size,
                batch_size=self.spec.prediction_badge_size,
                device=device,
            )
        return runs

    def collect_activations(self, model_ids: List[int], device: DeviceLike = None) -> None:
        """Dump every tap of the requested runs (the at_collection phase)."""
        device = resolve(device)
        (x_train, y_train), (x_test, y_test), (ood_x, ood_y) = self.spec.loader()
        for model_id in model_ids:
            activation_persistor.persist(
                model_def=self.model_def,
                params=params_from_jax(self.load_params(model_id)),
                case_study=self.spec.name,
                model_id=model_id,
                train_set=(x_train, y_train),
                test_nominal=(x_test, y_test),
                test_corrupted=(ood_x, ood_y),
                device=device,
            )


def get_case_study(name: str) -> CaseStudy:
    """Look up a case study by name: the mini studies, then the
    ``TIP_CASE_STUDY_PROVIDER`` hook (``module:function``, which receives
    the name and returns a ``CaseStudy`` or None)."""
    from simple_tip_tpu_torch.casestudies import mini

    found = mini.provide(name)
    if found is not None:
        return found
    provider = os.environ.get("TIP_CASE_STUDY_PROVIDER", "").strip()
    if provider:
        mod_name, _, attr = provider.partition(":")
        found = getattr(importlib.import_module(mod_name), attr)(name)
        if found is not None:
            return found
    if name in PAPER_STUDIES:
        raise KeyError(
            f"case study {name!r} needs the port of data/loaders.py and the "
            "corruption generators (data/image_corruptor.py), which the port "
            "does not have yet; the mini studies and TIP_CASE_STUDY_PROVIDER work"
        )
    raise KeyError(
        f"unknown case study {name!r} (mini studies: {sorted(mini.MINI_CASE_STUDIES)}; "
        "set TIP_CASE_STUDY_PROVIDER=module:function for custom ones)"
    )
