"""Case studies of the port: per-run training, checkpoints and ``test_prio``.

Counterpart of the JAX package's ``casestudies/base.py`` ``CaseStudy``:

- checkpoints are flax msgpack blobs under
  ``$TIP_ASSETS/models/{cs}/{id}.msgpack``, written and read by the port's
  own codec (``utils/checkpoint.py``) byte for byte as flax does, so either
  package scores the other's runs; existing runs are reused, not retrained;
- ``train`` trains the missing runs through one ``train_ensemble`` (one
  card, members in turn);
- ``run_prio_eval`` runs ``engine/eval_prioritization.evaluate`` per run,
  or, with ``TIP_FUSED_CHAIN`` on and ``TIP_CHAIN_GROUP`` above 1,
  ``evaluate_group`` over groups of G runs;
- ``run_active_learning_eval`` runs ``engine/eval_active_learning.evaluate``
  per run, its retrains through ``parallel/al_ensemble.py``;
- ``collect_activations`` dumps every tap (``engine/activation_persistor.py``,
  the ``at_collection`` phase);
- with ``num_workers`` above 1 those three phases fan their runs out over
  worker processes (``parallel/run_scheduler.py``, ``_dispatch_workers``):
  each worker resolves the study by name with ``get_case_study``, runs on
  the card (``default``), or on the CPU (``cpu``) only where
  ``device="cpu"`` or ``TIP_WORKER_PLATFORMS`` asks for it, under this
  process's cuDNN flags; with ``TIP_CHAIN_GROUP`` G above 1 a
  work unit is a group of G runs.

A spec's ``loader(device=...)`` returns the three (x, y) pairs; each phase
passes it the phase's device, on which the image loaders generate a
missing corruption cache. ``CASE_STUDIES`` is the paper's registry (mnist,
fmnist, cifar10, imdb), field for field the JAX package's; ``get_case_study``
resolves it, then the mini studies (``casestudies/mini.py``), then the
``TIP_CASE_STUDY_PROVIDER`` hook.

The scoring forwards may run in bfloat16, as in the JAX package:
``TIP_COMPUTE_DTYPE=bfloat16`` (``config.scoring_compute_dtype``; any value
but float32 / bfloat16 raises ``ValueError``) makes ``scoring_model_def``
the model in the bf16 scoring mode, which scores ``test_prio`` (per run and
grouped) and the active-learning selections and the original model's
accuracy there. Training, the retrains and their accuracy, and
``at_collection`` stay float32 (``model_def``). Worker processes inherit
the variable.
"""

import importlib
import logging
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from simple_tip_tpu_torch.bridge import params_from_jax, params_to_jax
from simple_tip_tpu_torch.config import scoring_compute_dtype, subdir
from simple_tip_tpu_torch.data import load_cifar10, load_fmnist, load_imdb, load_mnist
from simple_tip_tpu_torch.device import DeviceLike, resolve
from simple_tip_tpu_torch.engine import (
    activation_persistor,
    eval_active_learning,
    eval_prioritization,
)
from simple_tip_tpu_torch.engine.run_program import chain_group_size, fused_chain_enabled
from simple_tip_tpu_torch.models import Cifar10ConvNet, ImdbTransformer, MnistConvNet
from simple_tip_tpu_torch.models.train import TrainConfig, accuracy
from simple_tip_tpu_torch.parallel.al_ensemble import al_retrain_ensemble
from simple_tip_tpu_torch.parallel.ensemble import train_ensemble, unstack
from simple_tip_tpu_torch.utils import checkpoint

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class CaseStudySpec:
    """Declarative configuration of one case study (hyperparameter
    registry); ``loader(device=...)`` returns the three (x, y) pairs."""

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
        # The scoring forwards may run in bf16 (TIP_COMPUTE_DTYPE); training
        # always stays float32, so checkpoints are unaffected.
        dtype = scoring_compute_dtype()
        self.scoring_model_def = (
            spec.model_factory(compute_dtype=dtype) if dtype else self.model_def
        )

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
        (x_train, y_train), _, _ = self.spec.loader(device=device)
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

    def _dispatch_workers(self, phase: str, model_ids: List[int], num_workers: int,
                          device: DeviceLike, group_size: int = 1) -> None:
        """Fan the phase out over ``num_workers`` worker processes
        (``parallel/run_scheduler.run_phase_parallel``).

        ``device="cpu"`` makes every worker a CPU worker. Otherwise every
        worker runs on the card (one card serves several processes), or
        where ``TIP_WORKER_PLATFORMS`` is set, on the platforms it names:
        that and ``device="cpu"`` are the only ways onto the CPU. A
        placement with a card worker counts the cards in a subprocess
        (``probe_local_chips``: this process opens no CUDA context before
        it spawns card workers) and raises ``BackendUnavailable`` when none
        answers. Each worker runs under this process's cuDNN flags
        (``device.backend_flags``)."""
        from simple_tip_tpu_torch.device import backend_flags
        from simple_tip_tpu_torch.parallel.run_scheduler import (
            default_worker_platforms,
            run_phase_parallel,
        )
        from simple_tip_tpu_torch.resilience import BackendUnavailable
        from simple_tip_tpu_torch.utils.device_watchdog import probe_local_chips

        if device is not None and torch.device(device).type == "cpu":
            platforms = ["cpu"] * num_workers
        elif os.environ.get("TIP_WORKER_PLATFORMS", "").strip():
            platforms = default_worker_platforms(num_workers, 0)  # the override's cycle
        else:
            platforms = ["default"] * num_workers
        if "default" in platforms and probe_local_chips() == 0:
            raise BackendUnavailable(
                f"{phase}: no CUDA card answered the probe for the worker "
                "processes; pass device='cpu' (--device cpu) to run them on the CPU"
            )
        run_phase_parallel(
            self.spec.name,
            phase,
            list(model_ids),
            num_workers,
            worker_platforms=platforms,
            group_size=group_size,
            backend_flags=backend_flags(),
        )

    def run_prio_eval(self, model_ids: List[int], device: DeviceLike = None,
                      num_workers: int = 1) -> Optional[Dict[int, tuple]]:
        """Run the test-prioritization phase for the requested runs; returns
        each run's ``(phase seconds, {SA variant: the k it chose})``. With the
        fused chain on and ``TIP_CHAIN_GROUP`` G above 1, the runs are scored
        in groups of G (``eval_prioritization.evaluate_group``; the same
        artifacts as the per-model walk). With ``num_workers`` above 1 (and
        more than one run) the runs go to worker processes, a unit a run or
        a group of G, and nothing is returned: the artifacts are the
        result."""
        group_size = chain_group_size() if fused_chain_enabled() else 1
        if num_workers > 1 and len(model_ids) > 1:
            self._dispatch_workers("test_prio", model_ids, num_workers, device,
                                   group_size=group_size)
            return None
        device = resolve(device)
        (x_train, _), (x_test, y_test), (ood_x, ood_y) = self.spec.loader(device=device)
        if group_size > 1 and len(model_ids) > 1:
            logger.info("[%s] grouped prioritization eval for runs %s (G=%d)",
                        self.spec.name, list(model_ids), group_size)
            return eval_prioritization.evaluate_group(
                model_ids=list(model_ids),
                case_study=self.spec.name,
                model_def=self.scoring_model_def,
                params_loader=lambda model_id: params_from_jax(self.load_params(model_id)),
                training_dataset=x_train,
                nominal_test_dataset=x_test,
                nominal_test_labels=y_test,
                ood_test_dataset=ood_x,
                ood_test_labels=ood_y,
                nc_activation_layers=list(self.spec.nc_activation_layers),
                sa_activation_layers=list(self.spec.sa_activation_layers),
                dsa_badge_size=self.spec.dsa_badge_size,
                batch_size=self.spec.prediction_badge_size,
                group_size=group_size,
                device=device,
            )
        phases = {}
        for model_id in model_ids:
            params = params_from_jax(self.load_params(model_id))
            logger.info("[%s] prioritization eval for run %d", self.spec.name, model_id)
            phases[model_id] = eval_prioritization.evaluate(
                model_id=model_id,
                case_study=self.spec.name,
                model_def=self.scoring_model_def,
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
        self, model_ids: List[int], device: DeviceLike = None, num_workers: int = 1
    ) -> Optional[Dict[int, eval_active_learning.ActiveLearningRun]]:
        """Run the active-learning phase for the requested runs; returns
        each run's step seconds and retrain epochs
        (``eval_active_learning.evaluate``). Each run's ~80 retrains train
        through ``al_retrain_ensemble``: one copy of the training set on the
        device, each retrain's rows gathered there. With ``num_workers``
        above 1 the runs go to worker processes and nothing is returned."""
        if num_workers > 1 and len(model_ids) > 1:
            self._dispatch_workers("active_learning", model_ids, num_workers, device)
            return None
        device = resolve(device)
        (x_train, y_train), (x_test, y_test), (ood_x, ood_y) = self.spec.loader(device=device)
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
                model_def=self.scoring_model_def,
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

    def collect_activations(self, model_ids: List[int], device: DeviceLike = None,
                            num_workers: int = 1) -> None:
        """Dump every tap of the requested runs (the at_collection phase),
        over worker processes when ``num_workers`` is above 1."""
        if num_workers > 1 and len(model_ids) > 1:
            self._dispatch_workers("at_collection", model_ids, num_workers, device)
            return
        device = resolve(device)
        (x_train, y_train), (x_test, y_test), (ood_x, ood_y) = self.spec.loader(device=device)
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


# ---------------------------------------------------------------------------
# Registry (the JAX package's ``CASE_STUDIES``: the reference's hyperparameters)
# ---------------------------------------------------------------------------

CASE_STUDIES = {
    "mnist": CaseStudySpec(
        name="mnist",
        model_factory=MnistConvNet,
        loader=load_mnist,
        train_cfg=TrainConfig(batch_size=128, epochs=15, validation_split=0.1),
        nc_activation_layers=(0, 1, 2, 3),
        sa_activation_layers=(3,),
        prediction_badge_size=128,
        num_classes=10,
        al_num_selected=1000,
    ),
    "fmnist": CaseStudySpec(
        name="fmnist",
        model_factory=MnistConvNet,
        loader=load_fmnist,
        train_cfg=TrainConfig(batch_size=128, epochs=15, validation_split=0.1),
        nc_activation_layers=(0, 1, 2, 3),
        sa_activation_layers=(3,),
        prediction_badge_size=128,
        num_classes=10,
        al_num_selected=1000,
    ),
    "cifar10": CaseStudySpec(
        name="cifar10",
        model_factory=Cifar10ConvNet,
        loader=load_cifar10,
        train_cfg=TrainConfig(batch_size=32, epochs=20, validation_split=0.1),
        nc_activation_layers=(0, 1, 2, 3),
        sa_activation_layers=(3,),
        prediction_badge_size=32,
        num_classes=10,
        al_num_selected=1000,
    ),
    "imdb": CaseStudySpec(
        name="imdb",
        model_factory=ImdbTransformer,
        loader=load_imdb,
        train_cfg=TrainConfig(batch_size=32, epochs=10, validation_split=0.1),
        # The reference's tuple-form tap entries are ignored there; the
        # effective taps are (3, 5).
        nc_activation_layers=(3, 5),
        sa_activation_layers=(5,),
        prediction_badge_size=600,
        num_classes=2,
        al_num_selected=2500,
        dsa_badge_size=500,
    ),
}


def get_case_study(name: str) -> CaseStudy:
    """Look up a case study by name: the paper registry, then the mini
    studies, then the ``TIP_CASE_STUDY_PROVIDER`` hook (``module:function``,
    which receives the name and returns a ``CaseStudy`` or None)."""
    from simple_tip_tpu_torch.casestudies import mini

    if name in CASE_STUDIES:
        return CaseStudy(CASE_STUDIES[name])
    found = mini.provide(name)
    if found is not None:
        return found
    provider = os.environ.get("TIP_CASE_STUDY_PROVIDER", "").strip()
    if provider:
        mod_name, _, attr = provider.partition(":")
        found = getattr(importlib.import_module(mod_name), attr)(name)
        if found is not None:
            return found
    raise KeyError(
        f"unknown case study {name!r} (registry: {sorted(CASE_STUDIES)}; mini studies: "
        f"{sorted(mini.MINI_CASE_STUDIES)}; set TIP_CASE_STUDY_PROVIDER=module:function "
        "for custom ones)"
    )
