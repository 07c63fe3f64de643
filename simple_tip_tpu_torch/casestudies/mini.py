"""Reduced-scale case studies (the JAX package's ``casestudies/mini.py``).

``mini-mnist`` and ``mini-cifar10`` keep every structural property the
evaluation layer depends on (10 classes, the dropout and no-dropout model
families, nominal and corrupted-OOD test sets, the same taps and artifact
contract) at 600 training and 300 test images of ``data/synthetic.py``,
whose seeds give the JAX package's arrays. ``provide`` resolves them by
name for ``get_case_study`` and the ``TIP_CASE_STUDY_PROVIDER`` hook.
"""

from typing import Optional

import numpy as np

from simple_tip_tpu_torch.casestudies.base import CaseStudy, CaseStudySpec
from simple_tip_tpu_torch.data import synthetic
from simple_tip_tpu_torch.models import Cifar10ConvNet, MnistConvNet
from simple_tip_tpu_torch.models.train import TrainConfig

N_TRAIN = 600
N_TEST = 300


def image_loader(shape, seed: int, n_train: int = N_TRAIN, n_test: int = N_TEST):
    """A loader of ``((x_train, y_train), (x_test, y_test), (ood_x, ood_y))``:
    the OOD set is the nominal set and its corrupted copy, shuffled. Its
    ``device`` is unused (the stand-ins are made with numpy)."""

    def loader(device=None):
        (x_train, y_train), (x_test, y_test) = synthetic.image_classification(
            seed=seed, n_train=n_train, n_test=n_test, shape=shape, num_classes=10
        )
        x_corr = synthetic.corrupt_images(x_test, seed=seed + 1, severity=0.6)
        ood_x = np.concatenate([x_test, x_corr])
        ood_y = np.concatenate([y_test, y_test])
        perm = np.random.default_rng(0).permutation(len(ood_y))
        return (x_train, y_train), (x_test, y_test), (ood_x[perm], ood_y[perm])

    return loader


MINI_CASE_STUDIES = {
    "mini-mnist": CaseStudySpec(
        name="mini-mnist",
        model_factory=MnistConvNet,
        loader=image_loader((28, 28, 1), seed=41),
        train_cfg=TrainConfig(batch_size=64, epochs=3, learning_rate=2e-3, validation_split=0.1),
        nc_activation_layers=(0, 1, 2, 3),
        sa_activation_layers=(3,),
        prediction_badge_size=128,
        num_classes=10,
        al_num_selected=48,
    ),
    "mini-cifar10": CaseStudySpec(
        name="mini-cifar10",
        model_factory=Cifar10ConvNet,  # no dropout: VR intentionally absent
        loader=image_loader((32, 32, 3), seed=43),
        train_cfg=TrainConfig(batch_size=64, epochs=3, learning_rate=2e-3, validation_split=0.1),
        nc_activation_layers=(0, 1, 2, 3),
        sa_activation_layers=(3,),
        prediction_badge_size=128,
        num_classes=10,
        al_num_selected=48,
    ),
}


def provide(name: str) -> Optional[CaseStudy]:
    """TIP_CASE_STUDY_PROVIDER hook: resolve the mini case studies by name."""
    spec = MINI_CASE_STUDIES.get(name)
    return CaseStudy(spec) if spec is not None else None
