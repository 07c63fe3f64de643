"""Case-study provider for the run-scheduler tests of the port (no tests here).

The scheduler's spawned workers rebuild a case study by name through
``TIP_CASE_STUDY_PROVIDER=test_torch_sched_provider:provide``, so the study
lives in an importable module; it imports torch and the port only (never
jax). ``sched-mnist`` is the MNIST convnet at full width on 200 training
and 48 test images of ``data/synthetic.py`` (96 OOD rows), scored with DSA
as its only SA variant, as ``tests/test_torch_registry_cli.py`` cuts the
registry's study. In a worker process (``TIP_OBS_WORKER`` set) each
``run_prio_eval`` also records which modules of ``FORBIDDEN_TOPS`` the
worker has imported, under ``$TIP_ASSETS/worker_modules``.
"""

import functools
import json
import os
import sys

from simple_tip_tpu_torch.casestudies.base import CaseStudy, CaseStudySpec
from simple_tip_tpu_torch.casestudies.mini import image_loader
from simple_tip_tpu_torch.engine import eval_prioritization
from simple_tip_tpu_torch.models import MnistConvNet
from simple_tip_tpu_torch.models.train import TrainConfig

NAME = "sched-mnist"
N_TRAIN, N_TEST = 200, 48
FORBIDDEN_TOPS = ("jax", "jaxlib", "flax", "optax", "simple_tip_tpu")

SPEC = CaseStudySpec(
    name=NAME,
    model_factory=MnistConvNet,
    loader=image_loader((28, 28, 1), seed=41, n_train=N_TRAIN, n_test=N_TEST),
    train_cfg=TrainConfig(batch_size=64, epochs=1, learning_rate=2e-3, validation_split=0.1),
    nc_activation_layers=(0, 1, 2, 3),
    sa_activation_layers=(3,),
    prediction_badge_size=64,
    num_classes=10,
    al_num_selected=8,
)


def forbidden_modules() -> list:
    """The imported modules whose top-level package is in ``FORBIDDEN_TOPS``."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN_TOPS)


class DsaOnlyStudy(CaseStudy):
    """``CaseStudy`` whose prioritization phase fits DSA only."""

    def run_prio_eval(self, model_ids, device=None, num_workers=1):
        worker = os.environ.get("TIP_OBS_WORKER", "").strip()
        if worker:
            folder = os.path.join(os.environ["TIP_ASSETS"], "worker_modules")
            os.makedirs(folder, exist_ok=True)
            with open(os.path.join(folder, f"{os.getpid()}.json"), "w") as f:
                json.dump({"ids": list(model_ids), "forbidden": forbidden_modules(),
                           "platform": os.environ.get("TIP_OBS_PLATFORM")}, f)
        evaluate = eval_prioritization.evaluate
        eval_prioritization.evaluate = functools.partial(evaluate, sa_names=("dsa",))
        try:
            return super().run_prio_eval(model_ids, device=device, num_workers=num_workers)
        finally:
            eval_prioritization.evaluate = evaluate


def provide(name: str):
    """``TIP_CASE_STUDY_PROVIDER`` hook: the ``sched-mnist`` study."""
    return DsaOnlyStudy(SPEC) if name == NAME else None
