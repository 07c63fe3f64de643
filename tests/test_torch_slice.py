"""The slice end to end: the JAX package's ``eval_prioritization.evaluate``
(per-phase route) and the port's ``evaluate`` write into two temporary
``TIP_ASSETS`` from the same seeded inputs and the same flax parameters.

Every artifact the port writes matches the JAX artifact of the same name:
``is_misclassified``, neuron-coverage scores and every CAM order (the
surprise-coverage one included) byte-equal, with the same dtype and shape;
the point uncertainties to atol 1e-5; DSA scores to rtol 1e-4. MC-dropout
VR draws from torch's generator, so it is held by its dtype, shape and
range only. The JAX side runs only its DSA variant (the port has no other
SA variant yet), with its fit pool and caches off.
"""

import glob
import os
import pickle

import numpy as np
import pytest

from simple_tip_tpu.data import synthetic
from simple_tip_tpu.engine import eval_prioritization as jax_eval
from simple_tip_tpu.engine import surprise_handler as jax_surprise
from simple_tip_tpu.models import MnistConvNet as FlaxMnistConvNet
from simple_tip_tpu_torch.bridge import params_from_jax
from simple_tip_tpu_torch.engine import eval_prioritization
from simple_tip_tpu_torch.models import MnistConvNet
from test_torch_model import flax_params


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    """Artifact roots of one JAX run and one port run on the same inputs."""
    with pytest.MonkeyPatch.context() as monkeypatch:
        yield _run_both(tmp_path_factory.mktemp("slice"), monkeypatch)


def _run_both(tmp_path, monkeypatch):
    for var, value in (
        ("TIP_SA_POOL", "1"),
        ("TIP_SA_CACHE_DIR", "off"),
        ("TIP_COV_STATS_CACHE_DIR", "off"),
        ("TIP_CAM_BACKEND", "auto"),
    ):
        monkeypatch.setenv(var, value)
    monkeypatch.delenv("TIP_FUSED_CHAIN", raising=False)
    monkeypatch.setattr(
        jax_surprise, "SA_VARIANTS", {"dsa": jax_surprise.SA_VARIANTS["dsa"]}
    )
    (x_train, _), (x_test, y_test) = synthetic.image_classification(
        seed=3, n_train=160, n_test=48, shape=(28, 28, 1)
    )
    noise = np.random.default_rng(1).normal(0, 0.3, x_test.shape).astype(np.float32)
    x_ood = np.clip(x_test + noise, 0, 1)
    params = flax_params(4)
    kwargs = dict(
        model_id=0,
        case_study="mnist",
        training_dataset=x_train,
        nominal_test_dataset=x_test,
        nominal_test_labels=y_test,
        ood_test_dataset=x_ood,
        ood_test_labels=y_test,
        nc_activation_layers=[0, 1, 2, 3],
        sa_activation_layers=[3],
        batch_size=128,
    )
    roots = {}
    monkeypatch.setenv("TIP_ASSETS", str(tmp_path / "jax"))
    jax_eval.evaluate(model_def=FlaxMnistConvNet(), params=params, **kwargs)
    roots["jax"] = str(tmp_path / "jax")
    monkeypatch.setenv("TIP_ASSETS", str(tmp_path / "torch"))
    phases = eval_prioritization.evaluate(
        model_def=MnistConvNet(), params=params_from_jax(params), device="cpu", **kwargs
    )
    roots["torch"] = str(tmp_path / "torch")
    return roots, phases


def _names(root: str, sub: str):
    return sorted(os.path.basename(p) for p in glob.glob(os.path.join(root, sub, "*")))


def test_port_artifacts_equal_the_jax_artifacts(both_runs):
    roots, phases = both_runs
    assert sorted(phases) == ["fault_predictors", "neuron_coverage", "surprise"]
    names = _names(roots["torch"], "priorities")
    # 2 datasets x (mask + 5 uncertainties + 12 x (scores, order) + dsa x 2)
    assert len(names) == 64
    assert set(names) <= set(_names(roots["jax"], "priorities"))
    for name in names:
        got = np.load(os.path.join(roots["torch"], "priorities", name))
        want = np.load(os.path.join(roots["jax"], "priorities", name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        kind = name.split("_0_", 1)[1][: -len(".npy")]
        if kind == "uncertainty_VR":
            assert got.min() >= 0 and got.max() <= 0.9, name
        elif kind.startswith("uncertainty_"):
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=name)
        elif kind == "dsa_scores":
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=0, err_msg=name)
        else:  # is_misclassified, NC scores, every CAM order
            assert got.tobytes() == want.tobytes(), name
        if kind.endswith("cam_order"):
            assert sorted(got.tolist()) == list(range(got.shape[0])), name


def test_port_time_records_follow_the_contract(both_runs):
    roots, _ = both_runs
    names = _names(roots["torch"], "times")
    assert names == _names(roots["jax"], "times")
    assert len(names) == 2 * (5 + 12 + 1)
    for name in names:
        with open(os.path.join(roots["torch"], "times", name), "rb") as f:
            record = pickle.load(f)
        assert len(record) == 4 and all(float(v) >= 0 for v in record), name

