"""The slice end to end, per model family: the JAX package's
``eval_prioritization.evaluate`` (per-phase route) and the port's
``evaluate`` write into two temporary ``TIP_ASSETS`` from the same seeded
inputs and the same flax parameters.

Every artifact the port writes matches the JAX artifact of the same name:
``is_misclassified``, neuron-coverage scores and every CAM order (the
surprise-coverage one included) byte-equal, with the same dtype and shape;
the point uncertainties to atol 1e-5; DSA scores to rtol 1e-4. MC-dropout
VR draws from torch's generator, so it is held by its dtype, shape and
range only; CIFAR-10 has no dropout and writes no VR on either side. In
these runs both sides run only their DSA variant, at the full-width SA tap;
the JAX side has its fit pool and caches off; the IMDB JAX model runs its
default dense attention core.

The five SA variants are held to the JAX package (``TIP_CLUSTER_BACKEND=jax``,
its estimators on a device) by both packages' ``_eval_surprise``, the SA step
of ``evaluate``, at each family's narrowest tap, since pc-mlsa's EM at 1,600
features takes minutes on the CPU: IMDB's layer 5 (20 features), CIFAR-10's
dense layer (tap 6, 64 features) and MNIST's softmax (tap 6, 10 features).
Scores within rtol 1e-4 with the same +inf rows, and SC-CAM orders
byte-equal wherever every row's score is held (a row within that tolerance
of a bucket edge could move one; none does at these inputs). A covariance fitted on fewer rows than
it has live (non-constant) features is singular, and the float32 rounding
noise of its null space lies above the float64 cut-off of ``pinvh``: MDSA's
scores there are rounding noise in either package. So pc-mdsa is held on
the rows whose predicted class has more training rows than live features,
and CIFAR-10's pc-mmdsa, some of whose clusters are that small (its clusters
are not seen from here), by its +inf rows, dtype and shape; IMDB holds all
five. On MNIST's softmax the traces sum to 1, which makes every such
covariance singular (the KDE's too): there pc-lsa, pc-mdsa and pc-mmdsa are
held by their +inf rows, dtype and shape only, and so is dsa, whose JAX
version expands d^2 uncentred in float32 and is off by up to 8e-4 relative
on these near-identical rows (the DSA runs above hold it at the full-width
tap). ``tests/test_torch_sa_variants.py`` holds every variant on well-posed
inputs.
"""

import glob
import os
import pickle

import numpy as np
import pytest

from simple_tip_tpu.data import synthetic
from simple_tip_tpu.engine import eval_prioritization as jax_eval
from simple_tip_tpu.engine import surprise_handler as jax_surprise
from simple_tip_tpu.models import Cifar10ConvNet as FlaxCifar10ConvNet
from simple_tip_tpu.models import ImdbTransformer as FlaxImdbTransformer
from simple_tip_tpu.models import MnistConvNet as FlaxMnistConvNet
from simple_tip_tpu.ops import surprise as jax_sa
from simple_tip_tpu_torch.bridge import params_from_jax
from simple_tip_tpu_torch.engine import eval_prioritization
from simple_tip_tpu_torch.engine.model_handler import BaseModel
from simple_tip_tpu_torch.models import Cifar10ConvNet, ImdbTransformer, MnistConvNet
from test_torch_cifar import cifar_flax_params
from test_torch_model import flax_params
from test_torch_transformer import imdb_flax_params
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

# family: (flax model, port model, params, NC taps, SA taps, DSA badge,
#          priority files, time records, VR upper bound)
FAMILIES = {
    # 2 datasets x (mask + 5 uncertainties + 12 x (scores, order) + dsa x 2)
    "mnist": (FlaxMnistConvNet, MnistConvNet, lambda: flax_params(4), [0, 1, 2, 3], [3], None,
              64, 2 * (5 + 12 + 1), 0.9),
    # no VR: 4 uncertainties
    "cifar10": (FlaxCifar10ConvNet, Cifar10ConvNet, lambda: cifar_flax_params(4), [0, 1, 2, 3],
                [3], None, 62, 2 * (4 + 12 + 1), None),
    "imdb": (FlaxImdbTransformer, ImdbTransformer, lambda: imdb_flax_params(4), [3, 5], [5], 20,
             64, 2 * (5 + 12 + 1), 0.5),
}


def _data(family: str):
    """(train x, nominal x, nominal y, ood x) from the JAX package's generators."""
    if family == "imdb":
        (x_train, _), (x_test, y_test) = synthetic.token_classification(
            seed=3, n_train=160, n_test=48
        )
        return x_train, x_test, y_test, synthetic.corrupt_tokens(x_test, seed=1)
    shape = (28, 28, 1) if family == "mnist" else (32, 32, 3)
    (x_train, _), (x_test, y_test) = synthetic.image_classification(
        seed=3, n_train=160, n_test=48, shape=shape
    )
    noise = np.random.default_rng(1).normal(0, 0.3, x_test.shape).astype(np.float32)
    return x_train, x_test, y_test, np.clip(x_test + noise, 0, 1)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def both_runs(request, tmp_path_factory):
    """Artifact roots of one JAX run and one port run on the same inputs."""
    with pytest.MonkeyPatch.context() as monkeypatch:
        tmp = tmp_path_factory.mktemp(f"slice_{request.param}")
        runs = _run_both(request.param, tmp, monkeypatch)
    yield request.param, runs


def _run_both(family, tmp_path, monkeypatch):
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
    flax_model, port_model, make_params, nc_layers, sa_layers, dsa_badge = FAMILIES[family][:6]
    x_train, x_test, y_test, x_ood = _data(family)
    params = make_params()
    kwargs = dict(
        model_id=0,
        case_study=family,
        training_dataset=x_train,
        nominal_test_dataset=x_test,
        nominal_test_labels=y_test,
        ood_test_dataset=x_ood,
        ood_test_labels=y_test,
        nc_activation_layers=nc_layers,
        sa_activation_layers=sa_layers,
        dsa_badge_size=dsa_badge,
        batch_size=128,
    )
    roots = {}
    monkeypatch.setenv("TIP_ASSETS", str(tmp_path / "jax"))
    jax_eval.evaluate(model_def=flax_model(), params=params, **kwargs)
    roots["jax"] = str(tmp_path / "jax")
    monkeypatch.setenv("TIP_ASSETS", str(tmp_path / "torch"))
    phases, _ = eval_prioritization.evaluate(
        model_def=port_model(), params=params_from_jax(params), device="cpu",
        sa_names=("dsa",), **kwargs
    )
    roots["torch"] = str(tmp_path / "torch")
    return roots, phases


def _names(root: str, sub: str):
    return sorted(os.path.basename(p) for p in glob.glob(os.path.join(root, sub, "*")))


def test_port_artifacts_equal_the_jax_artifacts(both_runs):
    family, (roots, phases) = both_runs
    n_files, vr_max = FAMILIES[family][6], FAMILIES[family][8]
    assert sorted(phases) == ["fault_predictors", "neuron_coverage", "surprise"]
    names = _names(roots["torch"], "priorities")
    assert len(names) == n_files
    assert set(names) <= set(_names(roots["jax"], "priorities"))
    assert (vr_max is None) == (f"{family}_nominal_0_uncertainty_VR.npy" not in names)
    for name in names:
        got = np.load(os.path.join(roots["torch"], "priorities", name))
        want = np.load(os.path.join(roots["jax"], "priorities", name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        kind = name.split("_0_", 1)[1][: -len(".npy")]
        if kind == "uncertainty_VR":
            assert got.min() >= 0 and got.max() <= vr_max, name
        elif kind.startswith("uncertainty_"):
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=name)
        elif kind == "dsa_scores":
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=0, err_msg=name)
        else:  # is_misclassified, NC scores, every CAM order
            assert got.tobytes() == want.tobytes(), name
        if kind.endswith("cam_order"):
            assert sorted(got.tolist()) == list(range(got.shape[0])), name


def test_port_time_records_follow_the_contract(both_runs):
    family, (roots, _) = both_runs
    names = _names(roots["torch"], "times")
    assert names == _names(roots["jax"], "times")
    assert len(names) == FAMILIES[family][7]
    for name in names:
        with open(os.path.join(roots["torch"], "times", name), "rb") as f:
            record = pickle.load(f)
        assert len(record) == 4 and all(float(v) >= 0 for v in record), name


SA_NAMES = ("dsa", "pc-lsa", "pc-mdsa", "pc-mlsa", "pc-mmdsa")
# family: (SA tap, variants whose scores are rounding noise)
SA_TAPS = {
    "mnist": ([6], ("dsa", "pc-lsa", "pc-mdsa", "pc-mmdsa")),
    "cifar10": ([6], ("pc-mmdsa",)),
    "imdb": ([5], ()),
}


def _well_posed_rows(port_model, params, tap, x_train, tests):
    """Per test set, the rows whose predicted class has more training rows
    than the tap has live features."""
    model = BaseModel(port_model(), params, tap, include_last_layer=True, device="cpu")
    ats, probs = model.get_activations(x_train)
    live = int((ats.reshape(ats.shape[0], -1).std(dim=0) > 0).sum())
    counts = np.bincount(probs.argmax(dim=1).numpy(), minlength=probs.shape[1])
    return {ds: counts[model.get_activations(x)[-1].argmax(dim=1).numpy()] > live
            for ds, x in tests.items()}


@pytest.fixture(scope="module", params=sorted(SA_TAPS))
def sa_runs(request, tmp_path_factory):
    """Artifact roots of both packages' ``_eval_surprise`` on the same inputs."""
    family = request.param
    flax_model, port_model, make_params = FAMILIES[family][:3]
    badge = FAMILIES[family][5]
    tap = SA_TAPS[family][0]
    x_train, x_test, _, x_ood = _data(family)
    params = make_params()
    posed = _well_posed_rows(port_model, params_from_jax(params), tap, x_train,
                             {"nominal": x_test, "ood": x_ood})
    tmp = tmp_path_factory.mktemp(f"sa_{family}")
    with pytest.MonkeyPatch.context() as monkeypatch:
        for var, value in (
            ("TIP_CLUSTER_BACKEND", "jax"),
            ("TIP_SA_POOL", "1"),
            ("TIP_SA_CACHE_DIR", "off"),
        ):
            monkeypatch.setenv(var, value)
        args = (0, tap, x_test, x_ood, x_train, badge)
        monkeypatch.setenv("TIP_ASSETS", str(tmp / "jax"))
        jax_eval._eval_surprise(family, flax_model(), params, *args)
        monkeypatch.setenv("TIP_ASSETS", str(tmp / "torch"))
        chosen_k = eval_prioritization._eval_surprise(
            family, port_model(), params_from_jax(params), *args, "cpu", SA_NAMES
        )
        # the JAX discriminator on the port's own training traces
        model = BaseModel(port_model(), params_from_jax(params), tap, include_last_layer=True,
                          device="cpu")
        ats = model.get_activations(x_train)[:-1]
        flat = np.concatenate([a.reshape(a.shape[0], -1).numpy() for a in ats], axis=1)
        jax_k = jax_sa._KmeansDiscriminator(flat, range(2, 6), subsampling=0.3).best_k
    yield family, {side: str(tmp / side) for side in ("jax", "torch")}, posed, (chosen_k, jax_k)


def test_five_sa_variants_match_jax(sa_runs):
    family, roots, posed, _ = sa_runs
    noisy = SA_TAPS[family][1]
    assert _names(roots["torch"], "priorities") == _names(roots["jax"], "priorities")
    assert _names(roots["torch"], "times") == _names(roots["jax"], "times")
    assert len(_names(roots["torch"], "times")) == 2 * len(SA_NAMES)

    def load(side, ds, name, kind):
        return np.load(os.path.join(roots[side], "priorities", f"{family}_{ds}_0_{name}_{kind}.npy"))

    for name in SA_NAMES:
        for ds in ("nominal", "ood"):
            got, want = load("torch", ds, name, "scores"), load("jax", ds, name, "scores")
            assert got.dtype == want.dtype == np.float64 and got.shape == want.shape
            assert np.array_equal(got == np.inf, want == np.inf), (name, ds)
            order = load("torch", ds, name, "cam_order")
            assert sorted(order.tolist()) == list(range(order.shape[0]))
            if name in noisy:
                continue
            held = np.isfinite(want) & (posed[ds] if name == "pc-mdsa" else True)
            np.testing.assert_allclose(got[held], want[held], rtol=1e-4, atol=0,
                                       err_msg=f"{name} {ds}")
            if held.all():
                assert order.tobytes() == load("jax", ds, name, "cam_order").tobytes(), (name, ds)


def test_evaluate_returns_the_k_that_pc_mmdsa_chose(sa_runs):
    _, _, _, (chosen_k, jax_k) = sa_runs
    assert chosen_k == {"pc-mmdsa": jax_k}
