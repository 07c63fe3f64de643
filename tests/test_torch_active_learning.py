"""The active-learning phase of the port against the JAX package's, on the
CPU, with the same inputs and the same flax parameters.

- the observed/future split is byte-equal, and the rows the retrain
  ensemble trains a member on are the head of the JAX package's
  ``_retrain`` shuffle, one-hot labels included;
- the four selection builders agree: the random baseline, every neuron-
  coverage top-k and every CAM first-k exactly; the float top-k selections
  (the point uncertainties, the SA variants) as sets, a row differing only
  where its JAX value lies within the tolerance of ``test_torch_slice.py``
  (atol 1e-5 for uncertainties, rtol 1e-4 for SA) of the k-th largest. VR
  draws from another generator and is held by length and uniqueness. Per
  family the SA variants are the ones well posed at its tap (see
  ``test_torch_slice.py``): MNIST DSA at the full-width tap 3; CIFAR-10
  dsa, pc-lsa and pc-mlsa at its dense tap 6; IMDB all five at its tap 5,
  with int64 token ids and a DSA badge;
- ``evaluate`` is wired as the JAX package's batched route: with a
  training process that records its inputs and returns the input weights,
  both packages write the same 81 pickle names, hand the same retrain
  inputs over in the same order (VR's two aside) and write byte-equal
  ``original`` pickles;
- ``al_retrain_ensemble`` is bit-equal to the JAX package's ``_retrain``
  shuffle followed by the port's ``train_model``;
- a real port-only run on ``mini-mnist`` writes 81 pickles of accuracies;
- the AL table equals the JAX package's ``build_data_frame``.
"""

import dataclasses
import os
import pickle

import numpy as np
import pandas as pd
import pytest
import torch

from simple_tip_tpu.engine import eval_active_learning as jax_al
from simple_tip_tpu.engine import surprise_handler as jax_surprise
from simple_tip_tpu.engine.model_handler import BaseModel as JaxBaseModel
from simple_tip_tpu.models.train import evaluate_accuracy as jax_accuracy
from simple_tip_tpu.plotters import eval_active_learning_table as jax_table
from simple_tip_tpu_torch.bridge import params_from_jax
from simple_tip_tpu_torch.casestudies.base import CaseStudy
from simple_tip_tpu_torch.casestudies.mini import MINI_CASE_STUDIES, image_loader
from simple_tip_tpu_torch.engine import eval_active_learning as al
from simple_tip_tpu_torch.models import MnistConvNet
from simple_tip_tpu_torch.models.train import (
    Trainer,
    TrainConfig,
    accuracy,
    train_model,
    training_rows,
)
from simple_tip_tpu_torch.parallel.al_ensemble import al_retrain_ensemble
from simple_tip_tpu_torch.plotters import eval_active_learning_table as table
from simple_tip_tpu_torch.plotters.utils import APPROACHES
from test_torch_slice import FAMILIES, _data
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

UNCERTAINTY_ATOL = 1e-5
SA_RTOL = 1e-4
NUM_SELECTED = 10
# family: (SA taps, SA variants held at them)
SELECTION_SA = {
    "mnist": ([3], ("dsa",)),
    "cifar10": ([6], ("dsa", "pc-lsa", "pc-mlsa")),
    "imdb": ([5], ("dsa", "pc-lsa", "pc-mdsa", "pc-mlsa", "pc-mmdsa")),
}
NC = ("NBC_0", "NBC_0.5", "NBC_1", "SNAC_0", "SNAC_0.5", "SNAC_1", "NAC_0", "NAC_0.75",
      "TKNC_1", "TKNC_2", "TKNC_3", "KMNC_2")


def _jax_env(monkeypatch):
    for var, value in (
        ("TIP_CLUSTER_BACKEND", "jax"),
        ("TIP_SA_POOL", "1"),
        ("TIP_SA_CACHE_DIR", "off"),
        ("TIP_COV_STATS_CACHE_DIR", "off"),
        ("TIP_CAM_BACKEND", "auto"),
    ):
        monkeypatch.setenv(var, value)
    monkeypatch.delenv("TIP_FUSED_CHAIN", raising=False)


# -- the split and the retrain inputs -----------------------------------------


@pytest.mark.parametrize("n", [7, 48, 301])
@pytest.mark.parametrize("share", [0.5, 0.3])
def test_split_is_byte_equal_to_the_jax_split(n, share):
    rng = np.random.default_rng(n)
    nom_x, ood_x = rng.normal(size=(n, 3)), rng.normal(size=(n + 1, 2, 2)).astype(np.float32)
    nom_y, ood_y = rng.integers(0, 10, n), rng.integers(0, 10, n + 1)
    for model_id in (0, 3):
        got = al._shuffle_and_split_datasets(model_id, nom_x, nom_y, ood_x, ood_y, share)
        want = jax_al._shuffle_and_split_datasets(model_id, nom_x, nom_y, ood_x, ood_y, share)
        assert list(got) == list(want)
        for key, arrays in want.items():
            for a, b in zip(got[key], arrays):
                assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _recorder(calls, result):
    def training_process(x, y, seed):
        calls.append((np.array(x), np.array(y), seed))
        return result

    return training_process


@pytest.mark.parametrize("num_classes", [10, 2])
def test_retrain_inputs_are_byte_equal(num_classes, monkeypatch):
    rng = np.random.default_rng(1)
    train_x, new_x = rng.random((40, 4, 4, 1), np.float32), rng.random((9, 4, 4, 1), np.float32)
    train_y, new_y = rng.integers(0, num_classes, 40), rng.integers(0, num_classes, (9, 1))
    want = []
    jax_al._retrain(num_classes, _recorder(want, "jax"), train_x, train_y, new_x, new_y, seed=3007)
    got = []

    def fit(self, xs, ys, seed, history=None):
        got.append((xs.numpy(), ys.numpy(), seed))
        return {}

    monkeypatch.setattr(Trainer, "fit", fit)
    eye = np.eye(num_classes, dtype=np.float32)
    al_retrain_ensemble(MnistConvNet(), TrainConfig(), train_x, eye[train_y],
                        [(new_x, eye[new_y.flatten()], 3007)], "cpu")
    n_train = training_rows(49, TrainConfig().validation_split)
    (gx, gy, gs), (wx, wy, ws) = got[0], want[0]
    assert gs == ws == 3007 and n_train == 45
    for a, b in ((gx, wx[:n_train]), (gy, wy[:n_train])):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("fault", ["short", "repeated", "accuracy", "labels"])
def test_faulty_selections_accuracies_and_labels_raise(fault):
    x = np.zeros((4, 2), np.float32)
    if fault in ("short", "repeated"):
        rows = [0, 1] if fault == "short" else [0, 1, 1]
        with pytest.raises(AssertionError):
            al._selection_sanity_checks(3, {("softmax", "nominal"): [0, 1, 2],
                                            ("pcs", "ood"): rows})
    elif fault == "accuracy":
        datasets = {("nominal", "observed"): (x, np.zeros(4))}
        with pytest.raises(ValueError, match="accuracy"):
            al._evaluate(None, None, datasets, lambda *args: 1.5)
    else:
        datasets = {("nominal", "observed"): (x, np.zeros((4, 2)))}
        with pytest.raises(ValueError, match="one per row"):
            al._retrain_inputs({("softmax", "nominal"): [0, 1]}, datasets, 0)


# -- the four selection builders ----------------------------------------------


def _top_k_agrees(got, want, values, k, atol=0.0, rtol=0.0, what=""):
    """``got`` and ``want`` select the same k rows, but where a row's JAX
    value lies within atol + rtol |v_k| of the k-th largest JAX value v_k
    (a near tie at the edge of the selection)."""
    got, want = np.asarray(got), np.asarray(want)
    assert len(got) == len(want) == k == len(set(got.tolist())), what
    moved = set(got.tolist()) ^ set(want.tolist())
    if moved:
        edge = np.sort(values)[-k]
        gaps = np.abs(values[sorted(moved)] - edge)
        assert gaps.max() <= atol + rtol * abs(edge), (what, sorted(moved), gaps)
    return len(moved)


def _record(monkeypatch, owner, name, log):
    """Append every return value of the method ``owner.name`` to ``log``."""
    method = getattr(owner, name)

    def recording(*args, **kwargs):
        log.append(method(*args, **kwargs))
        return log[-1]

    monkeypatch.setattr(owner, name, recording)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def selections(request):
    """Both packages' four selection builders on one family's inputs."""
    family = request.param
    flax_model, port_model, make_params, nc_layers, _, badge = FAMILIES[family][:6]
    sa_layers, sa_names = SELECTION_SA[family]
    x_train, x_test, y_test, x_ood = _data(family)
    params = make_params()
    bridged = params_from_jax(params)
    datasets = jax_al._shuffle_and_split_datasets(0, x_test, y_test, x_ood, y_test, 0.5)
    uncertainties, sa_results = [], []
    with pytest.MonkeyPatch.context() as monkeypatch:
        _jax_env(monkeypatch)
        monkeypatch.setattr(jax_surprise, "SA_VARIANTS",
                            {n: jax_surprise.SA_VARIANTS[n] for n in sa_names})
        # the JAX values the float selections are taken from, as they are made
        _record(monkeypatch, JaxBaseModel, "get_pred_and_uncertainty", uncertainties)
        _record(monkeypatch, jax_surprise.SurpriseHandler, "evaluate_all", sa_results)
        want = {
            "fp": jax_al._get_fp_selection(flax_model(), params, datasets, NUM_SELECTED, 128),
            "nc": jax_al._get_nc_selection(flax_model(), params, x_train, datasets, nc_layers,
                                           NUM_SELECTED, 128),
            "sa": jax_al._get_sa_selection(flax_model(), params, x_train, datasets, sa_layers,
                                           NUM_SELECTED, badge),
            "random": jax_al._get_random_section(datasets, NUM_SELECTED),
        }
    values = {(m, split): u for split, (_, unc, _) in zip(("nominal", "ood"), uncertainties)
              for m, u in unc.items()}
    [results] = sa_results
    values.update({(m, s): r[0] for m, per in results.items() for s, r in per.items()})
    built = {
        "fp": al._get_fp_selection(port_model(), bridged, datasets, NUM_SELECTED, 128, "cpu"),
        "nc": al._get_nc_selection(port_model(), bridged, x_train, datasets, nc_layers,
                                   NUM_SELECTED, 128, "cpu"),
        "sa": al._get_sa_selection(port_model(), bridged, x_train, datasets, sa_layers,
                                   NUM_SELECTED, badge, "cpu", sa_names),
    }
    got = {name: selection for name, (selection, _) in built.items()}
    got["random"] = al._get_random_section(datasets, NUM_SELECTED)
    scores = {name: score for name, (_, score) in built.items()}
    yield family, sa_names, got, want, values, scores


def test_random_and_coverage_selections_are_exact(selections):
    family, _, got, want, _, _ = selections
    for builder in ("random", "nc"):
        assert list(got[builder]) == list(want[builder]), builder
        for key, rows in want[builder].items():
            assert np.asarray(got[builder][key]).tobytes() == np.asarray(rows).tobytes(), key
    assert len(got["nc"]) == 2 * 2 * len(NC)


def test_uncertainty_selections_match(selections):
    family, _, got, want, values, _ = selections
    assert list(got["fp"]) == list(want["fp"])
    has_vr = FAMILIES[family][8] is not None
    assert len(got["fp"]) == 2 * (5 if has_vr else 4)
    for (metric, split), rows in want["fp"].items():
        if metric == "VR":
            vr = np.asarray(got["fp"][metric, split])
            assert len(vr) == NUM_SELECTED == len(set(vr.tolist()))
            continue
        _top_k_agrees(got["fp"][metric, split], rows, values[metric, split], NUM_SELECTED,
                      atol=UNCERTAINTY_ATOL, what=(metric, split))


def test_surprise_selections_match(selections):
    family, sa_names, got, want, values, _ = selections
    assert list(got["sa"]) == list(want["sa"])
    assert len(got["sa"]) == 2 * 2 * len(sa_names)
    for (metric, split), rows in want["sa"].items():
        if metric.endswith("-cam"):
            assert np.asarray(got["sa"][metric, split]).tobytes() == np.asarray(rows).tobytes()
        else:
            _top_k_agrees(got["sa"][metric, split], rows, values[metric, split], NUM_SELECTED,
                          rtol=SA_RTOL, what=(metric, split))


def test_builders_return_the_scores_they_select_from(selections):
    """Each top-k selection is the top k of the scores its builder returns,
    and those scores are the JAX package's: coverage exactly, uncertainties
    within atol 1e-5, SA within rtol 1e-4 (VR's draws aside)."""
    family, sa_names, got, _, values, scores = selections
    for builder, (atol, rtol) in (("fp", (UNCERTAINTY_ATOL, 0.0)), ("nc", (0.0, 0.0)),
                                  ("sa", (0.0, SA_RTOL))):
        top_k = [key for key in got[builder] if not key[0].endswith("-cam")]
        assert list(scores[builder]) == top_k, builder
        for key in top_k:
            score = np.asarray(scores[builder][key])
            assert set(np.asarray(got[builder][key]).tolist()) == set(
                np.argsort(score)[-NUM_SELECTED:].tolist()), key
            if key[0] == "VR":
                continue
            if builder != "nc":
                np.testing.assert_allclose(score, values[key], atol=atol, rtol=rtol,
                                           err_msg=str(key))
    assert len(scores["sa"]) == 2 * len(sa_names)


# -- evaluate's wiring ---------------------------------------------------------


def _cached(fn):
    """``fn`` memoized per (params, x) object: the stub retrains return the
    input weights, so each split is scored once per package."""
    memo = {}

    def accuracy_fn(model_def, params, x, labels):
        key = (id(params), id(x))
        if key not in memo:
            memo[key] = fn(model_def, params, x, labels)
        return memo[key]

    return accuracy_fn


def _batch_recorder(calls, result):
    def batch_training_process(sels):
        calls.extend((np.array(x), np.array(y), seed) for x, y, seed in sels)
        return [result] * len(sels)

    return batch_training_process


def _no_training_process(x, y, seed):
    raise AssertionError("the batched route must not retrain one by one")


def _pickles(root):
    folder = os.path.join(root, "active_learning")
    return {name: open(os.path.join(folder, name), "rb").read()
            for name in sorted(os.listdir(folder))}


@pytest.fixture(scope="module")
def wired(tmp_path_factory):
    """Both packages' ``evaluate`` on mini-mnist's model with the recording
    stub on the batched route; SA at the full-width tap with DSA only, as in
    ``selections``."""
    flax_model, port_model, make_params = FAMILIES["mnist"][:3]
    x_train, x_test, y_test, x_ood = _data("mnist")
    y_train = np.random.default_rng(2).integers(0, 10, x_train.shape[0])
    params = make_params()
    tmp = tmp_path_factory.mktemp("al_wiring")
    kwargs = dict(model_id=2, case_study="mini-mnist", train_x=x_train,
                  nominal_test_x=x_test, nominal_test_labels=y_test, ood_test_x=x_ood,
                  ood_test_labels=y_test, nc_activation_layers=[0, 1, 2, 3],
                  sa_activation_layers=[3], observed_share=0.5, num_selected=30)
    calls = {"jax": [], "torch": []}
    with pytest.MonkeyPatch.context() as monkeypatch:
        _jax_env(monkeypatch)
        monkeypatch.setattr(jax_surprise, "SA_VARIANTS", {"dsa": jax_surprise.SA_VARIANTS["dsa"]})
        monkeypatch.setenv("TIP_ASSETS", str(tmp / "jax"))
        jax_al.evaluate(model_def=flax_model(), params=params, train_y=y_train, num_classes=10,
                        training_process=_no_training_process,
                        batch_training_process=_batch_recorder(calls["jax"],
                                                               (flax_model(), params)),
                        accuracy_fn=_cached(jax_accuracy), **kwargs)
        monkeypatch.setenv("TIP_ASSETS", str(tmp / "torch"))
        bridged = params_from_jax(params)
        run = al.evaluate(
            model_def=port_model(), params=bridged,
            batch_training_process=_batch_recorder(calls["torch"], (port_model(), bridged, [])),
            accuracy_fn=_cached(lambda m, p, x, y: accuracy(m, p, x, y, "cpu")),
            device="cpu", sa_names=("dsa",), **kwargs)
    yield {side: _pickles(str(tmp / side)) for side in calls}, calls, run


def test_evaluate_writes_the_jax_pickles(wired):
    pickles, _, run = wired
    # 1 original + 2 x (5 uncertainties + 24 coverage + 2 DSA + random)
    assert list(pickles["torch"]) == list(pickles["jax"])
    assert len(pickles["torch"]) == 1 + 2 * (5 + 24 + 2 + 1)
    name = "mini-mnist_2_original_na.pickle"
    assert pickles["torch"][name] == pickles["jax"][name]
    original = pickle.loads(pickles["torch"][name])
    assert list(original) == [("nominal", "observed"), ("nominal", "future"),
                              ("ood", "observed"), ("ood", "future")]
    assert all(type(v) is float for v in original.values())
    assert set(run.seconds) == {"original", "fp_selection", "nc_selection", "sa_selection",
                                "retrain", "evaluation"}
    assert run.retrain_epochs == [[]] * (len(pickles["torch"]) - 1)


def test_evaluate_hands_the_jax_retrain_inputs_over(wired):
    _, calls, _ = wired
    assert len(calls["torch"]) == len(calls["jax"]) == 2 * (5 + 24 + 2 + 1)
    # the selections' order: per split the uncertainties (VR fifth), then coverage ...
    vr = {4, 5 + 4}
    for i, ((gx, gy, gs), (wx, wy, ws)) in enumerate(zip(calls["torch"], calls["jax"])):
        assert gs == ws == 2 * 1000 + i
        assert gy.dtype == wy.dtype and gy.shape == wy.shape == gx.shape[:1]
        if i in vr:
            continue
        assert gx.tobytes() == wx.tobytes() and gy.tobytes() == wy.tobytes(), i


# -- the retrain ensemble ------------------------------------------------------


def _trees_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_trees_equal(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.fixture(scope="module")
def retrain_case():
    rng = np.random.default_rng(0)
    n, k, classes = 96, 12, 10
    x = rng.random((n, 28, 28, 1), np.float32)
    labels = rng.integers(0, classes, n)
    xs = rng.random((3, k, 28, 28, 1), np.float32)
    ys = rng.integers(0, classes, (3, k))
    cfg = TrainConfig(batch_size=32, epochs=2, learning_rate=2e-3, validation_split=0.1)
    model = MnistConvNet()

    def training_process(xx, yy, seed):
        return train_model(model, xx, yy, cfg, seed, "cpu")

    sequential = [jax_al._retrain(classes, training_process, x, labels, xs[i], ys[i], 1000 + i)
                  for i in range(3)]
    eye = np.eye(classes, dtype=np.float32)
    sels = [(xs[i], eye[ys[i]], 1000 + i) for i in range(3)]
    return model, cfg, x, eye[labels], sels, sequential


@pytest.mark.parametrize("members", [1, 2, 3])
def test_ensemble_is_bit_equal_to_sequential_retrains(retrain_case, members):
    model, cfg, x, y, sels, sequential = retrain_case
    batched = al_retrain_ensemble(model, cfg, x, y, sels[:members], device="cpu")
    assert len(batched) == members
    for i, ((got, epochs), want) in enumerate(zip(batched, sequential)):
        assert _trees_equal(got, want), f"selection {i} of {members}"
        assert [(r["epoch"], r["steps"]) for r in epochs] == [(1, 4), (2, 4)]
    if members > 1:
        assert not _trees_equal(batched[0][0], batched[1][0])


def test_ensemble_refuses_unequal_selections(retrain_case):
    model, cfg, x, y, sels, _ = retrain_case
    ragged = [sels[0], (sels[1][0][:5], sels[1][1][:5], 7)]
    with pytest.raises(ValueError, match="equal size"):
        al_retrain_ensemble(model, cfg, x, y, ragged, device="cpu")


# -- a real port-only run ------------------------------------------------------


@pytest.fixture(scope="module")
def real_run(tmp_path_factory):
    """mini-mnist with one epoch on 100 training and 30 test images (so its
    48 selected rows clamp to the 15 observed nominal rows), SA at the
    softmax tap, one run: trained, then its AL phase."""
    spec = MINI_CASE_STUDIES["mini-mnist"]
    spec = dataclasses.replace(
        spec, loader=image_loader((28, 28, 1), seed=41, n_train=100, n_test=30),
        train_cfg=dataclasses.replace(spec.train_cfg, epochs=1), sa_activation_layers=(6,))
    root = tmp_path_factory.mktemp("al_real")
    with pytest.MonkeyPatch.context() as monkeypatch:
        monkeypatch.setenv("TIP_ASSETS", str(root))
        cs = CaseStudy(spec)
        cs.train([0], device="cpu")
        runs = cs.run_active_learning_eval([0], device="cpu")
    yield _pickles(str(root)), runs


def test_real_run_writes_81_pickles_of_accuracies(real_run):
    pickles, runs = real_run
    assert len(pickles) == 81 and list(runs) == [0]
    assert runs[0].seconds["retrain"] > 0
    # 100 + 15 rows, 104 after the held-out tail: 2 steps of 64
    assert [[(r["epoch"], r["steps"]) for r in epochs] for epochs in runs[0].retrain_epochs] \
        == [[(1, 2)]] * 80
    expected = {f"mini-mnist_0_{a}_{s}.pickle" for a in [*APPROACHES, "random"]
                for s in ("nominal", "ood")}
    assert set(pickles) == expected | {"mini-mnist_0_original_na.pickle"}
    accuracies = [v for blob in pickles.values() for v in pickle.loads(blob).values()]
    assert len(accuracies) == 4 * 81
    assert all(0 <= v <= 1 for v in accuracies)
    assert len(set(accuracies)) > 4  # the retrained models differ


def test_the_card_is_the_default_device():
    cs = CaseStudy(MINI_CASE_STUDIES["mini-mnist"])
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cs.run_active_learning_eval([0])


# -- the AL table --------------------------------------------------------------


@pytest.fixture()
def al_bus(tmp_path, monkeypatch):
    """Synthetic AL pickles for mnist (three runs; TKNC_3 missing) and
    cifar10 (two runs; no VR), and a case study with no results."""
    monkeypatch.setenv("TIP_ASSETS", str(tmp_path))
    folder = tmp_path / "active_learning"
    folder.mkdir()
    rng = np.random.default_rng(5)
    splits = [(s, p) for s in ("nominal", "ood") for p in ("observed", "future")]
    for cs, runs, missing in (("mnist", 3, "TKNC_3"), ("cifar10", 2, "VR")):
        for run in range(runs):
            entries = [("original", "na")] + [
                (a, obs) for a in [*APPROACHES, "random"] if a != missing
                for obs in ("nominal", "ood")]
            for approach, obs in entries:
                acc = {s: float(rng.integers(0, 1000)) / 1000 for s in splits}
                with open(folder / f"{cs}_{run}_{approach}_{obs}.pickle", "wb") as f:
                    pickle.dump(acc, f)
    return ["mnist", "cifar10", "imdb"]


def test_al_table_equals_the_jax_frame(al_bus, tmp_path):
    with pytest.warns(UserWarning) as port_warnings:
        got = table.active_learning_table(al_bus)
    with pytest.warns(UserWarning) as jax_warnings:
        want = jax_table.build_data_frame(al_bus)
    assert [str(w.message) for w in port_warnings] == [str(w.message) for w in jax_warnings]
    assert "missing AL results for TKNC_3 on mnist" in [str(w.message) for w in port_warnings]
    assert not any("VR on cifar10" in str(w.message) for w in port_warnings)
    assert list(got) == list(want.index)
    assert list(next(iter(got.values()))) == list(want.columns)
    for row, cells in got.items():
        for col, value in cells.items():
            cell = want.at[row, col]
            assert (value is None and pd.isna(cell)) or value == cell, (row, col, value, cell)
    assert got[("neuron coverage", "TKNC_3")]["mnist", "ood", "ood:future"] == "n.a."
    assert got[("uncertainty", "VR")]["cifar10", "nominal", "nominal:observed"] == "n.a."
    assert got[("baseline", "random")]["imdb", "ood", "ood:future"] is None


def test_active_csv_is_the_jax_csv(al_bus, tmp_path):
    with pytest.warns(UserWarning):
        table.run(al_bus)
        want = jax_table.build_data_frame(al_bus).to_csv()
    with open(tmp_path / "results" / "active.csv", newline="") as f:
        assert f.read() == want

