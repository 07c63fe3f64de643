"""The port's paper registry and command line against the JAX package's,
on the CPU.

- Each spec of ``casestudies.base.CASE_STUDIES`` equals the JAX package's
  field for field (models by family, loaders by name, train configs by
  value); ``get_case_study`` resolves the registry, the mini studies and
  the provider hook.
- ``cli._parse_runs`` equals the JAX package's, errors included.
- ``cli.main`` on a small ``mnist.npz`` (the registry's MNIST spec cut to
  one epoch and to DSA as its SA variant in both packages, as
  ``tests/test_torch_slice.py`` runs it): training, test_prio, evaluation
  and check with ``--device cpu``. The artifacts have the JAX package's
  names and equal what the JAX ``CaseStudy.run_prio_eval`` writes from the
  same checkpoint and the same loader output, to ``test_torch_slice.py``'s
  standard: masks, coverage scores and CAM orders byte-equal, uncertainties
  within atol 1e-5, DSA within rtol 1e-4, VR by dtype, shape and range.
- With no card and no ``--device``, a model phase exits non-zero and
  writes nothing; ``--workers 2`` on a card that fails the watchdog's probe
  (a ``watchdog.probe`` fault) exits 2 naming the worker processes and the
  reason, before any worker starts or any file is written (the run
  scheduler itself is held in ``tests/test_torch_run_scheduler.py``); the
  two statistics evaluations run on the host and write their
  CSVs (``tests/test_torch_statistics.py`` holds their bytes to the JAX
  package's).
"""

import dataclasses
import functools
import glob
import json
import os

import numpy as np
import pytest
import torch

from simple_tip_tpu import cli as jax_cli
from simple_tip_tpu.casestudies import base as jax_base
from simple_tip_tpu.data import loaders as jax_loaders
from simple_tip_tpu.engine import surprise_handler as jax_surprise
from simple_tip_tpu.utils import artifact_check as jax_check
from simple_tip_tpu_torch import cli
from simple_tip_tpu_torch.casestudies import base, mini
from simple_tip_tpu_torch.data import loaders
from simple_tip_tpu_torch.engine import eval_prioritization
from simple_tip_tpu_torch.models.train import TrainConfig
from simple_tip_tpu_torch.utils import artifact_check
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("name", ["mnist", "fmnist", "cifar10", "imdb"])
def test_specs_equal_the_jax_registry(name):
    got, want = base.CASE_STUDIES[name], jax_base.CASE_STUDIES[name]
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name == "model_factory":
            assert g.__name__ == w.__name__ and g.family == {
                "MnistConvNet": "mnist", "Cifar10ConvNet": "cifar10",
                "ImdbTransformer": "imdb"}[w.__name__]
        elif f.name == "loader":
            assert g.__wrapped__.__name__ == w.__wrapped__.__name__ == f"load_{name}"
        elif f.name == "train_cfg":
            assert dataclasses.asdict(g) == dataclasses.asdict(w)
        else:
            assert g == w, f.name
    assert [f.name for f in dataclasses.fields(base.CaseStudySpec)] == [
        f.name for f in dataclasses.fields(jax_base.CaseStudySpec)]
    cs = base.get_case_study(name)
    assert cs.spec is got and cs.model_def.family == got.model_factory.family


def test_lookup_order_and_unknown_names(monkeypatch):
    assert base.get_case_study("mini-mnist").spec is mini.MINI_CASE_STUDIES["mini-mnist"]
    with pytest.raises(KeyError, match="registry"):
        base.get_case_study("no-such-study")
    monkeypatch.setattr(mini, "provide", lambda name: pytest.fail("registry first"))
    assert base.get_case_study("imdb").spec.name == "imdb"


@pytest.mark.parametrize("spec", ["0", "0-4", "0,3,7", "-1", " 2 ", "3,1-2", "4-2", "1-1",
                                  "x", ""])
def test_parse_runs_equals_jax(spec):
    def outcome(fn):
        try:
            return fn(spec)
        except SystemExit as e:
            return ("SystemExit", str(e))
        except ValueError as e:
            return ("ValueError", str(e))

    assert outcome(cli._parse_runs) == outcome(jax_cli._parse_runs)


def test_phase_and_choice_lists_equal_jax():
    assert cli.PHASES == jax_cli.PHASES
    assert cli.CASE_STUDIES == jax_cli.CASE_STUDIES
    assert cli.EVALS == jax_cli.EVALS


def _write_mnist(folder, n_train=160, n_test=40):
    from simple_tip_tpu_torch.data import synthetic

    (xtr, ytr), (xte, yte) = synthetic.image_classification(5, n_train, n_test, (28, 28, 1))
    np.savez(os.path.join(folder, "mnist.npz"),
             x_train=np.round(xtr[..., 0] * 255).astype(np.uint8), y_train=ytr,
             x_test=np.round(xte[..., 0] * 255).astype(np.uint8), y_test=yte)


def _clear_loaders():
    for module in (loaders, jax_loaders):
        for fn in (module.load_mnist, module.load_fmnist, module.load_cifar10, module.load_imdb):
            fn.cache_clear()


@pytest.fixture()
def study_dirs(tmp_path, monkeypatch):
    data, assets = tmp_path / "datasets", tmp_path / "assets"
    data.mkdir()
    monkeypatch.setenv("TIP_DATA_DIR", str(data))
    monkeypatch.setenv("TIP_ASSETS", str(assets))
    _clear_loaders()
    yield data, assets
    _clear_loaders()


def _names(root, sub):
    return sorted(os.path.basename(p) for p in glob.glob(os.path.join(root, sub, "*")))


def test_cli_phases_match_the_jax_case_study(study_dirs, monkeypatch, capsys):
    data, assets = study_dirs
    _write_mnist(data)
    cfg = TrainConfig(batch_size=64, epochs=1, validation_split=0.1)
    monkeypatch.setitem(base.CASE_STUDIES, "mnist",
                        dataclasses.replace(base.CASE_STUDIES["mnist"], train_cfg=cfg))
    monkeypatch.setattr(eval_prioritization, "evaluate",
                        functools.partial(eval_prioritization.evaluate, sa_names=("dsa",)))

    assert cli.main(["--phase", "training", "--case-study", "mnist", "--device", "cpu"]) == 0
    assert sorted(os.listdir(data)) == ["mnist.npz", "mnist_c_images.npy", "mnist_c_labels.npy"]
    assert os.path.exists(assets / "models" / "mnist" / "0.msgpack")
    assert cli.main(["--phase", "test_prio", "--case-study", "mnist", "--device", "cpu"]) == 0
    assert cli.main(["--phase", "evaluation", "--eval", "test_prio"]) == 0
    assert os.path.exists(assets / "results" / "apfds.csv")
    capsys.readouterr()
    assert cli.main(["--phase", "check", "--case-study", "mnist"]) == 0
    report = capsys.readouterr().out
    assert "data: REAL (nominal + corruption cache)" in report
    assert "models: 1/100 trained" in report

    # the JAX case study from the same checkpoint and the same cached data
    for var, value in (("TIP_SA_POOL", "1"), ("TIP_SA_CACHE_DIR", "off"),
                       ("TIP_COV_STATS_CACHE_DIR", "off"), ("TIP_CAM_BACKEND", "auto")):
        monkeypatch.setenv(var, value)
    monkeypatch.delenv("TIP_FUSED_CHAIN", raising=False)
    monkeypatch.delenv("TIP_COMPUTE_DTYPE", raising=False)
    monkeypatch.setattr(jax_surprise, "SA_VARIANTS", {"dsa": jax_surprise.SA_VARIANTS["dsa"]})
    jax_assets = assets.parent / "jax_assets"
    os.makedirs(jax_assets / "models" / "mnist")
    with open(assets / "models" / "mnist" / "0.msgpack", "rb") as f, \
            open(jax_assets / "models" / "mnist" / "0.msgpack", "wb") as g:
        g.write(f.read())
    monkeypatch.setenv("TIP_ASSETS", str(jax_assets))
    jax_base.get_case_study("mnist").run_prio_eval([0])

    names = _names(assets, "priorities")
    assert len(names) == 2 * (1 + 5 + 2 * 13)  # mask, 5 uncertainties, 12 NC + dsa x 2
    assert set(names) <= set(_names(jax_assets, "priorities"))
    assert _names(assets, "times") == _names(jax_assets, "times")
    for name in names:
        got = np.load(assets / "priorities" / name)
        want = np.load(jax_assets / "priorities" / name)
        rows = 40 if "_nominal_" in name else 80
        assert got.dtype == want.dtype and got.shape == want.shape == (rows,), name
        kind = name.split("_0_", 1)[1][: -len(".npy")]
        if kind == "uncertainty_VR":
            assert got.min() >= 0 and got.max() <= 0.9, name
        elif kind.startswith("uncertainty_"):
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=name)
        elif kind == "dsa_scores":
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=0, err_msg=name)
        else:
            assert got.tobytes() == want.tobytes(), name
    # the check phase's findings equal the JAX package's on the port's bus
    monkeypatch.setenv("TIP_ASSETS", str(assets))
    for fn in ("check_prio_artifacts", "check_al_artifacts", "check_times_artifacts"):
        assert getattr(artifact_check, fn)("mnist", range(3)) == getattr(jax_check, fn)(
            "mnist", range(3))
    assert artifact_check.check_model_checkpoints("mnist", range(3)) == [1, 2]
    assert artifact_check.data_source("mnist") == jax_check.data_source("mnist")


def test_expected_artifacts_equal_jax():
    for dropout in (True, False):
        assert artifact_check.expected_priority_types(dropout) == \
            jax_check.expected_priority_types(dropout)
        assert artifact_check.expected_times_metrics(dropout) == \
            jax_check.expected_times_metrics(dropout)


def test_no_card_and_no_device_writes_nothing(study_dirs, monkeypatch, capsys):
    data, assets = study_dirs
    _write_mnist(data, n_train=20, n_test=8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for phase in ("training", "test_prio", "active_learning", "at_collection"):
        assert cli.main(["--phase", phase, "--case-study", "mnist"]) != 0
        assert "no CUDA device" in capsys.readouterr().err
    assert sorted(os.listdir(data)) == ["mnist.npz"]
    assert not os.path.exists(assets)


@pytest.mark.parametrize("argv, missing", [
    (["--phase", "test_prio", "--case-study", "mnist", "--workers", "2"],
     "worker processes"),
])
def test_unported_options_are_refused(study_dirs, monkeypatch, tmp_path, capsys, argv, missing):
    """Nothing falls back to the CPU: with a card that does not answer the
    watchdog's probe, ``--workers 2`` exits 2 with the reason and writes
    nothing (the JAX package would go on on the CPU here)."""
    _, assets = study_dirs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("TIP_FAULT_PLAN", json.dumps(
        {"faults": [{"site": "watchdog.probe", "kind": "fail", "times": 0}]}))
    monkeypatch.setenv("TIP_FAULT_STATE", str(tmp_path / "fault_state"))
    monkeypatch.setenv("TIP_BREAKER_STATE", "off")
    assert cli.main(argv) == 2
    err = capsys.readouterr().err
    assert missing in err and "probe-fail" in err and "injected probe failure" in err
    assert not os.path.exists(assets)


@pytest.mark.parametrize("which, prefix", [("test_prio_statistics", "apfd_correlation"),
                                           ("active_learning_statistics",
                                            "active_correlation")])
def test_statistics_evaluations_run_on_the_host(study_dirs, which, prefix):
    _, assets = study_dirs
    assert cli.main(["--phase", "evaluation", "--eval", which]) == 0
    assert sorted(os.listdir(os.path.join(assets, "results"))) == [
        f"{prefix}_eff.csv", f"{prefix}_p.csv"]


def test_help_imports_without_a_card(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--help"])
    assert e.value.code == 0
    assert "--device" in capsys.readouterr().out
