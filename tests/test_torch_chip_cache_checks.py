"""The cache and statistics checks of ``chip_smoke.py`` can fail.

On the CPU: ``warm_cache_verdict`` passes a fresh process's good report and
raises for each fault it is there to catch (a variant fitted, a
training-set pass, an artifact not byte-equal, B2 not launched, the
coverage statistics missed or unequal, an entry on the CPU that still
holds a card tensor or scores apart); ``same_bytes`` tells dtype, shape and
byte differences; ``tensor_devices`` finds a device deep in a scorer and
survives cycles; ``caches_off`` puts the environment back;
``CacheRecorder`` records a run's stores, fingerprints and outcomes and
unwraps what it wrapped; ``check_cache_entries`` refuses a missing
variant; ``check_statistics_csvs`` refuses a grid under other labels.
"""

import copy
import os

import numpy as np
import pytest
import torch

import chip_smoke
from simple_tip_tpu_torch.bridge import params_from_jax
from simple_tip_tpu_torch.engine import coverage_stats_cache, sa_prep
from simple_tip_tpu_torch.engine.coverage_handler import CoverageWorker
from simple_tip_tpu_torch.engine.model_handler import BaseModel
from simple_tip_tpu_torch.engine.surprise_handler import SurpriseHandler
from simple_tip_tpu_torch.models import ImdbTransformer
from simple_tip_tpu_torch.plotters import eval_apfd_correlation
from test_torch_slice import _data
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_transformer import imdb_flax_params

GOOD = {
    "family": "mnist", "train_forward_passes": 0, "b2_launches": 2,
    "variants": {name: {"outcome": "hit", "setup_s": 0.1, "scores_equal": True,
                        "order_equal": True} for name in chip_smoke.SA_NAMES},
    "coverage": {"outcome": "hit", "stats_equal": True},
    "cpu_entry": {"variant": "pc-mdsa", "devices": ["cpu"], "rel_gap": 3e-6},
}


def _faulty(path, value):
    report = copy.deepcopy(GOOD)
    node = report
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = value
    return report


def test_a_good_report_passes():
    chip_smoke.warm_cache_verdict(copy.deepcopy(GOOD))


@pytest.mark.parametrize("path, value, message", [
    (("variants", "pc-mlsa", "outcome"), "fit", "pc-mlsa: cache fit"),
    (("variants", "dsa", "scores_equal"), False, "dsa: scores"),
    (("variants", "pc-mmdsa", "order_equal"), False, "pc-mmdsa: scores or SC-CAM"),
    (("train_forward_passes",), 1, "training-set forward"),
    (("b2_launches",), 0, "B2 was not launched"),
    (("coverage", "outcome"), "miss", "coverage statistics: miss"),
    (("coverage", "stats_equal"), False, "equal False"),
    (("cpu_entry", "devices"), ["cpu", "cuda"], "entry on the CPU"),
    (("cpu_entry", "rel_gap"), 2e-3, "entry on the CPU"),
    (("cpu_entry", "rel_gap"), float("nan"), "entry on the CPU"),
])
def test_each_fault_fails_the_verdict(path, value, message):
    with pytest.raises(AssertionError, match=message):
        chip_smoke.warm_cache_verdict(_faulty(path, value))


def test_a_missing_variant_fails_the_verdict():
    report = copy.deepcopy(GOOD)
    del report["variants"]["pc-lsa"]
    with pytest.raises(AssertionError, match="variants"):
        chip_smoke.warm_cache_verdict(report)


def test_same_bytes():
    a = np.arange(6, dtype=np.float32)
    assert chip_smoke.same_bytes(a, a.copy())
    assert chip_smoke.same_bytes(torch.from_numpy(a), a)
    assert not chip_smoke.same_bytes(a, a.astype(np.float64))
    assert not chip_smoke.same_bytes(a, a.reshape(2, 3))
    b = a.copy()
    b[3] = np.nextafter(b[3], np.float32(10))
    assert not chip_smoke.same_bytes(a, b)
    assert not chip_smoke.same_bytes(np.float32([0.0]), np.float32([-0.0]))


class _Node:
    pass


def test_tensor_devices_finds_every_device():
    root, inner = _Node(), _Node()
    root.modal = {3: inner, "list": [torch.zeros(2), (np.zeros(2), 1)]}
    inner.parent = root  # a cycle
    inner.device = torch.device("cpu")
    assert chip_smoke.tensor_devices(root) == {"cpu"}
    inner.meta = [torch.empty(2, device="meta")]
    assert chip_smoke.tensor_devices(root) == {"cpu", "meta"}
    assert chip_smoke.tensor_devices(np.zeros(3)) == set()


def test_caches_off_restores_the_environment(monkeypatch):
    monkeypatch.setenv("TIP_SA_CACHE_DIR", "/somewhere")
    monkeypatch.delenv("TIP_COV_STATS_CACHE_DIR", raising=False)
    with chip_smoke.caches_off():
        assert os.environ["TIP_SA_CACHE_DIR"] == os.environ["TIP_COV_STATS_CACHE_DIR"] == "off"
    assert os.environ["TIP_SA_CACHE_DIR"] == "/somewhere"
    assert "TIP_COV_STATS_CACHE_DIR" not in os.environ


def test_the_recorder_records_a_run_and_unwraps(tmp_path, monkeypatch):
    monkeypatch.setenv("TIP_ASSETS", str(tmp_path))
    wrapped = (sa_prep.SAFitCache.store, coverage_stats_cache.CoverageStatsCache.store,
               sa_prep.content_fingerprint, coverage_stats_cache.content_fingerprint,
               SurpriseHandler.evaluate_all, CoverageWorker.__init__)
    params = params_from_jax(imdb_flax_params(4))
    x_train, x_test, _, _ = _data("imdb")
    with chip_smoke.CacheRecorder() as recorder:
        SurpriseHandler(ImdbTransformer(), params, [5], x_train, device="cpu",
                        dsa_badge_size=20, case_study="imdb", model_id=0,
                        ).evaluate_all({"nominal": x_test})
        CoverageWorker(BaseModel(ImdbTransformer(), params, activation_layers=[3, 5],
                                 device="cpu"), x_train)
        report = chip_smoke.check_cache_entries("imdb", recorder)
    assert (sa_prep.SAFitCache.store, coverage_stats_cache.CoverageStatsCache.store,
            sa_prep.content_fingerprint, coverage_stats_cache.content_fingerprint,
            SurpriseHandler.evaluate_all, CoverageWorker.__init__) == wrapped
    assert sorted(report["sa_entries"]) == sorted(chip_smoke.SA_NAMES)
    assert report["sa_bytes"] == sum(os.path.getsize(tmp_path / "sa_fit_cache" / n)
                                     for n in os.listdir(tmp_path / "sa_fit_cache"))
    assert [h["version"] for h in report["fingerprints"]] == [
        sa_prep.CACHE_FORMAT_VERSION, coverage_stats_cache.COV_STATS_FORMAT_VERSION]
    assert report["sa_outcomes"] == [dict.fromkeys(chip_smoke.SA_NAMES, "fit")]
    assert report["coverage_outcomes"] == ["miss"] and len(report["coverage_entries"]) == 1
    # a variant not stored, or an entry gone from the disk, fails the check
    stored = dict(recorder.sa_stores)
    recorder.sa_stores.pop("pc-lsa")
    with pytest.raises(AssertionError, match="SA entries stored"):
        chip_smoke.check_cache_entries("imdb", recorder)
    recorder.sa_stores.update(stored)
    folder = tmp_path / "sa_fit_cache"
    [entry] = [n for n in os.listdir(folder) if n.endswith("_pc-mlsa.pkl")]
    os.remove(folder / entry)
    with pytest.raises(AssertionError, match="0 entries of pc-mlsa"):
        chip_smoke.check_cache_entries("imdb", recorder)


def test_statistics_csvs_are_checked(tmp_path, monkeypatch):
    monkeypatch.setenv("TIP_ASSETS", str(tmp_path))
    eval_apfd_correlation.run(["mnist"])
    assert chip_smoke.check_statistics_csvs("apfd_correlation") == {"p_cells": 0,
                                                                     "eff_cells": 0}
    path = tmp_path / "results" / "apfd_correlation_eff.csv"
    path.write_text(path.read_text().replace("DSA-CAM", "DSA_CAM"))
    with pytest.raises(AssertionError, match="human labels"):
        chip_smoke.check_statistics_csvs("apfd_correlation")
