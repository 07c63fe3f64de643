"""The port's SA fit cache and coverage-statistics cache against the JAX
package's, on the CPU.

- The fingerprint: ``content_fingerprint`` over the bridge's flax-layout
  view of the port's weights equals the JAX function's hex digest for the
  same version and tags, per family; the port's ``train_fingerprint``
  differs from the JAX one for the same triple.
- The SA fit cache (IMDB at tap 5, all five variants): a cold handler then
  a fresh one gives five hits, no training-set forward pass, and scores
  and SC-CAM orders byte-equal to cold, each setup slot the load; a stale
  fingerprint and a wrong-variant entry miss; a truncated entry is refitted
  and overwritten; ``off`` makes no directory; ``dsa_badge_size`` applies on
  a hit; the size cap's grammar equals the JAX package's, errors included;
  the LRU sweep spares the entry just written; a hit touches the entry's
  mtime; an entry names no device and loads onto the device asked.
- The coverage-statistics cache: reuse (statistics byte-equal), corrupt
  and stale entries recompute, ``off``, and the three debits equal to the
  load time.
- Isolation: the JAX and the port handlers (SA and coverage) on the same
  model, data and directory each miss the other's entries, and neither
  overwrites them.
- Active learning: a mini-mnist ``test_prio`` then AL under one
  ``TIP_ASSETS`` hits all five variants, and the 81 AL pickles are
  byte-equal to a run with both caches off.
- The coverage spill: ``disk`` and ``memory`` give byte-equal scores and
  CAM orders, the spill directories are removed, and ``auto`` resolves both
  ways under a patched free-memory reading.
"""

import dataclasses
import logging
import os
import pickle
import shutil
import time

import numpy as np
import pytest
import torch

from simple_tip_tpu.engine import coverage_handler as jax_coverage
from simple_tip_tpu.engine import sa_prep as jax_sa_prep
from simple_tip_tpu.engine import surprise_handler as jax_surprise
from simple_tip_tpu.engine.model_handler import BaseModel as JaxBaseModel
from simple_tip_tpu.models import ImdbTransformer as FlaxImdbTransformer
from simple_tip_tpu_torch.bridge import params_from_jax, params_to_jax
from simple_tip_tpu_torch.casestudies.base import CaseStudy
from simple_tip_tpu_torch.casestudies.mini import MINI_CASE_STUDIES, image_loader
from simple_tip_tpu_torch.engine import coverage_handler, sa_prep
from simple_tip_tpu_torch.engine.coverage_handler import CoverageWorker
from simple_tip_tpu_torch.engine.coverage_stats_cache import CoverageStatsCache
from simple_tip_tpu_torch.engine.model_handler import BaseModel
from simple_tip_tpu_torch.engine.surprise_handler import SA_VARIANTS, SurpriseHandler
from simple_tip_tpu_torch.models import Cifar10ConvNet, ImdbTransformer, MnistConvNet
from simple_tip_tpu_torch.ops.surprise import DSA
from test_torch_cifar import cifar_flax_params
from test_torch_model import flax_params
from test_torch_slice import _data
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_transformer import imdb_flax_params

SA_NAMES = tuple(SA_VARIANTS)
SA_TAP = [5]
NC_TAPS = [3, 5]
DSA_BADGE = 20


@pytest.fixture(scope="module")
def imdb():
    """(flax params, bridged params, train x, {nominal, ood})."""
    tree = imdb_flax_params(4)
    x_train, x_test, _, x_ood = _data("imdb")
    return tree, params_from_jax(tree), x_train, {"nominal": x_test, "ood": x_ood}


def _handler(imdb, **kwargs):
    _, params, x_train, _ = imdb
    kwargs.setdefault("dsa_badge_size", DSA_BADGE)
    return SurpriseHandler(ImdbTransformer(), params, SA_TAP, x_train, device="cpu",
                           case_study="imdb", model_id=0, **kwargs)


def _train_passes(handler, x_train):
    """Record every training-set forward pass the handler makes."""
    passes = []
    traces = handler._traces

    def counting(dataset):
        if dataset is x_train:
            passes.append(len(dataset))
        return traces(dataset)

    handler._traces = counting
    return passes


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.fixture(scope="module")
def cold_then_warm(imdb, tmp_path_factory):
    """A cold handler's results, then a fresh handler's on the same cache."""
    root = tmp_path_factory.mktemp("sa_cache")
    with pytest.MonkeyPatch.context() as monkeypatch:
        monkeypatch.setenv("TIP_SA_CACHE_DIR", str(root))
        cold = _handler(imdb)
        cold_results, cold_k = cold.evaluate_all(imdb[3])
        warm = _handler(imdb)
        passes = _train_passes(warm, imdb[2])
        warm_results, warm_k = warm.evaluate_all(imdb[3])
    return (root, cold, cold_results, cold_k, warm, warm_results, warm_k, passes)


# -- the fingerprint -------------------------------------------------------------


@pytest.mark.parametrize("family", ["mnist", "cifar10", "imdb"])
def test_fingerprint_equals_the_jax_digest(family):
    tree = {"mnist": flax_params, "cifar10": cifar_flax_params,
            "imdb": imdb_flax_params}[family](3)
    model = {"mnist": MnistConvNet, "cifar10": Cifar10ConvNet, "imdb": ImdbTransformer}[family]()
    model.load_state_dict(params_from_jax(tree)["module"])
    x = _data(family)[0]
    version, layers, tags = jax_sa_prep.CACHE_FORMAT_VERSION, [3], ("jax",)
    want = jax_sa_prep.content_fingerprint(version, tree, x, layers, *tags)
    got = sa_prep.content_fingerprint(version, params_to_jax(family, model), x, layers, *tags)
    assert got == want
    # the port's own key never equals the JAX package's
    assert sa_prep.train_fingerprint(params_to_jax(family, model), x, layers) \
        != jax_sa_prep.train_fingerprint(tree, x, layers)
    assert sa_prep.train_fingerprint(params_to_jax(family, model), x[:-1], layers) \
        != sa_prep.train_fingerprint(params_to_jax(family, model), x, layers)


# -- the SA fit cache ------------------------------------------------------------


def test_warm_handler_hits_every_variant_without_a_training_pass(cold_then_warm):
    root, cold, _, _, warm, _, _, passes = cold_then_warm
    assert cold.cache_outcomes == dict.fromkeys(SA_NAMES, "fit")
    assert warm.cache_outcomes == dict.fromkeys(SA_NAMES, "hit")
    assert passes == [] and warm._fitter is None
    assert len(os.listdir(root)) == len(SA_NAMES)


def test_warm_results_are_byte_equal_to_cold(cold_then_warm):
    _, _, cold, cold_k, _, warm, warm_k, _ = cold_then_warm
    assert warm_k == cold_k and set(warm_k) == {"pc-mmdsa"}
    for name in SA_NAMES:
        for ds in ("nominal", "ood"):
            scores, order, times = warm[name][ds]
            assert _same(scores, cold[name][ds][0]), (name, ds)
            assert _same(order, cold[name][ds][1]), (name, ds)
            assert len(times) == 4


def test_setup_of_a_hit_is_its_load(imdb, cold_then_warm, monkeypatch):
    root = cold_then_warm[0]
    monkeypatch.setenv("TIP_SA_CACHE_DIR", str(root))
    load = sa_prep.SAFitCache.load

    def slow_load(cache, sa_name, device=None):
        time.sleep(0.05)
        return load(cache, sa_name, device)

    monkeypatch.setattr(sa_prep.SAFitCache, "load", slow_load)
    results, _ = _handler(imdb).evaluate_all({"nominal": imdb[3]["nominal"]})
    for name in SA_NAMES:
        setup = results[name]["nominal"][2][0]
        assert 0.05 <= setup < 1.0, name


def test_stale_fingerprint_misses(imdb, cold_then_warm, monkeypatch, caplog):
    root = cold_then_warm[0]
    monkeypatch.setenv("TIP_SA_CACHE_DIR", str(root))
    cache = _handler(imdb).cache
    stale = sa_prep.SAFitCache(cache.root, cache.case_study, cache.model_ref,
                               cache.fingerprint[:16] + "0" * 48, cache.device)
    assert stale.path("dsa") == cache.path("dsa")
    with caplog.at_level(logging.INFO, logger=sa_prep.__name__):
        assert stale.load("dsa") is None
    assert "STALE" in caplog.text
    # another training set keys other entries
    other = SurpriseHandler(ImdbTransformer(), imdb[1], SA_TAP, imdb[2][:-1], device="cpu",
                            dsa_badge_size=DSA_BADGE, case_study="imdb", model_id=0)
    other.evaluate_all({"nominal": imdb[3]["nominal"]})
    assert other.cache_outcomes == dict.fromkeys(SA_NAMES, "fit")


def test_wrong_variant_entry_is_stale_not_wrong(imdb, tmp_path, monkeypatch):
    monkeypatch.setenv("TIP_SA_CACHE_DIR", str(tmp_path))
    handler = _handler(imdb, sa_names=("dsa",))
    handler.evaluate_all({"nominal": imdb[3]["nominal"]})
    cache = handler.cache
    shutil.copyfile(cache.path("dsa"), cache.path("pc-lsa"))
    assert cache.load("pc-lsa") is None
    assert isinstance(cache.load("dsa"), DSA)


def test_truncated_entry_is_refitted_and_overwritten(imdb, cold_then_warm, tmp_path,
                                                     monkeypatch, caplog):
    root = tmp_path / "cache"
    shutil.copytree(cold_then_warm[0], root)
    monkeypatch.setenv("TIP_SA_CACHE_DIR", str(root))
    path = _handler(imdb).cache.path("pc-mdsa")
    whole = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(whole // 2)
    handler = _handler(imdb)
    with caplog.at_level(logging.WARNING, logger=sa_prep.__name__):
        results, _ = handler.evaluate_all(imdb[3])
    assert "corrupt" in caplog.text
    assert handler.cache_outcomes == {**dict.fromkeys(SA_NAMES, "hit"), "pc-mdsa": "fit"}
    assert os.path.getsize(path) == whole
    assert _same(results["pc-mdsa"]["ood"][0], cold_then_warm[2]["pc-mdsa"]["ood"][0])
    assert _handler(imdb).cache.load("pc-mdsa") is not None


def test_off_creates_no_directory(imdb, tmp_path, monkeypatch):
    monkeypatch.setenv("TIP_ASSETS", str(tmp_path))
    monkeypatch.setenv("TIP_SA_CACHE_DIR", "off")
    handler = _handler(imdb, sa_names=("dsa", "pc-mdsa"))
    handler.evaluate_all({"nominal": imdb[3]["nominal"]})
    assert handler.cache_outcomes == {"dsa": "off", "pc-mdsa": "off"}
    assert os.listdir(tmp_path) == []


def test_the_default_directory_is_under_the_assets(imdb, tmp_path, monkeypatch):
    monkeypatch.setenv("TIP_ASSETS", str(tmp_path))
    monkeypatch.delenv("TIP_SA_CACHE_DIR", raising=False)
    _handler(imdb, sa_names=("dsa",)).evaluate_all({"nominal": imdb[3]["nominal"]})
    [name] = os.listdir(tmp_path / "sa_fit_cache")
    assert name.startswith("imdb_0_") and name.endswith("_dsa.pkl")


def test_dsa_badge_size_applies_on_a_hit(imdb, tmp_path, monkeypatch):
    monkeypatch.setenv("TIP_SA_CACHE_DIR", str(tmp_path))
    _handler(imdb, sa_names=("dsa",), dsa_badge_size=None).evaluate_all(
        {"nominal": imdb[3]["nominal"]})
    handler = _handler(imdb, sa_names=("dsa",), dsa_badge_size=7)
    scorer, _ = handler._prepare_one("dsa")
    assert handler.cache_outcomes == {"dsa": "hit"} and scorer.badge_size == 7


@pytest.mark.parametrize("raw", ["", "0", "off", "unlimited", "none", " NONE ", "4096",
                                 "64k", "1.5m", "2g", " 2G ", "lots", "12x", "k", "1e3"])
def test_cap_grammar_equals_the_jax_grammar(raw, monkeypatch):
    monkeypatch.setenv("TIP_SA_CACHE_MAX_BYTES", raw)
    try:
        want = jax_sa_prep.sa_cache_max_bytes()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            sa_prep.sa_cache_max_bytes()
        assert str(got.value) == str(e)
    else:
        assert sa_prep.sa_cache_max_bytes() == want


def test_lru_sweep_spares_the_new_entry(imdb, tmp_path, monkeypatch):
    root = tmp_path / "cache"
    root.mkdir()
    for i, name in enumerate(["old.pkl", "mid.pkl", "new.pkl"]):
        (root / name).write_bytes(b"x" * 100)
        os.utime(root / name, (1000 + i, 1000 + i))
    (root / "other.txt").write_bytes(b"x" * 1000)
    cache = sa_prep.SAFitCache(str(root), "cs", "0", "f" * 64, torch.device("cpu"))
    monkeypatch.setenv("TIP_SA_CACHE_MAX_BYTES", "150")
    cache._sweep(keep=str(root / "new.pkl"))
    assert sorted(os.listdir(root)) == ["new.pkl", "other.txt"]
    # a store under a cap below one entry keeps that entry alone
    monkeypatch.setenv("TIP_SA_CACHE_DIR", str(root))
    monkeypatch.setenv("TIP_SA_CACHE_MAX_BYTES", "1")
    _handler(imdb, sa_names=("dsa", "pc-mdsa")).evaluate_all({"nominal": imdb[3]["nominal"]})
    [entry] = [n for n in os.listdir(root) if n.endswith(".pkl")]
    assert entry.endswith("_pc-mdsa.pkl")


def test_a_hit_touches_its_entry(imdb, cold_then_warm, monkeypatch):
    monkeypatch.setenv("TIP_SA_CACHE_DIR", str(cold_then_warm[0]))
    cache = _handler(imdb).cache
    os.utime(cache.path("pc-lsa"), (1000, 1000))
    assert cache.load("pc-lsa") is not None
    assert os.stat(cache.path("pc-lsa")).st_mtime > time.time() - 60


def test_an_entry_names_no_device(imdb, cold_then_warm, monkeypatch):
    """The scorer's tensors and devices are written as placeholders, which a
    plain unpickler refuses (so the JAX package can never load one), and
    read back onto the device the load asks for."""
    monkeypatch.setenv("TIP_SA_CACHE_DIR", str(cold_then_warm[0]))
    cache = _handler(imdb).cache
    with open(cache.path("pc-mmdsa"), "rb") as f:
        meta = pickle.load(f)
        with pytest.raises(pickle.UnpicklingError, match="persistent"):
            pickle.load(f)
    assert meta == {"version": sa_prep.CACHE_FORMAT_VERSION, "variant": "pc-mmdsa",
                    "fingerprint": cache.fingerprint, "case_study": "imdb", "model_ref": "0"}
    scorer = cache.load("pc-mmdsa", device="cpu")
    assert scorer.discriminator.device == torch.device("cpu")
    for modal in scorer.modal_sa.values():
        assert modal.device == torch.device("cpu") and modal.precision.device.type == "cpu"
    dsa = cache.load("dsa")
    assert dsa.layout is None and dsa.rows.device.type == "cpu"


# -- the coverage-statistics cache ----------------------------------------------


def _worker(imdb, spill="memory"):
    _, params, x_train, _ = imdb
    base = BaseModel(ImdbTransformer(), params, activation_layers=NC_TAPS, batch_size=64,
                     device="cpu")
    return CoverageWorker(base, x_train, spill=spill)


def _stats_equal(a, b) -> bool:
    return all(_same(x.numpy(), y.numpy()) for sa, sb in zip(a, b) for x, y in zip(sa, sb))


def test_coverage_stats_are_reused(imdb, tmp_path, monkeypatch):
    monkeypatch.setenv("TIP_COV_STATS_CACHE_DIR", str(tmp_path))
    cold = _worker(imdb)
    assert cold.stats_cache_outcome == "miss"
    [entry] = os.listdir(tmp_path)
    assert entry.startswith("cov_stats_") and entry.endswith(".pkl")
    warm = _worker(imdb)
    assert warm.stats_cache_outcome == "hit" and _stats_equal(warm.stats, cold.stats)
    x = imdb[3]["ood"]
    _, cold_scores, cold_orders = cold.evaluate_all(x, "ood")
    _, warm_scores, warm_orders = warm.evaluate_all(x, "ood")
    for metric in cold_scores:
        assert _same(warm_scores[metric], cold_scores[metric])
        assert _same(warm_orders[metric], cold_orders[metric])


def test_coverage_debits_of_a_hit_are_the_load(imdb, tmp_path, monkeypatch):
    monkeypatch.setenv("TIP_COV_STATS_CACHE_DIR", str(tmp_path))
    _worker(imdb)
    load = CoverageStatsCache.load

    def slow_load(cache, device):
        time.sleep(0.2)
        return load(cache, device)

    monkeypatch.setattr(CoverageStatsCache, "load", slow_load)
    warm = _worker(imdb)
    assert warm.stats_cache_outcome == "hit"
    for metric, setup in warm.setup_times.items():
        if metric.startswith(("NBC", "SNAC", "KMNC")):
            assert 0.2 <= setup < 0.5, metric
        else:
            assert setup < 0.2, metric


def test_corrupt_and_stale_coverage_entries_recompute(imdb, tmp_path, monkeypatch):
    monkeypatch.setenv("TIP_COV_STATS_CACHE_DIR", str(tmp_path))
    cold = _worker(imdb)
    [entry] = os.listdir(tmp_path)
    good = (tmp_path / entry).read_bytes()
    (tmp_path / entry).write_bytes(b"not a pickle")
    again = _worker(imdb)
    assert again.stats_cache_outcome == "miss" and _stats_equal(again.stats, cold.stats)
    assert (tmp_path / entry).read_bytes() == good  # the recompute overwrote it
    stale = pickle.loads(good)
    stale["meta"]["fingerprint"] = "deadbeef"
    (tmp_path / entry).write_bytes(pickle.dumps(stale))
    assert _worker(imdb).stats_cache_outcome == "miss"


def test_coverage_cache_off(imdb, tmp_path, monkeypatch):
    monkeypatch.setenv("TIP_ASSETS", str(tmp_path))
    monkeypatch.setenv("TIP_COV_STATS_CACHE_DIR", "off")
    assert _worker(imdb).stats_cache_outcome == "off"
    assert os.listdir(tmp_path) == []


# -- isolation from the JAX package's entries -----------------------------------


def _jax_env(monkeypatch):
    for var, value in (("TIP_CLUSTER_BACKEND", "jax"), ("TIP_SA_POOL", "1"),
                       ("TIP_SA_PIPELINE", "0"), ("TIP_SA_FANOUT", "0"),
                       ("TIP_CAM_BACKEND", "auto")):
        monkeypatch.setenv(var, value)
    monkeypatch.delenv("TIP_FUSED_CHAIN", raising=False)


def _snapshot(folder):
    return {n: (folder / n).read_bytes() for n in sorted(os.listdir(folder))}


def test_the_packages_never_load_each_others_sa_entries(imdb, tmp_path, monkeypatch):
    _jax_env(monkeypatch)
    monkeypatch.setenv("TIP_SA_CACHE_DIR", str(tmp_path))
    tree, _, x_train, datasets = imdb
    nominal = {"nominal": datasets["nominal"]}

    def jax_run():
        handler = jax_surprise.SurpriseHandler(FlaxImdbTransformer(), tree, SA_TAP, x_train,
                                               case_study="imdb", model_id=0)
        handler.evaluate_all(nominal, dsa_badge_size=DSA_BADGE)

    port = _handler(imdb)
    port.evaluate_all(nominal)
    assert port.cache_outcomes == dict.fromkeys(SA_NAMES, "fit")
    port_entries = _snapshot(tmp_path)
    jax_run()  # misses: it stores five entries of its own
    assert len(os.listdir(tmp_path)) == 2 * len(SA_NAMES)
    jax_entries = {n: b for n, b in _snapshot(tmp_path).items() if n not in port_entries}
    assert {n: _snapshot(tmp_path)[n] for n in port_entries} == port_entries
    again = _handler(imdb)
    again.evaluate_all(nominal)
    assert again.cache_outcomes == dict.fromkeys(SA_NAMES, "hit")
    jax_run()  # hits its own
    assert _snapshot(tmp_path) == {**port_entries, **jax_entries}


def test_the_packages_never_load_each_others_coverage_entries(imdb, tmp_path, monkeypatch):
    _jax_env(monkeypatch)
    monkeypatch.setenv("TIP_COV_STATS_CACHE_DIR", str(tmp_path))
    tree, _, x_train, _ = imdb

    def jax_worker():
        base = JaxBaseModel(FlaxImdbTransformer(), tree, activation_layers=NC_TAPS,
                            batch_size=64)
        return jax_coverage.CoverageWorker(base, training_set=x_train, spill="memory")

    assert _worker(imdb).stats_cache_outcome == "miss"
    port_entry = _snapshot(tmp_path)
    assert jax_worker().stats_cache_outcome == "miss"
    assert len(os.listdir(tmp_path)) == 2
    assert _worker(imdb).stats_cache_outcome == "hit"
    assert jax_worker().stats_cache_outcome == "hit"
    assert {n: _snapshot(tmp_path)[n] for n in port_entry} == port_entry


# -- active learning on test_prio's fits -----------------------------------------


def _mini_study():
    spec = MINI_CASE_STUDIES["mini-mnist"]
    return CaseStudy(dataclasses.replace(
        spec, loader=image_loader((28, 28, 1), seed=41, n_train=100, n_test=30),
        train_cfg=dataclasses.replace(spec.train_cfg, epochs=1), sa_activation_layers=(6,)))


def _al_pickles(root):
    folder = os.path.join(root, "active_learning")
    return {n: open(os.path.join(folder, n), "rb").read() for n in sorted(os.listdir(folder))}


def test_active_learning_runs_on_the_fits_of_test_prio(tmp_path, monkeypatch):
    warm, off = tmp_path / "warm", tmp_path / "off"
    outcomes = []
    evaluate_all = SurpriseHandler.evaluate_all

    def recording(handler, *args, **kwargs):
        out = evaluate_all(handler, *args, **kwargs)
        outcomes.append(dict(handler.cache_outcomes))
        return out

    monkeypatch.setattr(SurpriseHandler, "evaluate_all", recording)
    monkeypatch.setenv("TIP_ASSETS", str(warm))
    cs = _mini_study()
    cs.train([0], device="cpu")
    cs.run_prio_eval([0], device="cpu")
    cs.run_active_learning_eval([0], device="cpu")
    assert outcomes == [dict.fromkeys(SA_NAMES, "fit"), dict.fromkeys(SA_NAMES, "hit")]
    monkeypatch.setenv("TIP_ASSETS", str(off))
    for var in ("TIP_SA_CACHE_DIR", "TIP_COV_STATS_CACHE_DIR"):
        monkeypatch.setenv(var, "off")
    shutil.copytree(warm / "models", off / "models")
    cs.run_active_learning_eval([0], device="cpu")
    assert outcomes[-1] == dict.fromkeys(SA_NAMES, "off")
    got, want = _al_pickles(warm), _al_pickles(off)
    assert len(got) == 81 and got == want


# -- the coverage spill ------------------------------------------------------------


def test_disk_spill_equals_memory_and_cleans_up(imdb, tmp_path, monkeypatch):
    monkeypatch.setenv("TIP_ASSETS", str(tmp_path))
    memory, disk = _worker(imdb, "memory"), _worker(imdb, "disk")
    for ds, x in imdb[3].items():
        _, m_scores, m_orders = memory.evaluate_all(x, ds)
        _, d_scores, d_orders = disk.evaluate_all(x, ds)
        assert set(d_scores) == set(m_scores) and len(m_scores) == 12
        for metric in m_scores:
            assert _same(d_scores[metric], m_scores[metric]), (ds, metric)
            assert _same(d_orders[metric], m_orders[metric]), (ds, metric)
        assert not os.path.exists(disk._temp_root())
    assert os.listdir(tmp_path / ".tmp") == []


def test_auto_spill_resolves_by_free_memory(imdb, tmp_path, monkeypatch):
    monkeypatch.setenv("TIP_ASSETS", str(tmp_path))
    worker = _worker(imdb, "auto")
    x = imdb[3]["nominal"]
    monkeypatch.setattr(coverage_handler, "free_memory", lambda device: 0)
    assert worker._resolve_spill(x) == "disk"
    _, scores, _ = worker.evaluate_all(x, "nominal")
    assert len(scores) == 12 and os.listdir(tmp_path / ".tmp") == []
    monkeypatch.setattr(coverage_handler, "free_memory", lambda device: 1 << 40)
    assert worker._resolve_spill(x) == "memory"
    monkeypatch.undo()
    assert coverage_handler.free_memory(torch.device("cpu")) > 0
    with pytest.raises(ValueError, match="spill"):
        _worker(imdb, "swap")
