"""The caches' obs counters and retry scope against the JAX package's, on
the CPU.

The same events go through both packages' ``SAFitCache`` and
``CoverageStatsCache`` (each in a directory of its own): a miss, a store,
a hit, a stale entry (same file, another fingerprint), a corrupt entry and,
for the SA cache under ``TIP_SA_CACHE_MAX_BYTES``, an eviction. After each
event the increments of every ``sa_fit_cache.*`` / ``cov_stats_cache.*``
counter are equal in the two packages' metrics registries. A transient
``OSError`` on an SA entry's read is retried under the ``sa_cache`` scope
(``TIP_RETRY_SA_CACHE_*``), then the entry is a hit; a corrupt entry counts
in ``sa_fit_cache.corrupt``, one of the port's ``obs regress`` health
counters.
"""

import builtins
import os

import numpy as np
import pytest
import torch

from simple_tip_tpu.engine import coverage_stats_cache as jax_cov
from simple_tip_tpu.engine import sa_prep as jax_sa
from simple_tip_tpu.obs import metrics as jax_metrics
from simple_tip_tpu_torch.engine import coverage_stats_cache as cov
from simple_tip_tpu_torch.engine import sa_prep
from simple_tip_tpu_torch.obs import metrics
from simple_tip_tpu_torch.obs.regress import HEALTH_COUNTERS
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
FP = "a" * 16 + "1" * 48
OTHER_FP = "a" * 16 + "2" * 48  # the same entry file, another fingerprint


def _counts(registry, prefix):
    return {k: v for k, v in registry.snapshot()["counters"].items() if k.startswith(prefix)}


def _delta(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


class _Both:
    """Runs one event in both packages and returns each package's counter
    increments under ``prefix``."""

    def __init__(self, prefix):
        self.prefix = prefix

    def __call__(self, port_event, jax_event):
        before = _counts(metrics, self.prefix), _counts(jax_metrics, self.prefix)
        port_event()
        jax_event()
        after = _counts(metrics, self.prefix), _counts(jax_metrics, self.prefix)
        return _delta(before[0], after[0]), _delta(before[1], after[1])


def _garble(path):
    with open(path, "wb") as f:
        f.write(b"\x80\x04not a pickle")


@pytest.fixture()
def dirs(tmp_path, monkeypatch):
    for var in ("TIP_SA_CACHE_MAX_BYTES", "TIP_FAULT_PLAN"):
        monkeypatch.delenv(var, raising=False)
    return tmp_path / "port", tmp_path / "jax"


def test_sa_fit_cache_counts_its_events_as_jax(dirs, monkeypatch):
    port_dir, jax_dir = dirs
    scorer = {"w": torch.arange(6.0)}
    port = sa_prep.SAFitCache(str(port_dir), "mnist", "0", FP, CPU)
    jax = jax_sa.SAFitCache(str(jax_dir), "mnist", "0", FP)
    both = _Both("sa_fit_cache.")

    assert both(lambda: port.load("dsa"), lambda: jax.load("dsa")) == (
        {"sa_fit_cache.miss": 1},) * 2
    assert both(lambda: port.store("dsa", scorer), lambda: jax.store("dsa", {"w": np.arange(6.0)})
                ) == ({"sa_fit_cache.store": 1},) * 2
    got = {}
    assert both(lambda: got.setdefault("port", port.load("dsa")), lambda: jax.load("dsa")) == (
        {"sa_fit_cache.hit": 1},) * 2
    assert torch.equal(got["port"]["w"], scorer["w"])
    stale = sa_prep.SAFitCache(str(port_dir), "mnist", "0", OTHER_FP, CPU)
    jax_stale = jax_sa.SAFitCache(str(jax_dir), "mnist", "0", OTHER_FP)
    assert stale.path("dsa") == port.path("dsa")
    assert both(lambda: stale.load("dsa"), lambda: jax_stale.load("dsa")) == (
        {"sa_fit_cache.stale": 1},) * 2
    _garble(port.path("dsa"))
    _garble(jax.describe("dsa"))
    assert both(lambda: port.load("dsa"), lambda: jax.load("dsa")) == (
        {"sa_fit_cache.corrupt": 1},) * 2
    assert any("sa_fit_cache.corrupt".startswith(h) for h in HEALTH_COUNTERS)

    # a cap that holds one entry: the second store evicts the first
    monkeypatch.setenv("TIP_SA_CACHE_MAX_BYTES", "1")
    assert both(lambda: port.store("pc-lsa", scorer),
                lambda: jax.store("pc-lsa", {"w": np.arange(6.0)})) == (
        {"sa_fit_cache.store": 1, "sa_fit_cache.evict": 1},) * 2
    assert sorted(os.listdir(port_dir)) == [os.path.basename(port.path("pc-lsa"))]


def test_coverage_stats_cache_counts_its_events_as_jax(dirs):
    port_dir, jax_dir = dirs
    stats = ([np.arange(4.0, dtype=np.float32)],) * 3
    port, jax = cov.CoverageStatsCache(str(port_dir), FP), jax_cov.CoverageStatsCache(
        str(jax_dir), FP)
    both = _Both("cov_stats_cache.")
    assert both(lambda: port.load(CPU), jax.load) == ({"cov_stats_cache.miss": 1},) * 2
    assert both(lambda: port.store(tuple([torch.from_numpy(a) for a in s] for s in stats)),
                lambda: jax.store(stats)) == ({"cov_stats_cache.store": 1},) * 2
    assert both(lambda: port.load(CPU), jax.load) == ({"cov_stats_cache.hit": 1},) * 2
    stale = cov.CoverageStatsCache(str(port_dir), OTHER_FP)
    jax_stale = jax_cov.CoverageStatsCache(str(jax_dir), OTHER_FP)
    assert both(lambda: stale.load(CPU), jax_stale.load) == ({"cov_stats_cache.stale": 1},) * 2
    _garble(port.path)
    _garble(jax.path)
    assert both(lambda: port.load(CPU), jax.load) == ({"cov_stats_cache.corrupt": 1},) * 2


def test_sa_cache_reads_retry_a_transient_error(dirs, monkeypatch):
    port_dir, _ = dirs
    monkeypatch.setenv("TIP_RETRY_SA_CACHE_BASE_S", "0")
    port = sa_prep.SAFitCache(str(port_dir), "mnist", "0", FP, CPU)
    port.store("dsa", {"w": torch.ones(2)})
    real_open, failures = builtins.open, []

    def flaky_open(path, *args, **kwargs):
        if str(path) == port.path("dsa") and not failures:
            failures.append(path)
            raise OSError("the shared mount blinked")
        return real_open(path, *args, **kwargs)

    before = _counts(metrics, "")
    monkeypatch.setattr(builtins, "open", flaky_open)
    got = port.load("dsa")
    monkeypatch.setattr(builtins, "open", real_open)
    assert failures and torch.equal(got["w"], torch.ones(2))
    delta = _delta(before, _counts(metrics, ""))
    assert delta == {"retry.attempts": 1, "sa_fit_cache.hit": 1}

    # attempts spent: the entry is a corrupt miss, and the give-up is counted
    monkeypatch.setenv("TIP_RETRY_SA_CACHE_ATTEMPTS", "1")
    failures.clear()
    monkeypatch.setattr(builtins, "open", flaky_open)
    before = _counts(metrics, "")
    assert port.load("dsa") is None
    monkeypatch.setattr(builtins, "open", real_open)
    assert _delta(before, _counts(metrics, "")) == {"retry.giveups": 1,
                                                    "sa_fit_cache.corrupt": 1}
