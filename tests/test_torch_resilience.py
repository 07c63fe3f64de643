"""The port's fault injection, run journal, watchdog and obs helpers against
the JAX package's, on the CPU.

- A fault plan parsed by both packages fires the same faults, in the same
  order, for the same sites and identities (``times`` budgets, ``p`` gates,
  ``error`` kinds, match lists), each from its own claim-marker directory.
- A journal written by the JAX ``RunJournal`` reads back in the port's with
  the same completed set, and the reverse; both resolve the same path under
  one ``TIP_ASSETS``; a torn tail (the ``journal.append`` fault) is skipped
  by both and healed by the next append; compaction keeps one record per
  unit in either package.
- A torn ``artifact.write`` raises ``InjectedFault``, leaves the
  destination as it was and no tmp file behind, as the JAX writer does.
- A ``corrupt`` ``sa_cache.load`` is a logged miss and a refit, whose
  scores equal the intact entry's hit.
- The watchdog under a ``watchdog.probe`` timeout plan raises
  ``BackendUnavailable`` and opens the breaker: the deliberate difference
  from the JAX package, whose ``ensure_responsive_backend`` returns
  ``"cpu"`` there and switches the process to the CPU backend. Hidden cards
  count 0 without a probe; unplanned probes run forked from a forkserver
  (the caller imports no torch) and refuse this CPU-only torch.
- The obs helpers: the worker log bridge installs once, the device-memory
  gauges record nothing in a process without a CUDA context, and the
  kernel launch gauges read the wrappers' counters.
"""

import json
import logging
import os
import subprocess
import sys

import pytest

from simple_tip_tpu.resilience import faults as jax_faults
from simple_tip_tpu.resilience import journal as jax_journal
from simple_tip_tpu.utils import artifacts_io as jax_artifacts_io
from simple_tip_tpu_torch import obs
from simple_tip_tpu_torch.engine import sa_prep
from simple_tip_tpu_torch.obs import logbridge
from simple_tip_tpu_torch.resilience import (
    BackendUnavailable,
    CircuitBreaker,
    InjectedFault,
    faults,
    journal,
)
from simple_tip_tpu_torch.utils import artifacts_io, device_watchdog
from test_torch_fit_caches import _handler, imdb  # noqa: F401 (fixture)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PLANS = {
    "budgets": {"faults": [
        {"site": "worker.run", "kind": "timeout", "match": {"model_id": [1, 3]}, "times": 1},
        {"site": "worker.run", "kind": "fail", "match": {"phase": "test_prio"}, "times": 2},
        {"site": "artifact.write", "kind": "torn", "times": 0},
    ]},
    "probabilities": {"seed": 7, "faults": [
        {"site": "worker.run", "kind": "corrupt", "match": {"model_id": list(range(20))},
         "times": 0, "p": 0.4},
        {"site": "heartbeat.drop", "kind": "fail", "match": {"host": "h1"}, "p": 0.5, "times": 3},
    ]},
    "errors": {"seed": 3, "faults": [
        {"site": "lease.steal", "kind": "error", "match": {"unit": ["a", "b"]}, "times": 1,
         "msg": "denied"},
        {"site": "lease.steal", "kind": "fail", "times": 0},
        {"site": "no.such.site", "kind": "fail"},
    ]},
}

CALLS = (
    [("worker.run", {"phase": "test_prio", "model_id": i}) for i in range(6)]
    + [("worker.run", {"phase": "al", "model_id": i}) for i in range(20)]
    + [("artifact.write", {"path": f"/x/{i}"}) for i in range(3)]
    + [("heartbeat.drop", {"host": h}) for h in ("h1", "h2", "h1", "h1", "h1", "h1")]
    + [("lease.steal", {"unit": u, "owner": "o"}) for u in ("a", "b", "a", "c", "b")]
)


def _fired(module, spec, state_dir):
    plan = module.FaultPlan(spec, state_dir=state_dir)
    out = []
    for site, attrs in CALLS:
        try:
            fault = plan.fire(site, **attrs)
        except Exception as e:  # noqa: BLE001 - the error kind raises
            out.append((site, type(e).__name__, str(e)))
            continue
        out.append(None if fault is None else (site, fault.index, fault.kind,
                                               fault.identity(attrs)))
    return out


@pytest.mark.parametrize("name", sorted(PLANS))
def test_fault_plans_fire_as_in_jax(name, tmp_path):
    got = _fired(faults, PLANS[name], str(tmp_path / "port"))
    want = _fired(jax_faults, PLANS[name], str(tmp_path / "jax"))
    assert got == want
    assert any(f is not None for f in got)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))


def test_env_plan_grammar_and_state_dir_default(tmp_path, monkeypatch):
    plan_file = tmp_path / "plan.json"
    plan_file.write_text(json.dumps(PLANS["budgets"]))
    monkeypatch.setenv("TIP_ASSETS", str(tmp_path / "assets"))
    monkeypatch.delenv("TIP_FAULT_STATE", raising=False)
    monkeypatch.setenv("TIP_FAULT_PLAN", "@" + str(plan_file))
    plan = faults.active_plan()
    assert plan.state_dir == str(tmp_path / "assets" / "fault_state")
    assert faults.maybe_inject("worker.run", phase="x", model_id=3).kind == "timeout"
    assert faults.maybe_inject("worker.run", phase="x", model_id=3) is None
    monkeypatch.setenv("TIP_FAULT_PLAN", "{not json")
    with pytest.raises(ValueError, match="unparsable"):
        faults.maybe_inject("worker.run")
    monkeypatch.delenv("TIP_FAULT_PLAN")
    assert faults.maybe_inject("worker.run", model_id=3) is None


# -- the journal -------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_is_shared_with_the_jax_package(writer, tmp_path, monkeypatch):
    monkeypatch.setenv("TIP_ASSETS", str(tmp_path / "assets"))
    monkeypatch.delenv("TIP_JOURNAL", raising=False)
    monkeypatch.delenv("TIP_FAULT_PLAN", raising=False)
    mods = {"jax": jax_journal, "port": journal}
    reader = "port" if writer == "jax" else "jax"
    w = mods[writer].journal_from_env("mnist", "test_prio")
    r = mods[reader].journal_from_env("mnist", "test_prio")
    assert w.path == r.path == str(tmp_path / "assets" / "journal" / "runs.jsonl")
    for m in (0, 3, 5):
        w.mark_done(m)
    mods[writer].RunJournal(w.path, "mnist", "active_learning").mark_done(7)
    assert r.completed() == {0, 3, 5}
    assert mods[reader].RunJournal(r.path, "mnist", "active_learning").completed() == {7}
    assert mods[reader].RunJournal(r.path, "imdb", "test_prio").completed() == set()
    monkeypatch.setenv("TIP_JOURNAL", "off")
    assert journal.journal_from_env("mnist", "test_prio") is None
    monkeypatch.setenv("TIP_JOURNAL", "")
    monkeypatch.delenv("TIP_ASSETS")
    assert journal.journal_from_env("mnist", "test_prio") is None


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_torn_tail_is_skipped_and_healed(writer, tmp_path, monkeypatch):
    mods = {"jax": (jax_journal, jax_faults), "port": (journal, faults)}
    path = str(tmp_path / "runs.jsonl")
    plan = {"faults": [{"site": "journal.append", "kind": "torn", "match": {"model_id": 2}}]}
    monkeypatch.setenv("TIP_FAULT_PLAN", json.dumps(plan))
    monkeypatch.setenv("TIP_FAULT_STATE", str(tmp_path / "state"))
    w = mods[writer][0].RunJournal(path, "mnist", "p")
    for m in (1, 2):
        w.mark_done(m)
    with open(path, "rb") as f:
        assert not f.read().endswith(b"\n")  # the torn half line
    for mod, _ in mods.values():
        assert mod.RunJournal(path, "mnist", "p").completed() == {1}
    w.mark_done(3)
    for mod, _ in mods.values():
        assert mod.RunJournal(path, "mnist", "p").completed() == {1, 3}


def test_compaction_keeps_one_record_per_unit_in_both(tmp_path, monkeypatch):
    monkeypatch.delenv("TIP_FAULT_PLAN", raising=False)
    kept = {}
    for name, mod in (("jax", jax_journal), ("port", journal)):
        path = str(tmp_path / f"{name}.jsonl")
        monkeypatch.delenv("TIP_JOURNAL_MAX_BYTES", raising=False)
        j = mod.RunJournal(path, "mnist", "p")
        for m in (0, 1, 0, 1, 0, 2):
            j.mark_done(m)
        mod.RunJournal(path, "imdb", "p").mark_done(0)
        monkeypatch.setenv("TIP_JOURNAL_MAX_BYTES", "200")
        j.mark_done(3)
        with open(path) as f:
            recs = [json.loads(line) for line in f]
        kept[name] = [(r["case_study"], r["phase"], r["model_id"]) for r in recs]
    assert kept["port"] == kept["jax"] == [
        ("mnist", "p", 0), ("mnist", "p", 1), ("mnist", "p", 2), ("imdb", "p", 0),
        ("mnist", "p", 3)]


def test_journal_open_sweeps_aged_orphan_tmp(tmp_path, monkeypatch):
    folder = tmp_path / "journal"
    folder.mkdir()
    orphan, young, foreign = folder / "runs.jsonl.123.tmp", folder / "x.456.tmp", folder / "a.tmp"
    for p in (orphan, young, foreign):
        p.write_text("x")
    os.utime(orphan, (0, 0))
    monkeypatch.setenv("TIP_JOURNAL", str(folder / "runs.jsonl"))
    journal.journal_from_env("mnist", "p")
    assert sorted(os.listdir(folder)) == ["a.tmp", "x.456.tmp"]


# -- the write and read seams ------------------------------------------------------


@pytest.mark.parametrize("module", [artifacts_io, jax_artifacts_io], ids=["port", "jax"])
def test_torn_artifact_write_leaves_the_destination_and_no_tmp(module, tmp_path, monkeypatch):
    dest = tmp_path / "a.npy"
    dest.write_bytes(b"old bytes")
    plan = {"faults": [{"site": "artifact.write", "kind": "torn", "times": 1}]}
    monkeypatch.setenv("TIP_FAULT_PLAN", json.dumps(plan))
    monkeypatch.setenv("TIP_FAULT_STATE", str(tmp_path / "state"))
    with pytest.raises(Exception) as e:
        module.atomic_write_bytes(str(dest), b"new payload " * 10)
    assert type(e.value).__name__ == "InjectedFault"
    if module is artifacts_io:
        assert isinstance(e.value, InjectedFault)
    assert dest.read_bytes() == b"old bytes"
    assert sorted(os.listdir(tmp_path)) == ["a.npy", "state"]
    module.atomic_write_bytes(str(dest), b"new")  # the budget is spent
    assert dest.read_bytes() == b"new"


def test_corrupt_sa_cache_entry_is_a_logged_miss_and_refit(imdb, tmp_path, monkeypatch,  # noqa: F811
                                                            caplog):
    monkeypatch.setenv("TIP_SA_CACHE_DIR", str(tmp_path / "cache"))
    names = ("dsa", "pc-mdsa")
    cold = _handler(imdb, sa_names=names)
    cold.evaluate_all({"nominal": imdb[3]["nominal"]})
    plan = {"faults": [{"site": "sa_cache.load", "kind": "corrupt",
                        "match": {"variant": "pc-mdsa"}, "times": 1}]}
    monkeypatch.setenv("TIP_FAULT_PLAN", json.dumps(plan))
    monkeypatch.setenv("TIP_FAULT_STATE", str(tmp_path / "state"))
    refit = _handler(imdb, sa_names=names)
    with caplog.at_level(logging.WARNING, logger=sa_prep.__name__):
        refit_results, _ = refit.evaluate_all({"nominal": imdb[3]["nominal"]})
    assert "corrupt" in caplog.text
    assert refit.cache_outcomes == {"dsa": "hit", "pc-mdsa": "fit"}
    hit = _handler(imdb, sa_names=names)
    hit_results, _ = hit.evaluate_all({"nominal": imdb[3]["nominal"]})
    assert hit.cache_outcomes == {"dsa": "hit", "pc-mdsa": "hit"}
    for name in names:  # (scores, SC-CAM order, seconds): the arrays byte-equal
        got, want = refit_results[name]["nominal"], hit_results[name]["nominal"]
        for a, b in zip(got[:2], want[:2]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


# -- the watchdog ------------------------------------------------------------------


@pytest.fixture()
def breaker_file(tmp_path, monkeypatch):
    path = tmp_path / "breaker_state.json"
    monkeypatch.setenv("TIP_BREAKER_STATE", str(path))
    monkeypatch.setenv("TIP_FAULT_STATE", str(tmp_path / "state"))
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    device_watchdog._chip_probe_cache.clear()
    yield path
    device_watchdog._chip_probe_cache.clear()


@pytest.mark.parametrize("mode", ["degrade", "fail"])
def test_watchdog_raises_and_opens_the_breaker(breaker_file, monkeypatch, mode):
    """Where the JAX watchdog returns "cpu" (and rebinds the process to the
    CPU backend), the port raises: in both breaker modes."""
    monkeypatch.setenv("TIP_BREAKER_MODE", mode)
    monkeypatch.setenv("TIP_FAULT_PLAN", json.dumps(
        {"faults": [{"site": "watchdog.probe", "kind": "timeout", "times": 0}]}))
    for _ in range(2):
        with pytest.raises(BackendUnavailable, match="probe-timeout"):
            device_watchdog.ensure_responsive_backend(timeout_s=1.0)
        assert device_watchdog.degradation_reason() == "probe-timeout"
    assert CircuitBreaker.from_env().state() == "open"
    with pytest.raises(BackendUnavailable, match="breaker-open"):
        device_watchdog.ensure_responsive_backend(timeout_s=1.0)
    assert device_watchdog.degradation_reason() == "breaker-open"
    assert device_watchdog.probe_local_chips(timeout_s=1.0) == 0  # short-circuit


def test_probe_failure_counts_zero_cards_and_hidden_cards_skip_the_probe(breaker_file,
                                                                          monkeypatch):
    monkeypatch.setenv("TIP_FAULT_PLAN", json.dumps(
        {"faults": [{"site": "watchdog.probe", "kind": "fail", "times": 1}]}))
    assert device_watchdog.probe_local_chips(timeout_s=2.0) == 0
    assert json.loads(breaker_file.read_text())["failures"] == 1
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert device_watchdog.probe_local_chips(timeout_s=3.0) == 0
    with pytest.raises(BackendUnavailable, match="hides every card"):
        device_watchdog.ensure_responsive_backend()


def test_real_probes_run_in_forked_children_and_refuse_a_cpu_only_torch(tmp_path):
    """Without a fault plan the probes run: forked from a forkserver that
    imported torch, so the caller imports none and the second probe is
    quick; on this CPU-only torch the card count is 0 and the op fails."""
    code = (
        "import json, sys, time\n"
        "from simple_tip_tpu_torch.utils import device_watchdog as w\n"
        "def main():\n"
        "    out = {'chips': w.probe_local_chips(60.0)}\n"
        "    t0 = time.perf_counter()\n"
        "    try:\n"
        "        w.ensure_responsive_backend(60.0)\n"
        "    except w.BackendUnavailable as e:\n"
        "        out['error'] = str(e)\n"
        "    out['second_s'] = time.perf_counter() - t0\n"
        "    out['reason'] = w.degradation_reason()\n"
        "    out['torch'] = 'torch' in sys.modules\n"
        "    print(json.dumps(out))\n"
        "if __name__ == '__main__':\n"
        "    main()\n"
    )
    script = tmp_path / "probe.py"
    script.write_text(code)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("TIP_", "CUDA_VISIBLE"))}
    env["TIP_BREAKER_STATE"] = "off"
    env["PYTHONPATH"] = os.pathsep.join([ROOT, env.get("PYTHONPATH", "")])
    done = subprocess.run([sys.executable, str(script)], env=env, capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out["chips"] == 0 and out["reason"] == "probe-fail" and not out["torch"]
    assert "probe exited 1" in out["error"] and out["second_s"] < 30


# -- the obs helpers ---------------------------------------------------------------


def test_worker_logging_installs_once(monkeypatch):
    root = logging.getLogger()
    before = list(root.handlers)
    monkeypatch.setattr(root, "handlers", [])
    logbridge.reset()
    try:
        logbridge.install_worker_logging("3")
        logbridge.install_worker_logging("3")
        assert len(root.handlers) == 1
        assert "[" in root.handlers[0].formatter._fmt and "/3]" in root.handlers[0].formatter._fmt
    finally:
        root.handlers = before
        logbridge.reset()


def test_device_and_kernel_gauges():
    from simple_tip_tpu_torch.ops import dsa_cuda, fused_forward, launch_counts

    obs.reset_all()
    obs.record_device_memory()  # no CUDA context in this process: nothing
    assert not any(k.startswith("device.") for k in obs.metrics_snapshot()["gauges"])
    launches = fused_forward.LAUNCHES, dsa_cuda.LAUNCHES
    fused_forward.LAUNCHES, dsa_cuda.LAUNCHES = 3, 5
    try:
        obs.record_kernel_launches(launch_counts())
        gauges = obs.metrics_snapshot()["gauges"]
        assert gauges["kernel.fused_mnist_forward.launches"] == 3
        assert gauges["kernel.dsa_nearest.launches"] == 5
    finally:
        fused_forward.LAUNCHES, dsa_cuda.LAUNCHES = launches
        obs.reset_all()
