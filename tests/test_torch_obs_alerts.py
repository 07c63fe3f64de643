"""The port's SLO rules and alert evaluator (``simple_tip_tpu_torch/obs/
slo.py``, ``alerts.py``) against the JAX package's, and their mounts.

One seeded sample stream (breaker, latency, shed, crash and churn metrics)
and one injected clock go through an evaluator of each package over the
same rule document (the bundled rules plus test-sized ones): every
transition, the alert log, the incident records (open and closed) and the
rendered ``obs alerts`` / ``obs incidents`` views are equal. Rule documents
resolve and validate alike, and ``sample_rule`` / ``burn_rate`` agree.

The mounts are the JAX package's: the scoring engine ticks the evaluator
on each scheduler wakeup, on ``close()`` and when its scheduler task
crashes; the exporter serves the evaluator's view on ``/alerts``.
"""

import asyncio
import json
import os
import urllib.request

import numpy as np
import pytest

import simple_tip_tpu.obs as jax_obs
import simple_tip_tpu_torch.obs as obs
from simple_tip_tpu.obs import alerts as jax_alerts
from simple_tip_tpu.obs import slo as jax_slo
from simple_tip_tpu_torch.obs import alerts, exporter, slo
from simple_tip_tpu_torch.serving import EngineClosed, ScoringEngine, ServingKnobs, StubExecutor
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

BASE = 1.7e9
TEST_RULES = [
    {"name": "breaker-fast", "severity": "page", "budget": 0.05, "for_s": 2.0,
     "objective": {"kind": "gauge", "metric": "breaker.open", "op": "<=", "threshold": 0.0},
     "windows": {"fast": {"window_s": 10.0, "burn": 1.0},
                 "slow": {"window_s": 30.0, "burn": 0.5}}},
    {"name": "latency-fast", "severity": "warn", "budget": 0.1, "for_s": 0.0,
     "objective": {"kind": "quantile", "metric": "serving.request_ms", "field": "p99",
                   "op": "<=", "threshold": 50.0},
     "windows": {"fast": {"window_s": 6.0, "burn": 3.0},
                 "slow": {"window_s": 20.0, "burn": 1.0}}},
    {"name": "shed-fast", "severity": "page", "budget": 0.2, "for_s": 1.0,
     "objective": {"kind": "ratio", "num": "serving.shed",
                   "den": ["serving.rows", "serving.shed"]},
     "windows": {"fast": {"window_s": 8.0, "burn": 1.5},
                 "slow": {"window_s": 24.0, "burn": 0.8}}},
    {"name": "crash-fast", "severity": "page", "budget": 0.1, "for_s": 1.0,
     "objective": {"kind": "counter_delta", "metrics": ["serving.scheduler_crashes"]},
     "windows": {"fast": {"window_s": 6.0, "burn": 1.0},
                 "slow": {"window_s": 20.0, "burn": 0.5}}},
    {"name": "bad rule", "severity": "loud", "objective": {"kind": "nope"}},
]


def _doc():
    return {"schema": 1, "rules": jax_slo.DEFAULT_RULES["rules"] + TEST_RULES}


def sample_stream(seed: int, n: int = 80) -> list:
    """Seeded metrics snapshots: a breaker that opens and closes, a p99
    that spikes, a shed burst, one scheduler crash."""
    rng = np.random.default_rng(seed)
    snaps, rows, shed, crashes, requeues = [], 0, 0, 0, 0
    for i in range(n):
        rows += int(rng.integers(100, 200))
        if 30 <= i < 40:
            shed += int(rng.integers(50, 150))
        if i == 50:
            crashes += 1
        if rng.random() < 0.05:
            requeues += 1
        p99 = float(rng.uniform(5, 20) if not 15 <= i < 22 else rng.uniform(80, 200))
        snaps.append({
            "counters": {"serving.rows": rows, "serving.shed": shed,
                         "serving.scheduler_crashes": crashes, "scheduler.requeues": requeues},
            "gauges": {"breaker.open": 1 if 5 <= i < 14 else 0,
                       "fleet.members_alive": 2},
            "histograms": {},
            "quantiles": {"serving.request_ms": {"p50": p99 / 3, "p95": p99 / 1.5, "p99": p99,
                                                 "count": i + 1}},
        })
    return snaps


@pytest.fixture(autouse=True)
def _isolation(tmp_path, monkeypatch):
    monkeypatch.setenv("TIP_ASSETS", str(tmp_path / "assets"))
    monkeypatch.delenv("TIP_OBS_DIR", raising=False)
    monkeypatch.delenv("TIP_ALERT_RULES", raising=False)
    monkeypatch.delenv("TIP_OBS_HTTP", raising=False)
    monkeypatch.delenv("TIP_PLAN_FILE", raising=False)
    obs.reset_all()
    jax_obs.reset_all()
    yield
    obs.reset_all()
    jax_obs.reset_all()


def test_rule_documents_resolve_and_validate_as_jax(tmp_path, monkeypatch):
    assert slo.DEFAULT_RULES == jax_slo.DEFAULT_RULES
    assert slo.validate(_doc()["rules"]) == jax_slo.validate(_doc()["rules"])
    for raw in ("builtin", json.dumps(_doc()), "off", "", "{not json", json.dumps({"rules": []})):
        monkeypatch.setenv(slo.RULES_ENV, raw)
        assert slo.rules_configured() == jax_slo.rules_configured()
        assert slo.load_rules() == jax_slo.load_rules()
    path = tmp_path / "rules.json"
    path.write_text(json.dumps(_doc()))
    for form in (f"@{path}", str(path)):
        assert slo.load_rules(form) == jax_slo.load_rules(form)
    monkeypatch.delenv(slo.RULES_ENV)
    assert slo.write_default_rules() == jax_slo.default_rules_path()
    assert slo.load_rules() == jax_slo.load_rules()


def test_sampling_and_burn_rates_equal_jax():
    rules = slo.validate(_doc()["rules"])[0]
    prev = None
    for snap in sample_stream(3, 40):
        for rule in rules:
            assert slo.sample_rule(rule, snap, prev, []) == \
                jax_slo.sample_rule(rule, snap, prev, [])
        prev = snap["counters"]
    samples = [[float(t), float(b)] for t, b in enumerate(np.random.default_rng(1).random(50))]
    for now, window, budget in ((49, 10.0, 0.1), (20, 4.0, 0.05), (200, 5.0, 0.1)):
        assert slo.burn_rate(samples, now, window, budget) == \
            jax_slo.burn_rate(samples, now, window, budget)
    assert slo.prune_samples(samples, 49, 7.0, cap=5) == \
        jax_slo.prune_samples(samples, 49, 7.0, cap=5)


def _drive(pkg_alerts, pkg_slo, state_dir: str, snaps) -> list:
    ev = pkg_alerts.Evaluator(
        rules_doc={"schema": 1, "source": "test", "rules": pkg_slo.validate(_doc()["rules"])[0]},
        state_dir=state_dir, min_interval_s=0.0,
    )
    history = []
    for i, snap in enumerate(snaps):
        history.append(ev.evaluate(snap, now=BASE + i))
    return history, ev


@pytest.mark.parametrize("seed", [0, 5])
def test_alert_sequences_and_incidents_equal_jax(seed, tmp_path, monkeypatch):
    monkeypatch.setenv("TIP_ALERT_SINKS", "jsonl")
    snaps = sample_stream(seed)
    got, ev = _drive(alerts, slo, str(tmp_path / "port"), snaps)
    want, jax_ev = _drive(jax_alerts, jax_slo, str(tmp_path / "jax"), snaps)
    assert got == want
    flat = [t for tick in got for t in tick]
    assert {(t["rule"], t["to"]) for t in flat} >= {
        ("breaker-fast", "firing"), ("breaker-fast", "resolved"), ("latency-fast", "firing"),
        ("latency-fast", "resolved"), ("shed-fast", "firing"), ("crash-fast", "firing"),
        ("breaker-open", "pending"), ("scheduler-churn", "pending")}
    with open(alerts.alerts_log_path(str(tmp_path / "port"))) as f:
        log = [json.loads(line) for line in f]
    with open(jax_alerts.alerts_log_path(str(tmp_path / "jax"))) as f:
        assert log == [json.loads(line) for line in f] and len(log) == len(flat)
    open_incs, closed = alerts.load_incidents(str(tmp_path / "port"))
    assert (open_incs, closed) == jax_alerts.load_incidents(str(tmp_path / "jax"))
    assert closed and all(inc["plan"] == "unplanned" for inc in closed)
    assert alerts.render_incidents(open_incs, closed) == \
        jax_alerts.render_incidents(open_incs, closed)
    state = alerts.load_state(str(tmp_path / "port"))
    jax_state = jax_alerts.load_state(str(tmp_path / "jax"))
    for doc in (state, jax_state):
        for key in ("pid", "updated_ts"):
            doc.pop(key)
    assert state == jax_state
    assert alerts.render_alerts(state) == jax_alerts.render_alerts(jax_state)
    view, jax_view = ev.view(), jax_ev.view()
    view.pop("state_dir"), jax_view.pop("state_dir")
    assert view == jax_view


def test_incidents_carry_the_active_plan(tmp_path, monkeypatch):
    """An incident opened under an execution plan names it (the port's
    own plan module resolves the fingerprint)."""
    from simple_tip_tpu_torch.plan import plan as plan_mod

    doc = plan_mod.build({"workers": 2}, {"by_phase": {}}, {"phases": ["x"]}, {}, {})
    plan_path = plan_mod.save(doc, str(tmp_path / "plan.json"))
    monkeypatch.setenv("TIP_PLAN_FILE", plan_path)
    monkeypatch.setenv("TIP_ALERT_SINKS", "off")
    _, ev = _drive(alerts, slo, str(tmp_path / "a"), sample_stream(0, 12))
    assert [inc["plan"] for inc in ev.view()["incidents_open"]] == [doc["plan_id"]]


def test_cli_alerts_and_incidents_exit_codes_equal_jax(tmp_path, monkeypatch, capsys):
    from simple_tip_tpu.obs.cli import main as jax_main
    from simple_tip_tpu_torch.obs.cli import main

    monkeypatch.setenv("TIP_ALERT_SINKS", "off")
    empty = str(tmp_path / "none")
    _drive(alerts, slo, str(tmp_path / "a"), sample_stream(0, 12))  # breaker firing
    for argv in (["alerts", "--state", empty], ["incidents", "--state", empty],
                 ["alerts", "--state", str(tmp_path / "a")],
                 ["alerts", "--state", str(tmp_path / "a"), "--json"],
                 ["incidents", "--state", str(tmp_path / "a")],
                 ["incidents", "--state", str(tmp_path / "a"), "--json", "--limit", "1"]):
        capsys.readouterr()
        rc = main(argv)
        out = capsys.readouterr().out
        assert (rc, out) == (jax_main(argv), capsys.readouterr().out)
    assert main(["alerts", "--state", str(tmp_path / "a")]) == 1  # a rule is firing
    assert main(["alerts", "--state", empty]) == 3


def _rules_env(monkeypatch, tmp_path, rule_names):
    rules = [r for r in TEST_RULES if r["name"] in rule_names]
    monkeypatch.setenv("TIP_ALERT_RULES", json.dumps({"schema": 1, "rules": rules}))
    monkeypatch.setenv("TIP_ALERT_STATE", str(tmp_path / "alerts"))
    monkeypatch.setenv("TIP_ALERT_EVAL_S", "0")
    monkeypatch.setenv("TIP_ALERT_SINKS", "off")


def test_engine_ticks_the_evaluator_per_wakeup_and_on_close(tmp_path, monkeypatch):
    _rules_env(monkeypatch, tmp_path, ("shed-fast", "latency-fast"))

    async def scenario():
        async with ScoringEngine(StubExecutor(),
                                 knobs=ServingKnobs(max_badge=4, flush_deadline_s=0.005)) as eng:
            eng.register_model("m")
            for _ in range(3):
                assert await eng.score("m", [[1], [2]]) == [1, 2]

    asyncio.run(asyncio.wait_for(scenario(), 30.0))
    ev = alerts.get(create=False)
    assert ev is not None
    samples = ev._doc["rules"]["shed-fast"]["samples"]
    assert len(samples) >= 2  # the wakeups' ticks and the close's
    assert alerts.load_state(str(tmp_path / "alerts"))["rules"]["shed-fast"]["state"] == "inactive"


def test_engine_crash_ticks_the_evaluator_as_jax(tmp_path, monkeypatch):
    """The crash tick lands the crash counter in a sample in both packages."""
    from simple_tip_tpu.serving import ScoringEngine as JaxEngine
    from simple_tip_tpu.serving import ServingKnobs as JaxKnobs
    from simple_tip_tpu.serving import StubExecutor as JaxStub

    _rules_env(monkeypatch, tmp_path, ("crash-fast",))
    crashes = {}
    for name, pkg_alerts, engine, knobs, stub, state in (
        ("port", alerts, ScoringEngine, ServingKnobs, StubExecutor, "port"),
        ("jax", jax_alerts, JaxEngine, JaxKnobs, JaxStub, "jax"),
    ):
        monkeypatch.setenv("TIP_ALERT_STATE", str(tmp_path / state))

        async def scenario():
            eng = engine(stub(), knobs=knobs(max_badge=4, flush_deadline_s=0.005))
            eng.register_model("m")
            await eng.start()

            def boom(now, force=False):
                raise RuntimeError("injected scheduler bug")

            eng.batcher.take_ready = boom
            with pytest.raises(Exception, match="scheduler task died"):
                await eng.score("m", [[1]])

        asyncio.run(asyncio.wait_for(scenario(), 30.0))
        # the evaluator's samples (its state file is written on a transition
        # or on its persist cadence)
        rs = pkg_alerts.get(create=False)._doc["rules"]["crash-fast"]
        crashes[name] = (rs["last_value"], max(bad for _t, bad in rs["samples"]))
    assert crashes["port"] == crashes["jax"] == (1.0, 1.0)
    assert issubclass(EngineClosed, Exception)


def test_alerts_route_serves_the_evaluator_view(tmp_path, monkeypatch):
    _rules_env(monkeypatch, tmp_path, ("breaker-fast",))
    monkeypatch.setenv("TIP_OBS_HTTP", "auto")
    assert "/alerts" in exporter.ROUTES
    port = exporter.start()
    try:
        obs.gauge("breaker.open").set(1)
        alerts.tick()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/alerts", timeout=10) as resp:
            body = json.loads(resp.read())
        assert [r["rule"] for r in body["rules"]] == ["breaker-fast"]
        assert body == json.loads(json.dumps(alerts.get().view()))
    finally:
        exporter.stop()
    obs.reset_all()
    assert alerts.get(create=False) is None


def test_module_tick_is_a_noop_without_rules(tmp_path):
    alerts.tick()
    assert alerts.get(create=False) is None and not alerts.enabled()
    assert not os.path.exists(str(tmp_path / "assets" / "obs" / "alerts"))
