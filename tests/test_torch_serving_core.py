"""The port's serving core held against the JAX package's on equal inputs.

Both packages' stdlib modules run side by side on the same environments,
scripts and values:

- ``ServingKnobs.from_env``: equal ``snapshot()``s, malformed values and
  clamps included;
- ``ContinuousBatcher``: seeded scripts of pushes, takes (synthetic
  clocks, forced drains), evictions and drains give the same badges in the
  same order (model, chunks, rows, fill), the same evictions and drains;
- ``AdmissionController``: the same verdicts, sheds and counter deltas,
  the backlog bound from a live EWMA, the breaker in front, and the
  no-estimate case (the JAX side on an empty ``TIP_OBS_INDEX``);
- ``Quantile`` and ``percentile``: the same p50/p95/p99;
- ``RetryPolicy.from_env`` and ``CircuitBreaker.from_env`` parse alike;
  both breakers walk closed -> open -> half-open -> closed on one state
  file, each reading what the other wrote;
- the exporter's ``render_metrics`` renders equal registries as equal
  text, and the tracer writes records of the same kinds and keys.
"""

import json
import os
import time

import numpy as np
import pytest

import simple_tip_tpu.obs as jax_obs
import simple_tip_tpu_torch.obs as obs
from simple_tip_tpu.obs import exporter as jax_exporter
from simple_tip_tpu.obs import metrics as jax_metrics
from simple_tip_tpu.obs import tracer as jax_tracer
from simple_tip_tpu.resilience import breaker as jax_breaker
from simple_tip_tpu.resilience import retry as jax_retry
from simple_tip_tpu.serving import admission as jax_admission
from simple_tip_tpu.serving import batcher as jax_batcher
from simple_tip_tpu.serving import errors as jax_errors
from simple_tip_tpu.serving import knobs as jax_knobs
from simple_tip_tpu.serving import loadgen as jax_loadgen
from simple_tip_tpu_torch.obs import exporter, metrics, tracer
from simple_tip_tpu_torch.resilience import breaker, retry
from simple_tip_tpu_torch.serving import admission, batcher, errors, knobs, loadgen
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SERVE_VARS = ("TIP_SERVE_MAX_BADGE", "TIP_SERVE_FLUSH_DEADLINE_MS", "TIP_SERVE_QUEUE_BOUND",
              "TIP_SERVE_SHED_MODE", "TIP_SERVE_INFLIGHT", "TIP_SERVE_MAX_BACKLOG_S")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    """Both registries empty, no stream, no exporter, no breaker state, and
    the JAX cost model's feature store empty (its cold prior then is None)."""
    for var in ("TIP_OBS_DIR", "TIP_OBS_HTTP", "TIP_BREAKER_STATE", "TIP_OBS_SAMPLE",
                "TIP_OBS_MAX_BYTES", "TIP_OBS_ROOT", *SERVE_VARS):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("TIP_ASSETS", str(tmp_path / "assets"))
    (tmp_path / "index").mkdir()
    monkeypatch.setenv("TIP_OBS_INDEX", str(tmp_path / "index"))
    obs.reset_all()
    jax_obs.reset_all()
    yield
    obs.reset_all()
    jax_obs.reset_all()


def _snapshots():
    return obs.metrics_snapshot(), jax_obs.metrics_snapshot()


# -- knobs ---------------------------------------------------------------------


@pytest.mark.parametrize("env", [
    {},
    {"TIP_SERVE_MAX_BADGE": "64", "TIP_SERVE_FLUSH_DEADLINE_MS": "10",
     "TIP_SERVE_QUEUE_BOUND": "100", "TIP_SERVE_SHED_MODE": "oldest",
     "TIP_SERVE_INFLIGHT": "3", "TIP_SERVE_MAX_BACKLOG_S": "1.5"},
    {"TIP_SERVE_MAX_BADGE": "banana", "TIP_SERVE_SHED_MODE": "panic"},
    {"TIP_SERVE_MAX_BADGE": "0", "TIP_SERVE_FLUSH_DEADLINE_MS": "-4",
     "TIP_SERVE_QUEUE_BOUND": "-1", "TIP_SERVE_INFLIGHT": "0",
     "TIP_SERVE_MAX_BACKLOG_S": "-2"},
    {"TIP_SERVE_MAX_BADGE": "1e3", "TIP_SERVE_FLUSH_DEADLINE_MS": "0.25",
     "TIP_SERVE_SHED_MODE": " OLDEST ", "TIP_SERVE_QUEUE_BOUND": "2.9"},
    {"TIP_SERVE_MAX_BADGE": " ", "TIP_SERVE_INFLIGHT": "x2", "TIP_SERVE_SHED_MODE": ""},
], ids=["defaults", "all-set", "malformed", "below-minimum", "float-forms", "blank-and-bad"])
def test_knobs_from_env_match_jax(monkeypatch, caplog, env):
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    with caplog.at_level("WARNING"):
        ours = knobs.ServingKnobs.from_env().snapshot()
        n_ours = len(caplog.records)
        theirs = jax_knobs.ServingKnobs.from_env().snapshot()
    assert ours == theirs
    assert len(caplog.records) == 2 * n_ours  # the same warnings, one per package


def test_knobs_constructor_matches_jax():
    for kw in ({}, {"max_badge": 0, "flush_deadline_s": -1, "shed_mode": "nope"},
               {"max_badge": 33, "queue_bound_rows": 5, "max_inflight": 0,
                "backlog_bound_s": 2.5}):
        assert knobs.ServingKnobs(**kw).snapshot() == jax_knobs.ServingKnobs(**kw).snapshot()


# -- the batcher ---------------------------------------------------------------


class _Req:
    """An opaque request handle; the batchers use only its identity."""

    def __init__(self, tag):
        self.tag = tag
        self.request_id = f"r{tag}"


def _badge_view(badge):
    if badge is None:
        return None
    return (badge.model, [(c.request.tag, c.index, c.n, c.t_enqueue) for c in badge.chunks],
            badge.rows, badge.fill, list(badge.request_ids))


def _script(seed: int, models=("a", "b", "c"), max_badge=16):
    """A seeded script of batcher operations over synthetic time."""
    rng = np.random.default_rng(seed)
    ops, t, tag = [], 0.0, 0
    for m in models:
        ops.append(("add", m))
    for _ in range(160):
        t += float(rng.choice([0.0, 0.001, 0.004, 0.02]))
        kind = rng.choice(["push", "push", "push", "take", "take", "force", "evict", "probe"])
        if kind == "push":
            tag += 1
            m = str(rng.choice(models))
            n_chunks = int(rng.integers(1, 4))
            for i in range(n_chunks):
                ops.append(("push", m, tag, i, int(rng.integers(1, max_badge + 1)), t))
        elif kind in ("take", "force"):
            ops.append(("take", t, kind == "force"))
        elif kind == "evict":
            ops.append(("evict", str(rng.choice(models))))
        else:
            ops.append(("probe", str(rng.choice(models))))
    ops.append(("drain",))
    return ops


def _play(module, ops, max_badge=16, deadline=0.01):
    b = module.ContinuousBatcher(max_badge, deadline)
    handles = {}
    out = []
    for op in ops:
        if op[0] == "add":
            b.add_model(op[1])
        elif op[0] == "push":
            _, m, tag, i, n, t = op
            req = handles.setdefault(tag, _Req(tag))
            b.push(m, module.Chunk(req, i, [tag] * n, n, t))
        elif op[0] == "take":
            out.append(("take", _badge_view(b.take_ready(op[1], force=op[2]))))
        elif op[0] == "evict":
            out.append(("evict", [(c.request.tag, c.index, c.n) for c in b.evict_oldest(op[1])]))
        elif op[0] == "probe":
            out.append(("probe", b.pending_rows(op[1]), b.pending_rows(), b.total_rows(),
                        b.next_deadline()))
        else:
            out.append(("drain", [(c.request.tag, c.index, c.n) for c in b.drain()]))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_batcher_scripts_match_jax(seed):
    ops = _script(seed)
    ours, theirs = _play(batcher, ops), _play(jax_batcher, ops)
    assert ours == theirs
    takes = [o[1] for o in ours if o[0] == "take" and o[1] is not None]
    assert takes and any(o[0] == "evict" and o[1] for o in ours)
    ours_gauge, theirs_gauge = (s["gauges"]["serving.queue_rows"] for s in _snapshots())
    assert ours_gauge == theirs_gauge == 0


def test_batcher_refuses_oversized_chunks_as_jax():
    for module in (batcher, jax_batcher):
        b = module.ContinuousBatcher(8, 0.0)
        b.add_model("m")
        with pytest.raises(ValueError, match="exceeds the 8-row badge"):
            b.push("m", module.Chunk(object(), 0, [0] * 9, 9, 0.0))


# -- admission -----------------------------------------------------------------


def _admit_trace(module, err_module, breaker_module, knob_kw, steps, breaker_kw=None):
    br = None
    if breaker_kw is not None:
        br = breaker_module.CircuitBreaker(state_path=None, **breaker_kw)
        br.record_failure()
    adm = module.AdmissionController(
        (knobs if module is admission else jax_knobs).ServingKnobs(**knob_kw), breaker=br)
    registry = obs if module is admission else jax_obs
    out = []
    for model, n, queued, ewma, count in steps:
        try:
            v = adm.check(model, n, queued, live_ewma_s=ewma, count_shed=count,
                          request_id=f"r{n}")
            outcome = ("admit", v.degraded, v.backlog_s)
        except err_module.RequestShed as e:
            outcome = ("shed", str(e), e.retry_after_s)
        except err_module.BackendDown as e:
            outcome = ("down", str(e))
        out.append((outcome, registry.metrics_snapshot()["counters"]))
    return out, adm


ADMISSION_CASES = {
    "row-bound": (dict(max_badge=4, queue_bound_rows=8),
                  [("m", 8, 0, None, True), ("m", 4, 8, None, True), ("m", 1, 7, None, True),
                   ("m", 2, 7, None, False), ("n", 9, 0, None, True)], None),
    "live-ewma-backlog": (dict(max_badge=4, queue_bound_rows=1000, backlog_bound_s=0.5),
                          [("m", 4, 0, 0.4, True), ("m", 4, 4, 0.4, True),
                           ("m", 1, 0, 0.6, True), ("m", 3, 9, 0.1, True),
                           ("m", 4, 400, None, True), ("m", 4, 4, 0.0, True)], None),
    "breaker-fail": (dict(max_badge=4), [("m", 1, 0, None, True), ("m", 2, 0, None, True)],
                     dict(threshold=1, mode="fail", name="t")),
    "breaker-degrade": (dict(max_badge=4, queue_bound_rows=4),
                        [("m", 1, 0, None, True), ("m", 4, 2, None, True)],
                        dict(threshold=1, mode="degrade", name="t")),
}


@pytest.mark.parametrize("case", sorted(ADMISSION_CASES))
def test_admission_sequences_match_jax(case):
    knob_kw, steps, breaker_kw = ADMISSION_CASES[case]
    ours, adm = _admit_trace(admission, errors, breaker, knob_kw, steps, breaker_kw)
    theirs, jax_adm = _admit_trace(jax_admission, jax_errors, jax_breaker, knob_kw, steps,
                                   breaker_kw)
    assert ours == theirs
    # the no-estimate case: neither package has a cold-start prior here
    assert adm.cold_badge_estimate_s() is None and jax_adm.cold_badge_estimate_s() is None
    assert adm.badge_estimate_s(None) is None and jax_adm.badge_estimate_s(None) is None
    assert adm.badge_estimate_s(0.25) == jax_adm.badge_estimate_s(0.25) == 0.25


def test_admission_count_shed_matches_jax():
    for module in (admission, jax_admission):
        adm = module.AdmissionController(
            (knobs if module is admission else jax_knobs).ServingKnobs(max_badge=4),
            breaker=None)
        adm.count_shed("m", 5, queued_rows=3, backlog_s=0.123456, reason="evicted-oldest",
                       request_id="r1")
        adm.count_shed("m", 2)
    ours, theirs = _snapshots()
    assert ours == theirs and ours["counters"] == {"serving.shed": 2, "serving.shed_rows": 7}


# -- quantiles -----------------------------------------------------------------


@pytest.mark.parametrize("n,cap", [(0, 512), (1, 512), (3, 512), (100, 512), (997, 512),
                                   (1500, 64), (31, 7)])
def test_quantile_and_percentile_match_jax(n, cap):
    values = np.random.default_rng(n + cap).exponential(5.0, n).tolist()
    q = metrics.quantile("serving.request_ms", cap=cap)
    jq = jax_metrics.quantile("serving.request_ms", cap=cap)
    for v in values:
        q.observe(v)
        jq.observe(v)
    assert q.summary() == jq.summary()
    for p in (0, 1, 50, 95, 99, 100):
        assert q.percentile(p) == jq.percentile(p)
        assert loadgen.percentile(values, p) == jax_loadgen.percentile(values, p)
    window = values[-cap:] if n > cap else values
    assert q.percentile(50) == loadgen.percentile(window, 50)


def test_registry_snapshots_match_jax():
    for registry, m in ((obs, metrics), (jax_obs, jax_metrics)):
        registry.counter("serving.badges").inc(3)
        registry.gauge("serving.queue_rows").set(17)
        registry.gauge("breaker.open").set_max(1)
        registry.histogram("serving.badge_fill").observe(0.5)
        registry.histogram("serving.badge_fill").observe(1.0)
        registry.quantile("serving.badge_ms").observe(2.5)
        m.describe("serving.badges", "badges  dispatched\nto the backend")
    ours, theirs = _snapshots()
    assert ours == theirs
    assert metrics.help_text("serving.badges") == jax_metrics.help_text("serving.badges")
    assert metrics.help_text("retry.giveups") == jax_metrics.help_text("retry.giveups")


# -- retry and breaker -----------------------------------------------------------


RETRY_ENVS = [
    {},
    {"TIP_RETRY_ATTEMPTS": "5", "TIP_RETRY_BASE_S": "0.5", "TIP_RETRY_FACTOR": "3",
     "TIP_RETRY_MAX_S": "4", "TIP_RETRY_DEADLINE_S": "-1", "TIP_RETRY_JITTER": "0"},
    {"TIP_RETRY_SERVE_ATTEMPTS": "4", "TIP_RETRY_ATTEMPTS": "9", "TIP_RETRY_SERVE_BASE_S": "x"},
    {"TIP_RETRY_ATTEMPTS": "0", "TIP_RETRY_FACTOR": "0.5", "TIP_RETRY_JITTER": "-1"},
]


def _policy_view(p):
    return (p.attempts, p.base_s, p.factor, p.max_s, p.deadline_s, p.jitter, p.seed)


@pytest.mark.parametrize("env", RETRY_ENVS, ids=["defaults", "global", "scoped", "clamped"])
def test_retry_from_env_matches_jax(monkeypatch, env):
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    for kw in ({}, {"scope": "serve", "attempts": 2, "base_s": 0.05, "deadline_s": 30.0},
               {"scope": "serve", "inherit": False, "seed": 7}):
        ours = retry.RetryPolicy.from_env(**kw)
        theirs = jax_retry.RetryPolicy.from_env(**kw)
        assert _policy_view(ours) == _policy_view(theirs)
        if ours.seed is not None:
            assert list(ours.delays()) == list(theirs.delays())


def test_retry_call_matches_jax():
    """Transient failures retried to the budget, then ``RetryGiveUp``;
    fatal ones raised at once; the same counter deltas."""
    for module in (retry, jax_retry):
        policy = module.RetryPolicy(attempts=3, base_s=0.0, jitter=0.0)
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return "ok"

        assert policy.call(flaky) == "ok" and len(calls) == 3
        with pytest.raises(module.RetryGiveUp, match="gave up after 3 attempt"):
            policy.call(lambda: (_ for _ in ()).throw(TimeoutError("t")))
        with pytest.raises(ValueError):
            policy.call(lambda: (_ for _ in ()).throw(ValueError("fatal")))
    ours, theirs = _snapshots()
    assert ours["counters"] == theirs["counters"] == {"retry.attempts": 4, "retry.giveups": 1}


BREAKER_ENVS = [
    {},
    {"TIP_BREAKER_STATE": "off"},
    {"TIP_BREAKER_STATE": "0"},
    {"TIP_BREAKER_THRESHOLD": "3", "TIP_BREAKER_COOLDOWN_S": "12.5", "TIP_BREAKER_MODE": "fail"},
    {"TIP_BREAKER_THRESHOLD": "x", "TIP_BREAKER_COOLDOWN_S": "", "TIP_BREAKER_MODE": "panic"},
    {"TIP_BREAKER_STATE": "{tmp}/b/state.json", "TIP_BREAKER_THRESHOLD": "0"},
]


@pytest.mark.parametrize("env", BREAKER_ENVS,
                         ids=["defaults", "off", "zero", "set", "malformed", "path"])
def test_breaker_from_env_matches_jax(monkeypatch, tmp_path, env):
    for var, value in env.items():
        monkeypatch.setenv(var, value.replace("{tmp}", str(tmp_path)))
    ours = breaker.CircuitBreaker.from_env(name="serving")
    theirs = jax_breaker.CircuitBreaker.from_env(name="serving")
    if theirs is None:
        assert ours is None
        return
    view = lambda b: (b.state_path, b.threshold, b.cooldown_s, b.mode, b.name)  # noqa: E731
    assert view(ours) == view(theirs)


def test_breakers_walk_one_state_file(monkeypatch, tmp_path):
    """closed -> open -> half-open -> closed, the two packages alternating
    on one state file: each reads what the other wrote."""
    now = [1000.0]
    monkeypatch.setattr(time, "time", lambda: now[0])
    path = str(tmp_path / "breaker_state.json")
    ours = breaker.CircuitBreaker(path, threshold=2, cooldown_s=60.0, mode="fail", name="s")
    theirs = jax_breaker.CircuitBreaker(path, threshold=2, cooldown_s=60.0, mode="fail",
                                        name="s")
    states = []

    def both():
        states.append((ours.state(), theirs.state(), ours.allow(), theirs.allow()))

    both()
    ours.record_failure()
    both()
    theirs.record_failure()  # the second consecutive failure opens it
    both()
    now[0] += 61.0
    both()
    theirs.record_failure()  # the half-open test call fails: open again
    both()
    now[0] += 61.0
    ours.record_success()
    both()
    assert states == [
        ("closed", "closed", True, True),
        ("closed", "closed", True, True),
        ("open", "open", False, False),
        ("half_open", "half_open", True, True),
        ("open", "open", False, False),
        ("closed", "closed", True, True),
    ]
    with open(path) as f:
        assert json.load(f) == {"state": "closed", "failures": 0}
    assert ours.snapshot() == theirs.snapshot()
    ours_c, theirs_c = _snapshots()
    assert ours_c["counters"]["breaker.short_circuit"] == 2
    assert theirs_c["counters"]["breaker.short_circuit"] == 2


# -- exporter and tracer ----------------------------------------------------------


def test_render_metrics_matches_jax():
    for registry, m, exp in ((obs, metrics, exporter), (jax_obs, jax_metrics, jax_exporter)):
        registry.counter("serving.badges").inc(4)
        registry.counter("serving.shed").inc(0)
        registry.counter("odd name/with-chars").inc(2)
        registry.gauge("serving.queue_rows").set(12)
        registry.gauge("serving.degraded").set(True)
        registry.gauge("serving.label").set("text")
        registry.gauge("2fast").set(0.5)
        registry.histogram("serving.badge_fill").observe(0.25)
        registry.histogram("serving.badge_fill").observe(1.0)
        registry.histogram("empty.hist")
        for v in (3.0, 1.0, 2.0, 9.5):
            registry.quantile("serving.request_ms").observe(v)
        m.describe("serving.queue_rows", "rows queued\nacross models")
        exp.set_health("serving", ok=True)
        exp.set_health("breaker", ok=False, error="open")
    assert exporter.render_metrics() == jax_exporter.render_metrics()
    ours, theirs = exporter.render_healthz(), jax_exporter.render_healthz()
    for doc in (ours, theirs):
        doc.pop("pid")
        doc.pop("uptime_s")
    assert ours == theirs and ours["ok"] is False


def _records(folder):
    out = []
    for name in sorted(os.listdir(folder)):
        with open(os.path.join(folder, name)) as f:
            out += [json.loads(line) for line in f]
    return out


def _shape(rec):
    """A record's kind, name, keys and attributes, without its times and ids."""
    attrs = rec.get("attrs", {})
    return (rec["type"], rec.get("name"), sorted(rec), sorted(attrs),
            {k: v for k, v in attrs.items() if k not in ("ts",)}, rec.get("depth"),
            "parent" in rec, rec.get("error"))


def _emit(module):
    with module.span("serving.badge", model="m", rows=4) as sp:
        sp.set(fill=0.5)
        module.event("serving.shed", model="m", rows=2)
        with module.span("inner"):
            pass
    module.record_span("external", time.time(), 0.25, rows=3)
    try:
        with module.span("failing"):
            raise KeyError("boom")
    except KeyError:
        pass

    @module.traced("decorated", kind="fn")
    def work():
        return 5

    assert work() == 5
    for _ in range(4):
        with module.span("sampled"):
            pass
    os.environ["TIP_OBS_ROOT"] = "1:1"  # a study root's id, as study_root pins it
    try:
        with module.span("under_root"):
            pass
        module.record_span("external_under_root", time.time(), 0.5)
    finally:
        del os.environ["TIP_OBS_ROOT"]


def test_tracer_records_match_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("TIP_OBS_SAMPLE", "sampled=2")
    streams = {}
    for label, module in (("port", tracer), ("jax", jax_tracer)):
        monkeypatch.setenv("TIP_OBS_DIR", str(tmp_path / label))
        module.reset()
        _emit(module)
        module.reset()
        streams[label] = _records(str(tmp_path / label))
    ours, theirs = streams["port"], streams["jax"]
    assert ours[0]["type"] == "meta" and ours[0]["schema"] == theirs[0]["schema"]
    assert [_shape(r) for r in ours[1:]] == [_shape(r) for r in theirs[1:]]
    assert sum(r.get("name") == "sampled" for r in ours) == 2


def test_tracer_is_a_noop_when_unset(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    tracer.reset()
    assert not obs.enabled() and obs.obs_dir() is None
    assert obs.span("x") is obs.span("y")  # the shared no-op
    _emit(tracer)
    metrics.flush()
    assert os.listdir(tmp_path) == ["index"]  # the fixture's, and nothing else


def test_tracer_rotation_matches_jax(monkeypatch, tmp_path):
    """A small ``TIP_OBS_MAX_BYTES``: both packages rotate into segments,
    evict the oldest past the cap and write the same eviction marker."""
    monkeypatch.setenv("TIP_OBS_MAX_BYTES", "8k")
    kept = {}
    for label, module in (("port", tracer), ("jax", jax_tracer)):
        monkeypatch.setenv("TIP_OBS_DIR", str(tmp_path / label))
        module.reset()
        for i in range(400):
            module.event("tick", i=i, pad="x" * 40)
        module.reset()
        files = sorted(os.listdir(tmp_path / label))
        markers = [r for r in _records(str(tmp_path / label)) if r.get("name") == "obs.evicted"]
        kept[label] = (len(files), len(markers) > 0,
                       [r["attrs"]["i"] for r in _records(str(tmp_path / label))
                        if r.get("name") == "tick"])
    assert kept["port"] == kept["jax"]
    assert kept["port"][0] <= tracer.SEGMENTS and kept["port"][1]


def test_metrics_flush_writes_one_event_like_jax(monkeypatch, tmp_path):
    for label, module, registry in (("port", tracer, obs), ("jax", jax_tracer, jax_obs)):
        monkeypatch.setenv("TIP_OBS_DIR", str(tmp_path / label))
        module.reset()
        registry.counter("serving.badges").inc(2)
        registry.flush_metrics()
        registry.flush_metrics()  # unchanged: no second event
        module.reset()
    ours, theirs = (_records(str(tmp_path / lab)) for lab in ("port", "jax"))
    assert [r["type"] for r in ours] == [r["type"] for r in theirs] == ["meta", "metrics"]
    strip = lambda r: {k: v for k, v in r.items() if k not in ("ts", "pid")}  # noqa: E731
    assert strip(ours[1]) == strip(theirs[1])
