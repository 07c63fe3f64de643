"""The port's scoring service over ``StubExecutor``: every stub scenario
of the JAX package's ``tests/test_serving.py`` against the port's engine,
batcher, admission, breaker, retry, loop thread and load generator.

Knobs and their malformed values, the batcher's readiness, chunking,
rotation and eviction, admission's row and backlog bounds, the engine's
chunk reassembly, fill at saturation, latency bounded by the deadline
plus one dispatch, loud sheds that settle every request, ``shed_mode=
oldest``, the breaker in fail and degrade mode and its recovery, a
scheduler crash that fails pending requests, close and not-started, the
SLO snapshot (also under concurrent writers), ``shared_loop`` and the
load generator's fields (also with uneven requests). The async scenarios
run under ``asyncio.run`` with a liveness bound; nothing blocks inside an
``async def``.
"""

import asyncio
import time

import pytest

import simple_tip_tpu_torch.obs as obs
from simple_tip_tpu_torch.resilience.breaker import CircuitBreaker
from simple_tip_tpu_torch.resilience.retry import RetryPolicy
from simple_tip_tpu_torch.serving import (
    BackendDown,
    Chunk,
    ContinuousBatcher,
    EngineClosed,
    RequestShed,
    ScoringEngine,
    ServingKnobs,
    StubExecutor,
)
from simple_tip_tpu_torch.serving.admission import AdmissionController
from simple_tip_tpu_torch.serving.loadgen import drive, percentile
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _fresh_metrics():
    """Serving tests assert counter deltas; isolate the registry."""
    obs.reset_all()
    yield
    obs.reset_all()


def _fast_retry():
    """One attempt, no backoff: breaker/fault tests must not sleep."""
    return RetryPolicy.from_env(
        scope="serve", attempts=1, base_s=0.0, deadline_s=5.0
    )


def run(coro, timeout=30.0):
    """Drive one async test scenario under a hard liveness bound."""

    async def bounded():
        return await asyncio.wait_for(coro, timeout)

    return asyncio.run(bounded())


# --- knobs -------------------------------------------------------------------


def test_knobs_defaults_are_bounded():
    k = ServingKnobs()
    assert k.max_badge == 2048
    assert k.queue_bound_rows == 8 * k.max_badge  # bounded BY DEFAULT
    assert k.shed_mode == "reject"
    assert k.max_inflight == 2
    assert k.backlog_bound_s == 0.0


def test_knobs_from_env(monkeypatch):
    monkeypatch.setenv("TIP_SERVE_MAX_BADGE", "64")
    monkeypatch.setenv("TIP_SERVE_FLUSH_DEADLINE_MS", "10")
    monkeypatch.setenv("TIP_SERVE_QUEUE_BOUND", "100")
    monkeypatch.setenv("TIP_SERVE_SHED_MODE", "oldest")
    monkeypatch.setenv("TIP_SERVE_INFLIGHT", "3")
    monkeypatch.setenv("TIP_SERVE_MAX_BACKLOG_S", "1.5")
    k = ServingKnobs.from_env()
    assert (k.max_badge, k.queue_bound_rows, k.max_inflight) == (64, 100, 3)
    assert k.flush_deadline_s == pytest.approx(0.01)
    assert k.shed_mode == "oldest"
    assert k.backlog_bound_s == 1.5


def test_knobs_malformed_env_warns_and_defaults(monkeypatch, caplog):
    monkeypatch.setenv("TIP_SERVE_MAX_BADGE", "banana")
    monkeypatch.setenv("TIP_SERVE_SHED_MODE", "panic")
    with caplog.at_level("WARNING"):
        k = ServingKnobs.from_env()
    assert k.max_badge == 2048 and k.shed_mode == "reject"
    assert any("TIP_SERVE_MAX_BADGE" in r.message for r in caplog.records)


# --- batcher policy (synthetic clocks) ---------------------------------------


def _chunk(req, idx, n, t=0.0):
    return Chunk(req, idx, [0] * n, n, t)


def test_batcher_full_badge_ready_immediately():
    b = ContinuousBatcher(8, flush_deadline_s=100.0)
    b.add_model("m")
    b.push("m", _chunk(object(), 0, 4))
    assert b.take_ready(now=0.0) is None  # half full, deadline far away
    b.push("m", _chunk(object(), 0, 4))
    badge = b.take_ready(now=0.0)
    assert badge.rows == 8 and badge.fill == 1.0
    assert b.total_rows() == 0


def test_batcher_partial_flushes_at_deadline():
    b = ContinuousBatcher(8, flush_deadline_s=10.0)
    b.add_model("m")
    b.push("m", _chunk(object(), 0, 3, t=0.0))
    assert b.next_deadline() == 10.0
    assert b.take_ready(now=9.9) is None
    badge = b.take_ready(now=10.0)
    assert badge.rows == 3 and badge.fill == pytest.approx(3 / 8)


def test_batcher_chunks_never_split():
    b = ContinuousBatcher(8, flush_deadline_s=0.0)
    b.add_model("m")
    b.push("m", _chunk(object(), 0, 5))
    b.push("m", _chunk(object(), 0, 5))
    badge = b.take_ready(now=1.0)
    assert badge.rows == 5  # second 5-row chunk would overflow: stays queued
    assert b.pending_rows("m") == 5


def test_batcher_oversized_chunk_rejected():
    b = ContinuousBatcher(8, flush_deadline_s=0.0)
    b.add_model("m")
    with pytest.raises(ValueError, match="exceeds"):
        b.push("m", _chunk(object(), 0, 9))


def test_batcher_fair_rotation_interleaves_tenants():
    b = ContinuousBatcher(4, flush_deadline_s=100.0)
    for m in ("a", "b"):
        b.add_model(m)
        for _ in range(3):
            b.push(m, _chunk(object(), 0, 4))
    served = [b.take_ready(now=0.0).model for _ in range(6)]
    assert served == ["a", "b", "a", "b", "a", "b"]


def test_batcher_evicts_whole_oldest_request():
    b = ContinuousBatcher(4, flush_deadline_s=100.0)
    b.add_model("m")
    old, new = object(), object()
    b.push("m", _chunk(old, 0, 2, t=0.0))
    b.push("m", _chunk(new, 0, 2, t=1.0))
    b.push("m", _chunk(old, 1, 2, t=0.0))  # second chunk of the old request
    evicted = b.evict_oldest("m")
    assert [c.request for c in evicted] == [old, old]
    assert b.pending_rows("m") == 2  # the newer request survives intact


# --- admission ---------------------------------------------------------------


def test_admission_row_bound_sheds_with_counters():
    adm = AdmissionController(ServingKnobs(max_badge=4, queue_bound_rows=8),
                              breaker=None)
    adm.check("m", 8, queued_rows=0)
    with pytest.raises(RequestShed):
        adm.check("m", 4, queued_rows=8)
    counters = obs.metrics_snapshot()["counters"]
    assert counters["serving.shed"] == 1
    assert counters["serving.shed_rows"] == 4
    assert counters["serving.admitted"] == 1


def test_admission_backlog_bound_uses_live_estimate():
    adm = AdmissionController(
        ServingKnobs(max_badge=4, queue_bound_rows=1000, backlog_bound_s=0.5),
        breaker=None,
    )
    adm.check("m", 4, queued_rows=0, live_ewma_s=0.4)  # 1 badge: 0.4s, fits
    with pytest.raises(RequestShed) as exc:
        adm.check("m", 4, queued_rows=4, live_ewma_s=0.4)  # 2 badges: 0.8s
    assert exc.value.retry_after_s == pytest.approx(0.8)


def test_admission_missing_estimate_never_blocks():
    adm = AdmissionController(
        ServingKnobs(max_badge=4, queue_bound_rows=1000, backlog_bound_s=0.5),
        breaker=None,
    )
    # no live EWMA and (in a fresh test env) no corpus prior: advisory
    # estimate absent -> the backlog bound cannot fire, row bound still can
    verdict = adm.check("m", 4, queued_rows=400)
    assert verdict.degraded is False


# --- engine over the stub executor -------------------------------------------


def test_engine_scores_rows_and_reassembles_chunks():
    async def scenario():
        async with ScoringEngine(
            StubExecutor(), knobs=ServingKnobs(max_badge=8, flush_deadline_s=0.005)
        ) as eng:
            eng.register_model("m")
            assert await eng.score("m", [[1, 2], [3]]) == [3, 3]
            # 20 rows -> 3 chunks at badge 8; order must survive reassembly
            assert await eng.score("m", [[i] for i in range(20)]) == list(range(20))

    run(scenario())


def test_engine_badges_fill_at_saturation():
    async def scenario():
        ex = StubExecutor(delay_s=0.01)
        async with ScoringEngine(
            ex, knobs=ServingKnobs(max_badge=8, flush_deadline_s=0.02)
        ) as eng:
            eng.register_model("m")
            # a same-tick burst of half-badge requests is queued before the
            # scheduler resumes (single-threaded loop): badges must coalesce
            await asyncio.gather(*(eng.score("m", [[i], [i]]) for i in range(16)))
        hist = obs.metrics_snapshot()["histograms"]["serving.badge_fill"]
        assert hist["sum"] / hist["count"] >= 0.9

    run(scenario())


def test_engine_latency_bounded_by_deadline_plus_dispatch():
    async def scenario():
        knobs = ServingKnobs(max_badge=8, flush_deadline_s=0.02)
        ex = StubExecutor(delay_s=0.01)
        async with ScoringEngine(ex, knobs=knobs) as eng:
            eng.register_model("m")
            loop = asyncio.get_running_loop()
            for _ in range(5):
                t0 = loop.time()
                await eng.score("m", [[1]])
                # flush deadline + one badge dispatch + generous CI slack
                assert loop.time() - t0 <= knobs.flush_deadline_s + ex.delay_s + 0.25
        q = obs.metrics_snapshot()["quantiles"]["serving.request_ms"]
        assert q["count"] == 5 and q["p99"] <= 280.0

    run(scenario())


def test_engine_overload_sheds_loudly_and_settles_everything():
    async def scenario():
        ex = StubExecutor(delay_s=0.02)
        knobs = ServingKnobs(
            max_badge=4, flush_deadline_s=0.005, queue_bound_rows=8
        )
        async with ScoringEngine(ex, knobs=knobs) as eng:
            eng.register_model("m")
            results = await asyncio.gather(
                *(eng.score("m", [[i]] * 4) for i in range(12)),
                return_exceptions=True,
            )
            sheds = [r for r in results if isinstance(r, RequestShed)]
            oks = [r for r in results if not isinstance(r, BaseException)]
            assert len(sheds) + len(oks) == 12  # nothing hangs, nothing lost
            assert sheds and oks
            counters = obs.metrics_snapshot()["counters"]
            assert counters["serving.shed"] == len(sheds)
            assert counters["serving.shed_rows"] == 4 * len(sheds)
            # bounded queue: whatever is left in flight fits the row bound
            assert eng.batcher.total_rows() <= knobs.queue_bound_rows
            # and the engine still serves after the storm
            assert await eng.score("m", [[9]]) == [9]

    run(scenario())


def test_engine_shed_mode_oldest_evicts_to_admit_new():
    async def scenario():
        ex = StubExecutor()
        knobs = ServingKnobs(
            max_badge=4, flush_deadline_s=30.0, queue_bound_rows=4,
            shed_mode="oldest",
        )
        eng = ScoringEngine(ex, knobs=knobs)
        eng.register_model("m")
        await eng.start()
        # 3 rows sit queued (below badge, far-future flush deadline) ...
        old = asyncio.ensure_future(eng.score("m", [[1]] * 3))
        await asyncio.sleep(0.01)
        # ... the next 3 rows break the 4-row bound: the OLD request is
        # evicted (loudly) to admit the new one
        new = asyncio.ensure_future(eng.score("m", [[2]] * 3))
        await asyncio.sleep(0.01)
        with pytest.raises(RequestShed, match="evicted"):
            await old
        assert obs.metrics_snapshot()["counters"]["serving.shed"] == 1
        await eng.close()  # drain dispatches the admitted request
        assert await new == [2, 2, 2]

    run(scenario())


def test_engine_breaker_open_fail_mode_rejects_counted():
    async def scenario():
        br = CircuitBreaker(state_path=None, threshold=1, mode="fail", name="t")
        ex = StubExecutor(fail_first=1)
        async with ScoringEngine(
            ex,
            knobs=ServingKnobs(max_badge=4, flush_deadline_s=0.005),
            breaker=br,
            retry=_fast_retry(),
        ) as eng:
            eng.register_model("m")
            with pytest.raises(BackendDown):
                await eng.score("m", [[1]])  # backend fault -> breaker opens
            with pytest.raises(BackendDown):
                await eng.score("m", [[1]])  # breaker short-circuits
        counters = obs.metrics_snapshot()["counters"]
        assert counters["serving.backend_errors"] == 1
        assert counters["serving.breaker_rejects"] == 1

    run(scenario())


def test_engine_breaker_open_degrade_mode_admits_loudly():
    async def scenario():
        br = CircuitBreaker(state_path=None, threshold=1, mode="degrade", name="t")
        br.record_failure()  # force OPEN
        async with ScoringEngine(
            StubExecutor(),
            knobs=ServingKnobs(max_badge=4, flush_deadline_s=0.005),
            breaker=br,
            retry=_fast_retry(),
        ) as eng:
            eng.register_model("m")
            assert await eng.score("m", [[2, 3]]) == [5]
        counters = obs.metrics_snapshot()["counters"]
        assert counters["serving.degraded_admits"] == 1

    run(scenario())


def test_engine_backend_recovery_closes_breaker():
    async def scenario():
        br = CircuitBreaker(state_path=None, threshold=2, mode="fail", name="t")
        ex = StubExecutor(fail_first=1)
        async with ScoringEngine(
            ex,
            knobs=ServingKnobs(max_badge=4, flush_deadline_s=0.005),
            breaker=br,
            retry=_fast_retry(),
        ) as eng:
            eng.register_model("m")
            with pytest.raises(BackendDown):
                await eng.score("m", [[1]])  # 1 failure < threshold 2
            assert await eng.score("m", [[1]]) == [1]  # recovery edge
        assert br.state() == "closed"

    run(scenario())


def test_engine_scheduler_crash_fails_pending_not_hangs():
    async def scenario():
        ex = StubExecutor()
        eng = ScoringEngine(
            ex, knobs=ServingKnobs(max_badge=4, flush_deadline_s=0.005)
        )
        eng.register_model("m")
        await eng.start()

        def boom(now, force=False):
            raise RuntimeError("injected scheduler bug")

        eng.batcher.take_ready = boom
        with pytest.raises(EngineClosed, match="scheduler task died"):
            await eng.score("m", [[1]])
        assert obs.metrics_snapshot()["counters"]["serving.scheduler_crashes"] == 1

    run(scenario())


def test_engine_rejects_after_close_and_before_start():
    async def scenario():
        eng = ScoringEngine(
            StubExecutor(), knobs=ServingKnobs(max_badge=4, flush_deadline_s=0.005)
        )
        eng.register_model("m")
        with pytest.raises(EngineClosed, match="not started"):
            await eng.score("m", [[1]])
        await eng.start()
        with pytest.raises(ValueError, match="empty"):
            await eng.score("m", [])
        await eng.close()
        with pytest.raises(EngineClosed):
            await eng.score("m", [[1]])

    run(scenario())


def test_engine_slo_snapshot_shape():
    async def scenario():
        async with ScoringEngine(
            StubExecutor(), knobs=ServingKnobs(max_badge=4, flush_deadline_s=0.005)
        ) as eng:
            eng.register_model("m")
            await eng.score("m", [[1]] * 4)
            snap = eng.slo_snapshot()
        assert snap["badges"] == 1 and snap["rows"] == 4
        assert snap["mean_badge_fill"] == 1.0
        assert snap["request_ms"]["count"] == 1
        assert snap["knobs"]["max_badge"] == 4

    run(scenario())


def test_slo_snapshot_is_atomic_under_concurrent_writers():
    """Satellite contract (obs v4): slo_snapshot() must be safe to call
    from the exporter's HTTP handler threads WHILE dispatches land
    latencies. The registry snapshot copies everything in one
    critical section, so each observed quantile summary is coherent:
    p50 <= p95 <= p99 within a window, counts never go backwards, and
    no reader ever crashes on a half-updated ring."""
    import threading

    eng = ScoringEngine(None)  # executor only matters at dispatch time
    stop = threading.Event()
    errors = []

    def writer(seed):
        i = 0
        while not stop.is_set():
            obs.quantile("serving.request_ms").observe(float((seed + i) % 97))
            obs.quantile("serving.badge_ms").observe(float((seed * i) % 53))
            obs.counter("serving.rows").inc()
            i += 1

    def reader():
        last_count = 0
        while not stop.is_set():
            try:
                snap = eng.slo_snapshot()
            except Exception as e:  # noqa: BLE001 — the failure under test
                errors.append(repr(e))
                return
            for key in ("request_ms", "badge_ms"):
                q = snap[key]
                if q is None or not q["count"]:
                    continue
                if not (q["p50"] <= q["p95"] <= q["p99"]):
                    errors.append(f"incoherent {key}: {q}")
                    return
            if snap["rows"] < last_count:
                errors.append(f"rows went backwards: {snap['rows']}")
                return
            last_count = snap["rows"]

    threads = [threading.Thread(target=writer, args=(s,)) for s in (3, 7)]
    threads += [threading.Thread(target=reader) for _ in range(2)]
    for t in threads:
        t.start()
    time.sleep(0.5)
    stop.set()
    for t in threads:
        t.join(timeout=10)
    assert not errors, errors
    final = eng.slo_snapshot()
    assert final["request_ms"]["count"] > 0


def test_shared_loop_drives_engine_from_sync_code():
    from simple_tip_tpu_torch.parallel import LoopThread

    lt = LoopThread(name="test-serving")
    try:
        eng = ScoringEngine(
            StubExecutor(), knobs=ServingKnobs(max_badge=4, flush_deadline_s=0.005)
        )
        eng.register_model("m")
        lt.run(eng.start(), timeout=10.0)
        assert lt.run(eng.score("m", [[4], [5]]), timeout=10.0) == [4, 5]
        lt.run(eng.close(), timeout=10.0)
    finally:
        lt.stop()


def test_loadgen_reports_slo_fields():
    async def scenario():
        async with ScoringEngine(
            StubExecutor(delay_s=0.002),
            knobs=ServingKnobs(max_badge=8, flush_deadline_s=0.005),
        ) as eng:
            eng.register_model("m")
            return await drive(
                eng, "m", lambda i: [[i]] * 4,
                n_requests=10, rows_per_request=4, arrival_rows_per_s=4000.0,
            )

    stats = run(scenario())
    assert stats["ok"] + stats["shed"] + stats["errors"] == 10
    assert stats["ok"] == 10 and stats["badges"] >= 1
    assert stats["p99_ms"] >= stats["p50_ms"] > 0
    assert 0 < stats["badge_fill"] <= 1.0
    assert stats["sustained_inputs_per_s"] > 0


def test_loadgen_percentile_matches_quantile_definition():
    assert percentile([], 50) is None
    assert percentile([1.0, 2.0, 3.0], 50) == 2.0  # nearest rank, not 2.5
    vals = [float(v) for v in range(1, 101)]
    for q, want in ((50, 50.0), (95, 95.0), (99, 99.0)):
        assert percentile(vals, q) == want


def test_loadgen_uneven_requests_count_rows_and_hand_back_responses():
    """Requests of uneven sizes: the sustained rate counts the answered
    rows, and ``on_response`` sees every answered request with its rows'
    scores in order."""
    sizes = [1, 7, 3, 12, 5, 9, 2]
    seen = {}

    async def scenario():
        async with ScoringEngine(
            StubExecutor(), knobs=ServingKnobs(max_badge=8, flush_deadline_s=0.005)
        ) as eng:
            eng.register_model("m")
            return await drive(
                eng, "m", lambda i: [[i]] * sizes[i],
                n_requests=len(sizes), rows_per_request=sum(sizes) / len(sizes),
                arrival_rows_per_s=2000.0,
                on_response=lambda i, response: seen.__setitem__(i, response),
            )

    stats = run(scenario())
    assert stats["ok"] == len(sizes) and stats["shed"] == stats["errors"] == 0
    assert seen == {i: [i] * n for i, n in enumerate(sizes)}
    # elapsed_s is rounded to 0.1 ms
    assert stats["sustained_inputs_per_s"] == pytest.approx(
        sum(sizes) / stats["elapsed_s"], abs=sum(sizes) * 5e-5 / stats["elapsed_s"] ** 2 + 0.1)


def test_register_while_serving_joins_on_the_loop_thread():
    """A model registered from another thread while the engine serves joins
    the batcher through the loop thread and is then served."""
    from simple_tip_tpu_torch.parallel import LoopThread

    lt = LoopThread(name="test-serving-register")
    try:
        eng = ScoringEngine(
            StubExecutor(), knobs=ServingKnobs(max_badge=4, flush_deadline_s=0.005)
        )
        eng.register_model("a")
        lt.run(eng.start(), timeout=10.0)
        assert lt.run(eng.score("a", [[1]]), timeout=10.0) == [1]
        eng.register_model("b", fn=lambda row: -row[0])
        assert lt.run(eng.score("b", [[2], [3]]), timeout=10.0) == [-2, -3]
        assert eng.batcher._rotation == ["a", "b"]
        lt.run(eng.close(), timeout=10.0)
    finally:
        lt.stop()


def test_exporter_serves_slo_while_the_engine_runs(monkeypatch):
    """``TIP_OBS_HTTP=auto``: the engine mounts ``/slo`` and its health on
    start, ``/metrics`` renders its counters, and close unmounts both."""
    import json
    import urllib.error
    import urllib.request

    from simple_tip_tpu_torch.obs import exporter

    monkeypatch.setenv("TIP_OBS_HTTP", "auto")

    def get(port, route):
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=10) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    async def scenario():
        eng = ScoringEngine(
            StubExecutor(), knobs=ServingKnobs(max_badge=4, flush_deadline_s=0.005)
        )
        eng.register_model("m")
        await eng.start()
        await eng.score("m", [[1]] * 4)
        port = exporter.bound_port()
        loop = asyncio.get_running_loop()
        live = [await loop.run_in_executor(None, get, port, route)
                for route in ("/slo", "/healthz", "/metrics")]
        await eng.close()
        closed = await loop.run_in_executor(None, get, port, "/slo")
        return live, closed

    (slo, health, metrics), closed = run(scenario())
    assert slo[0] == 200 and json.loads(slo[1])["badges"] == 1
    assert health[0] == 200 and json.loads(health[1])["components"]["serving"]["ok"]
    assert metrics[0] == 200 and "tip_serving_badges_total 1" in metrics[1]
    assert closed[0] == 404
