"""The async scoring engine: request API over the continuous batcher.

Counterpart of the JAX package's ``serving/engine.py``. One asyncio
scheduler task owns the batcher; badge dispatches run in worker threads
(``loop.run_in_executor``), so the event loop never blocks on the card.
No ``time.sleep``, blocking ``.result()`` or sync file IO inside an
``async def``: everything blocking lives in sync methods run off the loop.

Liveness:

- the queue is bounded (admission sheds past ``queue_bound_rows``);
- a scheduler-task crash fails every pending request with the cause
  (``_on_scheduler_done``): a bug can reject requests, never hang them;
- ``close()`` drains or fails everything explicitly.

SLO telemetry (the ``obs`` registry): ``serving.request_ms`` and
``serving.badge_ms`` quantiles (p50/p95/p99), ``serving.badge_fill``
histogram and ``serving.last_badge_fill`` gauge, ``serving.queue_rows``
gauge, ``serving.badges`` / ``serving.rows`` / ``serving.shed`` /
``serving.backend_errors`` counters. The scheduler loop is also the
serving process's SLO alert evaluator mount (``obs/alerts.py``): one
rate-limited ``alerts.tick()`` per wakeup, one on ``close()`` and one when
the scheduler task crashes, as in the JAX package.
"""

import asyncio
import itertools
import logging
from typing import Dict, List, Optional

from simple_tip_tpu_torch import obs
from simple_tip_tpu_torch.serving.admission import AdmissionController
from simple_tip_tpu_torch.serving.batcher import Badge, Chunk, ContinuousBatcher
from simple_tip_tpu_torch.serving.errors import BackendDown, EngineClosed, RequestShed
from simple_tip_tpu_torch.serving.knobs import ServingKnobs

logger = logging.getLogger(__name__)


def _running_on(loop: asyncio.AbstractEventLoop) -> bool:
    """Whether the calling thread is running ``loop``."""
    try:
        return asyncio.get_running_loop() is loop
    except RuntimeError:
        return False


class _Request:
    """One submitted request: chunk bookkeeping + the response future."""

    __slots__ = ("model", "future", "t_enqueue", "parts", "pending",
                 "request_id")

    def __init__(self, model, future, t_enqueue: float, n_chunks: int,
                 request_id: Optional[str] = None):
        self.model = model
        self.future = future
        self.t_enqueue = t_enqueue
        self.parts: List = [None] * n_chunks
        self.pending = n_chunks
        self.request_id = request_id

    def fail(self, exc: BaseException) -> None:
        """Reject the request (idempotent across its chunks)."""
        if not self.future.done():
            self.future.set_exception(exc)

    def complete_chunk(self, index: int, part) -> bool:
        """Store one chunk's result; True when the request is complete."""
        self.parts[index] = part
        self.pending -= 1
        return self.pending == 0


class ScoringEngine:
    """Multi-tenant online scoring over one badge executor.

    Usage::

        engine = ScoringEngine(FusedChainExecutor(), knobs)
        engine.register_model("mnist/7", model_def=..., params=..., ...)
        await engine.start()
        result = await engine.score("mnist/7", rows)
        await engine.close()

    ``score`` raises :class:`RequestShed` (429: bounded queue / predicted
    backlog), :class:`BackendDown` (503: breaker open in mode=fail, or
    retries exhausted), or :class:`EngineClosed`. Sync callers drive it
    through ``parallel.aio.shared_loop()``.
    """

    RETRY_SCOPE = "serve"

    def __init__(
        self,
        executor,
        knobs: Optional[ServingKnobs] = None,
        breaker="env",
        retry="env",
    ):
        self.executor = executor
        self.knobs = knobs or ServingKnobs.from_env()
        self.batcher = ContinuousBatcher(
            self.knobs.max_badge, self.knobs.flush_deadline_s
        )
        self.admission = AdmissionController(self.knobs, breaker=breaker)
        if retry == "env":
            from simple_tip_tpu_torch.resilience.retry import RetryPolicy

            # badge dispatches are latency-sensitive: short budget by
            # default, still env-tunable per scope (TIP_RETRY_SERVE_*)
            retry = RetryPolicy.from_env(
                scope=self.RETRY_SCOPE, attempts=2, base_s=0.05, deadline_s=30.0
            )
        self.retry = retry
        self._task: Optional[asyncio.Task] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._wake: Optional[asyncio.Event] = None
        self._inflight: Optional[asyncio.Semaphore] = None
        self._dispatch_tasks: set = set()
        self._closed = False
        self._ewma_badge_s: Dict[object, float] = {}
        self._had_backend_failure = False
        # Monotonic per-engine request ids, stamped on every admission
        # outcome (shed events included) and on each badge's dispatch
        # span, so one request's path — admit, coalesce, dispatch or
        # shed — greps out of the event stream by a single token.
        self._rid = itertools.count(1)

    # -- lifecycle -----------------------------------------------------------

    def register_model(self, key, **spec) -> None:
        """Register + warm one model (sync by design: a capture belongs to
        deployment time, not the event loop or the request path).

        While the engine runs, the model joins the batcher on the loop
        thread, which the scheduler reads it from.
        """
        self.executor.register_model(key, badge_size=self.knobs.max_badge, **spec)
        loop = self._loop
        if loop is not None and loop.is_running() and not _running_on(loop):
            loop.call_soon_threadsafe(self.batcher.add_model, key)
        else:
            self.batcher.add_model(key)

    async def start(self) -> None:
        """Start the scheduler task on the running loop (idempotent)."""
        if self._task is not None:
            return
        self._wake = asyncio.Event()
        self._inflight = asyncio.Semaphore(self.knobs.max_inflight)
        self._loop = asyncio.get_running_loop()
        self._task = self._loop.create_task(self._run())
        self._task.add_done_callback(self._on_scheduler_done)
        # Live telemetry plane: expose /slo (and /healthz, /metrics) while
        # the engine serves. No-op unless TIP_OBS_HTTP is set.
        # slo_snapshot() reads only the in-memory metrics registry (atomic
        # copy-under-lock) + batcher/knob state, so it is handler-safe.
        from simple_tip_tpu_torch.obs import exporter

        if exporter.start() is not None:
            exporter.set_provider("slo", self.slo_snapshot)
            exporter.set_health("serving", ok=True)

    async def __aenter__(self) -> "ScoringEngine":
        """Async-context entry: start the scheduler."""
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        """Async-context exit: close, draining queued work."""
        await self.close()

    async def close(self, drain: bool = True) -> None:
        """Stop serving: optionally flush queued chunks, then fail leftovers.

        ``drain=True`` (default) dispatches every queued chunk as final
        (partial) badges before stopping; ``drain=False`` fails queued
        requests with :class:`EngineClosed` immediately.
        """
        if self._closed:
            return
        self._closed = True
        from simple_tip_tpu_torch.obs import alerts as alerts_mod
        from simple_tip_tpu_torch.obs import exporter

        alerts_mod.tick()  # final evaluation over the engine's last state
        if exporter.enabled():
            # Unhook /slo: a closed engine's snapshot would read as live.
            exporter.clear_provider("slo")
            exporter.clear_health("serving")
        if self._task is not None:
            self._wake.set()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            if drain:
                await self._drain()
            for task in list(self._dispatch_tasks):
                await task
        for chunk in self.batcher.drain():
            chunk.request.fail(EngineClosed("scoring engine closed"))

    async def _drain(self) -> None:
        """Dispatch every remaining queued chunk as forced partial badges."""
        loop = asyncio.get_running_loop()
        while True:
            badge = self.batcher.take_ready(loop.time(), force=True)
            if badge is None:
                break
            await self._inflight.acquire()
            self._spawn_dispatch(badge)
        for task in list(self._dispatch_tasks):
            await task

    # -- request API ---------------------------------------------------------

    async def score(self, model, rows):
        """Score ``rows`` (a sequence; numpy [n, ...] for the fused backend)
        against ``model``; returns the executor-merged response.

        Requests larger than one badge are split into badge-sized chunks
        that coalesce independently; the response is reassembled in order.
        """
        if self._closed:
            raise EngineClosed("scoring engine closed")
        if self._task is None:
            raise EngineClosed("scoring engine not started (await engine.start())")
        n = len(rows)
        if n == 0:
            raise ValueError("empty request")
        # Minted before admission so even a shed carries the id.
        rid = f"r{next(self._rid):06d}"
        self._admit(model, n, request_id=rid)
        loop = asyncio.get_running_loop()
        now = loop.time()
        bounds = list(range(0, n, self.knobs.max_badge)) + [n]
        req = _Request(model, loop.create_future(), now, len(bounds) - 1,
                       request_id=rid)
        for i in range(len(bounds) - 1):
            self.batcher.push(
                model,
                Chunk(req, i, rows[bounds[i] : bounds[i + 1]],
                      bounds[i + 1] - bounds[i], now),
            )
        self._wake.set()
        parts = await req.future
        return self.executor.merge(parts)

    def _admit(self, model, n: int, request_id: Optional[str] = None) -> None:
        """Admission gate, honoring ``shed_mode=oldest`` eviction."""
        oldest = self.knobs.shed_mode == "oldest"
        try:
            # in oldest mode the first check is a QUIET probe: if eviction
            # makes room, this request is admitted and must not count as
            # shed — the evicted one does
            verdict = self.admission.check(
                model, n, self.batcher.pending_rows(model),
                live_ewma_s=self._ewma_badge_s.get(model),
                count_shed=not oldest,
                request_id=request_id,
            )
        except RequestShed as shed:
            if not oldest:
                raise
            # evict longest-queued requests of this model until the new
            # one fits (still loud: each eviction is a counted shed)
            evicted_any = False
            while self.batcher.pending_rows(model) + n > self.knobs.queue_bound_rows:
                evicted = self.batcher.evict_oldest(model)
                if not evicted:
                    break
                evicted_any = True
                self._fail_evicted(evicted, shed)
            if not evicted_any:
                self.admission.count_shed(
                    model, n,
                    queued_rows=self.batcher.pending_rows(model),
                    backlog_s=shed.retry_after_s,
                    reason="no evictable request to make room",
                    request_id=request_id,
                )
                raise
            verdict = self.admission.check(
                model, n, self.batcher.pending_rows(model),
                live_ewma_s=self._ewma_badge_s.get(model),
                request_id=request_id,
            )
        if verdict.degraded:
            # stamped on the request too, so response-side telemetry can
            # correlate degraded scores with the breaker window
            obs.gauge("serving.degraded").set(1)

    def _fail_evicted(self, evicted: List[Chunk], shed: RequestShed) -> None:
        """Reject every request owning an evicted chunk (oldest-shed mode)."""
        by_req: Dict[int, list] = {}
        for chunk in evicted:
            by_req.setdefault(id(chunk.request), []).append(chunk)
        for chunks in by_req.values():
            req = chunks[0].request
            rows = sum(c.n for c in chunks)
            self.admission.count_shed(
                req.model, rows,
                backlog_s=shed.retry_after_s,
                reason="evicted-oldest",
                request_id=getattr(req, "request_id", None),
            )
            req.fail(
                RequestShed(
                    "request evicted under shed_mode=oldest to admit newer "
                    "traffic", retry_after_s=shed.retry_after_s,
                )
            )

    # -- scheduler -----------------------------------------------------------

    async def _run(self) -> None:
        """The scheduler loop: wait for work or a deadline, assemble,
        dispatch.

        Also the SLO evaluator's mount: one rate-limited ``alerts.tick()``
        per wakeup (the evaluator gates itself on its cadence and on whether
        any rules are configured). The wait is capped at one second only
        while rules are configured.
        """
        from simple_tip_tpu_torch.obs import alerts as alerts_mod

        loop = asyncio.get_running_loop()
        alerting = alerts_mod.enabled()
        while not self._closed:
            deadline = self.batcher.next_deadline()
            timeout = None if deadline is None else max(0.0, deadline - loop.time())
            if alerting and (timeout is None or timeout > 1.0):
                timeout = 1.0
            try:
                await asyncio.wait_for(self._wake.wait(), timeout)
            except asyncio.TimeoutError:
                pass
            self._wake.clear()
            if alerting:
                alerts_mod.tick()
            while not self._closed:
                badge = self.batcher.take_ready(loop.time())
                if badge is None:
                    break
                await self._inflight.acquire()
                self._spawn_dispatch(badge)

    def _on_scheduler_done(self, task: asyncio.Task) -> None:
        """Liveness backstop: a crashed scheduler fails all pending work."""
        if task.cancelled():
            return
        exc = task.exception()
        if exc is None:
            return
        logger.error("serving scheduler task died: %r", exc)
        obs.counter("serving.scheduler_crashes").inc()
        obs.event("serving.scheduler_crash", error=repr(exc)[:200])
        from simple_tip_tpu_torch.obs import alerts as alerts_mod
        from simple_tip_tpu_torch.obs import exporter

        # The loop that would have ticked the evaluator just died: one tick
        # now, so the crash counter lands in a sample.
        alerts_mod.tick()
        if exporter.enabled():
            # Flip /healthz to 503: the engine can no longer serve.
            exporter.set_health("serving", ok=False, error=repr(exc)[:200])
        self._closed = True
        for chunk in self.batcher.drain():
            chunk.request.fail(EngineClosed(f"scheduler task died: {exc!r}"))

    def _spawn_dispatch(self, badge: Badge) -> None:
        """Track one dispatch task (the in-flight semaphore is released in
        its ``finally``, so a lost task cannot leak a slot)."""
        task = asyncio.get_running_loop().create_task(self._dispatch(badge))
        self._dispatch_tasks.add(task)
        task.add_done_callback(self._dispatch_tasks.discard)

    async def _dispatch(self, badge: Badge) -> None:
        """Run one badge on the executor thread; settle its requests."""
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        try:
            try:
                parts = await loop.run_in_executor(
                    None, self._run_badge_sync, badge
                )
            except Exception as exc:  # noqa: BLE001 — typed per-request below
                self._settle_failure(badge, exc)
                return
            self._record_badge(badge, loop.time() - t0)
            self._settle_success(badge, parts)
        finally:
            self._inflight.release()

    def _run_badge_sync(self, badge: Badge):
        """Sync badge dispatch (worker thread): span + retry + breaker."""
        br = self.admission.breaker
        rids = getattr(badge, "request_ids", ()) or ()
        with obs.span(
            "serving.badge",
            model=str(badge.model),
            rows=badge.rows,
            fill=round(badge.fill, 4),
            **({"request_ids": ",".join(rids)} if rids else {}),
        ):
            try:
                parts = self.retry.call(
                    self.executor.run_badge,
                    badge.model,
                    [c.rows for c in badge.chunks],
                    describe=f"serving badge ({badge.model})",
                )
            except Exception:
                self._had_backend_failure = True
                if br is not None:
                    br.record_failure()
                raise
        if br is not None and self._had_backend_failure:
            # only touch the (file-backed) breaker on the recovery edge —
            # a healthy steady state must not pay a state write per badge
            br.record_success()
            self._had_backend_failure = False
        return parts

    # -- settlement ----------------------------------------------------------

    def _record_badge(self, badge: Badge, dt_s: float) -> None:
        """SLO accounting for one completed badge."""
        obs.counter("serving.badges").inc()
        obs.counter("serving.rows").inc(badge.rows)
        obs.histogram("serving.badge_fill").observe(badge.fill)
        obs.gauge("serving.last_badge_fill").set(round(badge.fill, 4))
        obs.quantile("serving.badge_ms").observe(dt_s * 1000.0)
        prev = self._ewma_badge_s.get(badge.model)
        self._ewma_badge_s[badge.model] = (
            dt_s if prev is None else 0.8 * prev + 0.2 * dt_s
        )

    def _settle_success(self, badge: Badge, parts) -> None:
        """Deliver per-chunk results; complete requests whose chunks are in."""
        loop = asyncio.get_running_loop()
        for chunk, part in zip(badge.chunks, parts):
            req = chunk.request
            if req.future.done():
                continue  # already failed (evicted sibling chunk)
            if req.complete_chunk(chunk.index, part):
                obs.quantile("serving.request_ms").observe(
                    (loop.time() - req.t_enqueue) * 1000.0
                )
                req.future.set_result(req.parts)

    def _settle_failure(self, badge: Badge, exc: Exception) -> None:
        """Reject every request riding a failed badge (typed + counted)."""
        obs.counter("serving.backend_errors").inc()
        rids = getattr(badge, "request_ids", ()) or ()
        obs.event(
            "serving.backend_error",
            model=str(badge.model),
            rows=badge.rows,
            error=repr(exc)[:200],
            **({"request_ids": ",".join(rids)} if rids else {}),
        )
        logger.error(
            "serving badge failed for model %r (%d rows): %r",
            badge.model, badge.rows, exc,
        )
        wrapped = BackendDown(
            f"badge dispatch failed after retries for model {badge.model!r}: "
            f"{exc!r}"
        )
        wrapped.__cause__ = exc
        for chunk in badge.chunks:
            chunk.request.fail(wrapped)

    # -- introspection -------------------------------------------------------

    def slo_snapshot(self) -> dict:
        """JSON-safe serving SLO view (the exporter's ``/slo`` route).

        Safe to call from any thread at any time, including the exporter's
        HTTP handler threads while dispatches are landing latencies
        concurrently: ``obs.metrics_snapshot()`` copies the registry under
        its lock in one critical section, so the quantile summaries here
        are a coherent point-in-time view (p50 <= p95 <= p99 always holds
        within one window), and the engine reads touch no filesystem.
        """
        snap = obs.metrics_snapshot()
        counters = snap.get("counters", {})
        quantiles = snap.get("quantiles", {})
        fill = snap.get("histograms", {}).get("serving.badge_fill") or {}
        mean_fill = (
            fill["sum"] / fill["count"] if fill.get("count") else None
        )
        return {
            "request_ms": quantiles.get("serving.request_ms"),
            "badge_ms": quantiles.get("serving.badge_ms"),
            "mean_badge_fill": round(mean_fill, 4) if mean_fill is not None else None,
            "queue_rows": self.batcher.total_rows(),
            "badges": counters.get("serving.badges", 0),
            "rows": counters.get("serving.rows", 0),
            "shed": counters.get("serving.shed", 0),
            "backend_errors": counters.get("serving.backend_errors", 0),
            "knobs": self.knobs.snapshot(),
        }
