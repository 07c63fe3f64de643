"""Admission control: bounded queues, predicted-backlog shedding, breaker.

Counterpart of the JAX package's ``serving/admission.py``. Every decision
is loud: sheds count in ``serving.shed`` (and ``serving.shed_rows``) and
emit a ``serving.shed`` event; breaker short-circuits count in the
breaker's own counters; degraded admissions in ``serving.degraded_admits``.
The per-badge estimate behind the backlog bound is the engine's live EWMA
of badge seconds; until a model's first badge lands it is the cold-start
prior: the active execution plan's ``serving.badge`` estimate, else the
cost model's over the obs feature store (``obs/costmodel.py``), else None
(an empty store), when only the row bound can shed.
"""

import logging
from typing import Optional

from simple_tip_tpu_torch import obs
from simple_tip_tpu_torch.serving.errors import BackendDown, RequestShed
from simple_tip_tpu_torch.serving.knobs import ServingKnobs

logger = logging.getLogger(__name__)


class Verdict:
    """An admitted request's metadata: degraded flag + backlog estimate."""

    __slots__ = ("degraded", "backlog_s")

    def __init__(self, degraded: bool = False, backlog_s: Optional[float] = None):
        self.degraded = degraded
        self.backlog_s = backlog_s


class AdmissionController:
    """Decides admit / shed / fail for one incoming request.

    ``breaker="env"`` builds a ``CircuitBreaker.from_env(name="serving")``
    (None when ``TIP_BREAKER_STATE=off``); tests inject their own. The
    per-badge time estimate is the engine's live EWMA, passed per call.
    """

    COST_PHASE = "serving.badge"

    def __init__(self, knobs: ServingKnobs, breaker="env"):
        self.knobs = knobs
        if breaker == "env":
            from simple_tip_tpu_torch.resilience.breaker import CircuitBreaker

            breaker = CircuitBreaker.from_env(name="serving")
        self.breaker = breaker
        self._cold_estimate_s = None
        self._cold_estimate_done = False

    # -- estimates -----------------------------------------------------------

    def cold_badge_estimate_s(self) -> Optional[float]:
        """Corpus-prior seconds per badge, or None (failure-safe; memoized:
        the index is read once, not per request)."""
        if not self._cold_estimate_done:
            self._cold_estimate_done = True
            try:
                # An active plan's serving.badge estimate is the number the
                # planner sized the study against: it outranks a fresher fit.
                from simple_tip_tpu_torch import plan as _plan
                from simple_tip_tpu_torch.obs.costmodel import quick_phase_estimate

                est = _plan.phase_estimate(self.COST_PHASE, n_runs=1)
                if est is None:
                    est = quick_phase_estimate(self.COST_PHASE, n_runs=1)
                if est and isinstance(est.get("predicted_s"), (int, float)):
                    self._cold_estimate_s = float(est["predicted_s"])
            except Exception:  # noqa: BLE001 — advisory, never load-bearing
                self._cold_estimate_s = None
        return self._cold_estimate_s

    def badge_estimate_s(self, live_ewma_s: Optional[float]) -> Optional[float]:
        """Best available per-badge seconds: live EWMA > corpus prior > None."""
        if live_ewma_s is not None and live_ewma_s > 0:
            return live_ewma_s
        return self.cold_badge_estimate_s()

    def _backlog_s(self, rows: int, badge_s: Optional[float]) -> Optional[float]:
        """Predicted seconds to drain ``rows`` queued rows, or None."""
        if badge_s is None:
            return None
        badges = -(-rows // self.knobs.max_badge)  # ceil
        return badges * badge_s

    # -- the decision --------------------------------------------------------

    def check(
        self,
        model,
        n_rows: int,
        queued_rows: int,
        live_ewma_s: Optional[float] = None,
        count_shed: bool = True,
        request_id: Optional[str] = None,
    ) -> Verdict:
        """Admit (returning a :class:`Verdict`) or raise.

        Raises :class:`BackendDown` when the breaker is open in
        ``mode=fail``; :class:`RequestShed` when the row bound or the
        predicted-backlog bound would be exceeded. ``shed_mode=oldest`` is
        the ENGINE's recovery: it catches the shed, evicts the oldest
        queued request, and re-checks — the bound itself is mode-blind,
        but the engine probes with ``count_shed=False`` so a request that
        ends up ADMITTED (after eviction) is never counted as shed; the
        loud accounting then happens at the true rejection (the evicted
        request, or this one if no eviction is possible).
        """
        degraded = False
        br = self.breaker
        if br is not None and not br.allow():
            # allow() already counted breaker.short_circuit + evented
            if br.mode == "fail":
                obs.counter("serving.breaker_rejects").inc()
                raise BackendDown(
                    f"scoring backend breaker {br.name!r} is open (mode=fail); "
                    f"request for model {model!r} rejected"
                )
            degraded = True
            obs.counter("serving.degraded_admits").inc()
            obs.event("serving.degraded", model=str(model), rows=n_rows)
            logger.error(
                "serving DEGRADED: breaker %r open (mode=degrade); admitting "
                "%d row(s) for model %r against a degraded backend",
                br.name, n_rows, model,
            )

        badge_s = self.badge_estimate_s(live_ewma_s)
        backlog_s = self._backlog_s(queued_rows + n_rows, badge_s)
        if queued_rows + n_rows > self.knobs.queue_bound_rows:
            self._shed(
                model, n_rows, queued_rows, backlog_s,
                f"queue bound: {queued_rows}+{n_rows} rows > "
                f"{self.knobs.queue_bound_rows}",
                count=count_shed,
                request_id=request_id,
            )
        if (
            self.knobs.backlog_bound_s
            and backlog_s is not None
            and backlog_s > self.knobs.backlog_bound_s
        ):
            self._shed(
                model, n_rows, queued_rows, backlog_s,
                f"predicted backlog {backlog_s:.3f}s > "
                f"{self.knobs.backlog_bound_s:.3f}s bound",
                count=count_shed,
                request_id=request_id,
            )
        obs.counter("serving.admitted").inc()
        return Verdict(degraded=degraded, backlog_s=backlog_s)

    def count_shed(
        self,
        model,
        n_rows: int,
        queued_rows: Optional[int] = None,
        backlog_s: Optional[float] = None,
        reason: str = "",
        request_id: Optional[str] = None,
    ) -> None:
        """The loud part of one shed: counters + event + error-level log.

        Called by ``check`` for a directly-rejected request, and by the
        engine for rejections it decides itself (an evicted request in
        ``shed_mode=oldest``, or the incoming one when eviction failed).
        ``request_id`` (when the caller minted one) rides the event so a
        shed greps out of the stream by the same token as a dispatch.
        """
        obs.counter("serving.shed").inc()
        obs.counter("serving.shed_rows").inc(n_rows)
        obs.event(
            "serving.shed",
            model=str(model),
            rows=n_rows,
            reason=reason,
            **({"queued_rows": queued_rows} if queued_rows is not None else {}),
            **(
                {"retry_after_s": round(backlog_s, 4)}
                if backlog_s is not None
                else {}
            ),
            **({"request_id": request_id} if request_id else {}),
        )
        logger.warning(
            "serving SHED %d row(s) for model %r (%s)", n_rows, model, reason
        )

    def _shed(
        self, model, n_rows, queued_rows, backlog_s, reason: str, count: bool,
        request_id: Optional[str] = None,
    ) -> None:
        """Raise one shed (the 429 path), loudly unless this is a probe."""
        if count:
            self.count_shed(model, n_rows, queued_rows, backlog_s, reason,
                            request_id=request_id)
        raise RequestShed(
            f"request shed for model {model!r}: {reason}",
            retry_after_s=backlog_s,
        )
