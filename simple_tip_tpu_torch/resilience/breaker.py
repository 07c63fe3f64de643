"""Circuit breaker: closed / open / half-open over a backend.

Counterpart of the JAX package's ``resilience/breaker.py``, with its
states, knobs and state file:

- **closed**     calls run; consecutive failures count up;
- **open**       after ``threshold`` consecutive failures, ``allow()`` is
  False until ``cooldown_s`` has passed: callers fail fast (``mode=fail``)
  or go on degraded and say so (``mode=degrade``, the default), counted in
  ``breaker.short_circuit`` and evented as ``breaker.short_circuit``;
- **half-open**  after the cooldown one call is let through; success
  closes the breaker, failure opens it for another cooldown.

State is a small JSON file (``TIP_BREAKER_STATE``, default
``$TIP_ASSETS/breaker_state.json`` when ``TIP_ASSETS`` is set), written
atomically, so processes share one view; without either it is kept in
memory. Timestamps are wall-clock because they cross processes.

Env knobs: ``TIP_BREAKER_THRESHOLD`` (default 2), ``TIP_BREAKER_COOLDOWN_S``
(default 900), ``TIP_BREAKER_MODE`` (``degrade``/``fail``),
``TIP_BREAKER_STATE`` (a path; ``off`` or ``0`` disables the breaker).
Stdlib only.
"""

import json
import logging
import os
import time
from typing import Dict, Optional

from simple_tip_tpu_torch import obs

logger = logging.getLogger(__name__)

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class BackendUnavailable(RuntimeError):
    """The backend is not there to use: a short-circuit in ``mode=fail``, or
    (in the port's device watchdog, which never degrades) a failed probe."""


class CircuitBreaker:
    """File-backed (or process-local) circuit breaker for backend calls."""

    def __init__(
        self,
        state_path: Optional[str],
        threshold: int = 2,
        cooldown_s: float = 900.0,
        mode: str = "degrade",
        name: str = "backend",
    ):
        self.state_path = state_path
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self.mode = mode if mode in ("degrade", "fail") else "degrade"
        self.name = name
        self._local: Dict = {}  # in-memory state when no path is configured

    @classmethod
    def from_env(cls, name: str = "backend") -> Optional["CircuitBreaker"]:
        """Breaker per ``TIP_BREAKER_*`` policy; None when disabled."""
        raw = os.environ.get("TIP_BREAKER_STATE", "").strip()
        if raw.lower() in ("off", "0"):
            return None
        path: Optional[str] = None
        if raw:
            path = raw
        elif os.environ.get("TIP_ASSETS", "").strip():
            from simple_tip_tpu_torch.config import output_folder

            path = os.path.join(output_folder(), "breaker_state.json")

        def _num(var, default):
            try:
                return float(os.environ.get(var, "") or default)
            except ValueError:
                return default

        return cls(
            state_path=path,
            threshold=int(_num("TIP_BREAKER_THRESHOLD", 2)),
            cooldown_s=_num("TIP_BREAKER_COOLDOWN_S", 900.0),
            mode=os.environ.get("TIP_BREAKER_MODE", "degrade").strip() or "degrade",
            name=name,
        )

    # -- state IO ------------------------------------------------------------

    def _load(self) -> Dict:
        if self.state_path is None:
            return dict(self._local)
        try:
            with open(self.state_path, encoding="utf-8") as f:
                st = json.load(f)
            return st if isinstance(st, dict) else {}
        except (OSError, ValueError):
            return {}

    def _store(self, st: Dict) -> None:
        if self.state_path is None:
            self._local = dict(st)
            return
        try:
            os.makedirs(os.path.dirname(self.state_path) or ".", exist_ok=True)
            tmp = f"{self.state_path}.{os.getpid()}.tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(st, f)
            os.replace(tmp, self.state_path)
        except OSError as e:  # breaker state is advisory, never fatal
            logger.warning("breaker state write failed (%s): %s", self.state_path, e)

    # -- protocol ------------------------------------------------------------

    def state(self) -> str:
        """Effective state now: closed, open, or half_open."""
        st = self._load()
        if st.get("state") != OPEN:
            return CLOSED
        if time.time() >= float(st.get("opened_ts", 0)) + self.cooldown_s:
            return HALF_OPEN
        return OPEN

    def allow(self) -> bool:
        """Whether a call may run now (False = short-circuit).

        Half-open lets calls through (one re-tests the backend; racers are
        tolerable).
        Short-circuits count and emit, so the degradation is loud.
        """
        state = self.state()
        if state != OPEN:
            return True
        obs.counter("breaker.short_circuit").inc()
        obs.gauge("breaker.open").set(1)  # re-stamp the level each rejection
        st = self._load()
        now = time.time()  # cross-process timestamp, not a duration
        remaining = float(st.get("opened_ts", 0)) + self.cooldown_s - now
        obs.event(
            "breaker.short_circuit", breaker=self.name,
            cooldown_remaining_s=round(max(0.0, remaining), 1),
        )
        logger.error(
            "circuit breaker %r OPEN (%.0fs of cooldown left): backend call "
            "short-circuited (mode=%s)",
            self.name, max(0.0, remaining), self.mode,
        )
        return False

    def record_success(self) -> None:
        """A call succeeded: reset failures, close the breaker."""
        st = self._load()
        if st.get("state") == OPEN:
            obs.counter("breaker.closed").inc()
            obs.event("breaker.transition", breaker=self.name, to=CLOSED)
            logger.warning(
                "circuit breaker %r CLOSED: backend recovered", self.name
            )
        # Level gauge next to the transition counters (a state, not an edge).
        obs.gauge("breaker.open").set(0)
        self._store({"state": CLOSED, "failures": 0})

    def record_failure(self) -> None:
        """A call failed: count it; open the breaker at the threshold.

        A failure while half-open re-opens immediately (the one test
        call burned; back to a full cooldown).
        """
        st = self._load()
        failures = int(st.get("failures", 0)) + 1
        was_open = st.get("state") == OPEN
        if failures >= self.threshold or was_open:
            if not was_open or self.state() == HALF_OPEN:
                obs.counter("breaker.opened").inc()
                obs.event(
                    "breaker.transition", breaker=self.name, to=OPEN,
                    failures=failures, cooldown_s=self.cooldown_s,
                )
                logger.error(
                    "circuit breaker %r OPEN after %d consecutive "
                    "failure(s): backend considered down for %.0fs "
                    "(mode=%s: %s)",
                    self.name, failures, self.cooldown_s, self.mode,
                    "callers fail fast" if self.mode == "fail"
                    else "callers go on degraded, stamped degraded",
                )
            # Level gauge: 1 for the whole open window, not just the edge.
            obs.gauge("breaker.open").set(1)
            self._store(
                {"state": OPEN, "failures": failures, "opened_ts": time.time()}
            )
        else:
            self._store({"state": CLOSED, "failures": failures})

    def healthy(self) -> bool:
        """Health verdict for ``/healthz``: False exactly while the breaker is
        OPEN in its cooldown (half-open lets a test call through)."""
        return self.state() != OPEN

    def snapshot(self) -> Dict:
        """JSON-safe view for records and diagnostics."""
        st = self._load()
        return {
            "name": self.name,
            "state": self.state(),
            "failures": int(st.get("failures", 0)),
            "threshold": self.threshold,
            "cooldown_s": self.cooldown_s,
            "mode": self.mode,
            **(
                {"opened_unix": round(float(st["opened_ts"]), 1)}
                if "opened_ts" in st
                else {}
            ),
        }
