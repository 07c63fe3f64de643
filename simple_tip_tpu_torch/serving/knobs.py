"""Serving knobs: one parsed view of the ``TIP_SERVE_*`` environment.

Counterpart of the JAX package's ``serving/knobs.py``, with its defaults
and grammar: every knob has a default, a malformed value warns and falls
back instead of raising. ``TIP_SERVE_MAX_BADGE`` (rows a badge, default
2048), ``TIP_SERVE_FLUSH_DEADLINE_MS`` (25), ``TIP_SERVE_QUEUE_BOUND``
(rows queued per model, default 8 badges), ``TIP_SERVE_SHED_MODE``
(``reject`` / ``oldest``), ``TIP_SERVE_INFLIGHT`` (badges dispatched at
once, 2), ``TIP_SERVE_MAX_BACKLOG_S`` (predicted backlog bound, 0 = off).
"""

import logging
import os

logger = logging.getLogger(__name__)

#: Accepted ``TIP_SERVE_SHED_MODE`` values: ``reject`` refuses the incoming
#: request at the bound; ``oldest`` evicts the longest-queued request(s) to
#: admit the new one (both count + event the shed — loudness is not a mode).
SHED_MODES = ("reject", "oldest")


def _env_num(var: str, default, cast=float, minimum=None):
    """``cast(os.environ[var])`` with warn-and-default on a malformed value."""
    raw = os.environ.get(var, "").strip()
    if not raw:
        return default
    try:
        val = cast(float(raw))
    except ValueError:
        logger.warning("%s=%r is not a number; using %r", var, raw, default)
        return default
    if minimum is not None and val < minimum:
        logger.warning("%s=%r below minimum %r; clamping", var, raw, minimum)
        return minimum
    return val


class ServingKnobs:
    """Parsed serving configuration (immutable by convention)."""

    def __init__(
        self,
        max_badge: int = 2048,
        flush_deadline_s: float = 0.025,
        queue_bound_rows: int = None,
        shed_mode: str = "reject",
        max_inflight: int = 2,
        backlog_bound_s: float = 0.0,
    ):
        self.max_badge = max(1, int(max_badge))
        self.flush_deadline_s = max(0.0, float(flush_deadline_s))
        # default queue bound: 8 badges of backlog — bounded by construction,
        # never "unlimited" (unbounded queuing is the failure mode the
        # admission controller exists to prevent)
        self.queue_bound_rows = int(
            queue_bound_rows if queue_bound_rows is not None else 8 * self.max_badge
        )
        self.shed_mode = shed_mode if shed_mode in SHED_MODES else "reject"
        # 2 = double buffering: one badge on device while the next assembles
        self.max_inflight = max(1, int(max_inflight))
        # 0 disables the predicted-backlog bound (row bound still applies)
        self.backlog_bound_s = max(0.0, float(backlog_bound_s))

    @classmethod
    def from_env(cls) -> "ServingKnobs":
        """Knobs per the ``TIP_SERVE_*`` environment (see module doc)."""
        mode = os.environ.get("TIP_SERVE_SHED_MODE", "").strip().lower() or "reject"
        if mode not in SHED_MODES:
            logger.warning(
                "TIP_SERVE_SHED_MODE=%r not in %s; using 'reject'", mode, SHED_MODES
            )
            mode = "reject"
        base = cls()
        return cls(
            max_badge=_env_num("TIP_SERVE_MAX_BADGE", base.max_badge, int, 1),
            flush_deadline_s=_env_num(
                "TIP_SERVE_FLUSH_DEADLINE_MS", base.flush_deadline_s * 1000.0,
                minimum=0.0,
            )
            / 1000.0,
            queue_bound_rows=_env_num(
                "TIP_SERVE_QUEUE_BOUND", base.queue_bound_rows, int, 1
            ),
            shed_mode=mode,
            max_inflight=_env_num("TIP_SERVE_INFLIGHT", base.max_inflight, int, 1),
            backlog_bound_s=_env_num(
                "TIP_SERVE_MAX_BACKLOG_S", base.backlog_bound_s, minimum=0.0
            ),
        )

    def snapshot(self) -> dict:
        """JSON-safe view for records and diagnostics."""
        return {
            "max_badge": self.max_badge,
            "flush_deadline_ms": round(self.flush_deadline_s * 1000.0, 3),
            "queue_bound_rows": self.queue_bound_rows,
            "shed_mode": self.shed_mode,
            "max_inflight": self.max_inflight,
            "backlog_bound_s": self.backlog_bound_s,
        }
