"""Retry policy: exponential backoff, jitter and a monotonic deadline.

Counterpart of the JAX package's ``resilience/retry.py``, with its
grammar and taxonomy:

- **transient** failures (IO hiccups, timeouts, dropped connections) back
  off and retry;
- **fatal** ones (bad input, programming errors, interrupts) raise at once;
- when the budget is spent, ``call`` raises ``RetryGiveUp`` from the last
  error, and the caller decides whether to degrade.

Env knobs (all optional), with per-scope overrides: ``TIP_RETRY_ATTEMPTS``,
``TIP_RETRY_BASE_S``, ``TIP_RETRY_FACTOR``, ``TIP_RETRY_MAX_S``,
``TIP_RETRY_DEADLINE_S``, ``TIP_RETRY_JITTER``; for a scope ``foo``
(``RetryPolicy.from_env(scope="foo")``) ``TIP_RETRY_FOO_ATTEMPTS`` etc.
take precedence. Deadlines run on ``time.monotonic``.

Counters: ``retry.attempts`` (each retry taken) and ``retry.giveups``
(budgets spent). Stdlib only.
"""

import logging
import os
import random
import time
from typing import Callable, Iterator, Optional, Tuple

from simple_tip_tpu_torch import obs

logger = logging.getLogger(__name__)

#: Exception types retried by default: environmental, not programming,
#: failures. Callers narrow or widen per site via ``transient=``.
DEFAULT_TRANSIENT = (OSError, TimeoutError, ConnectionError, EOFError)


class RetryGiveUp(RuntimeError):
    """Raised when the retry budget (attempts or deadline) is exhausted;
    ``__cause__`` carries the last underlying error."""


def _env_float(scope: str, name: str, default: float, inherit: bool = True) -> float:
    """``TIP_RETRY_<SCOPE>_<NAME>`` > ``TIP_RETRY_<NAME>`` > default.

    ``inherit=False`` skips the global fallback — for scopes whose retries
    are expensive enough (whole-run requeues) that a blanket retry bump
    must not silently multiply them.
    """
    names = [f"TIP_RETRY_{scope.upper()}_{name}"] if scope else []
    if inherit or not scope:
        names.append(f"TIP_RETRY_{name}")
    for var in names:
        raw = os.environ.get(var, "").strip()
        if raw:
            try:
                return float(raw)
            except ValueError:
                logger.warning("%s=%r is not a number; ignoring", var, raw)
    return default


class RetryPolicy:
    """One retry budget: attempt count, backoff curve, wall deadline.

    Immutable by convention; build via the constructor or ``from_env``.
    ``attempts`` counts TOTAL tries (1 = no retry); ``deadline_s`` bounds
    the whole call including sleeps (None = unbounded); ``jitter`` is the
    +/- fraction applied to each delay (seedable for deterministic tests).
    """

    def __init__(
        self,
        attempts: int = 3,
        base_s: float = 0.1,
        factor: float = 2.0,
        max_s: float = 30.0,
        deadline_s: Optional[float] = 120.0,
        jitter: float = 0.1,
        seed: Optional[int] = None,
    ):
        self.attempts = max(1, int(attempts))
        self.base_s = max(0.0, float(base_s))
        self.factor = max(1.0, float(factor))
        self.max_s = max(0.0, float(max_s))
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self.jitter = max(0.0, float(jitter))
        self.seed = seed

    @classmethod
    def from_env(cls, scope: str = "", inherit: bool = True, **defaults) -> "RetryPolicy":
        """Policy from ``TIP_RETRY_*`` (scoped names win; see module doc).

        ``defaults`` override the class defaults but still lose to env;
        ``inherit=False`` makes the scope ignore the unscoped globals.
        """
        base = cls(**defaults)
        deadline = _env_float(
            scope, "DEADLINE_S",
            -1.0 if base.deadline_s is None else base.deadline_s,
            inherit,
        )
        return cls(
            attempts=int(_env_float(scope, "ATTEMPTS", base.attempts, inherit)),
            base_s=_env_float(scope, "BASE_S", base.base_s, inherit),
            factor=_env_float(scope, "FACTOR", base.factor, inherit),
            max_s=_env_float(scope, "MAX_S", base.max_s, inherit),
            deadline_s=None if deadline < 0 else deadline,
            jitter=_env_float(scope, "JITTER", base.jitter, inherit),
            seed=base.seed,
        )

    def delays(self) -> Iterator[float]:
        """The backoff sequence: ``attempts - 1`` jittered delays."""
        rng = random.Random(self.seed) if self.seed is not None else random
        for i in range(self.attempts - 1):
            delay = min(self.max_s, self.base_s * (self.factor**i))
            if self.jitter:
                delay *= 1.0 + self.jitter * rng.uniform(-1.0, 1.0)
            yield max(0.0, delay)

    def call(
        self,
        fn: Callable,
        *args,
        transient: Tuple = DEFAULT_TRANSIENT,
        fatal: Tuple = (),
        describe: str = "",
        on_retry: Optional[Callable] = None,
        **kwargs,
    ):
        """``fn(*args, **kwargs)`` under this budget.

        Exceptions in ``fatal`` (checked first), interrupts, and anything
        NOT in ``transient`` propagate immediately. Transient failures
        back off and retry until attempts or the monotonic deadline run
        out, then raise ``RetryGiveUp`` from the last error.
        ``on_retry(attempt, exc, delay)`` observes each retry.
        """
        what = describe or getattr(fn, "__name__", "call")
        deadline = (
            None if self.deadline_s is None
            else time.monotonic() + self.deadline_s
        )
        last: Optional[BaseException] = None
        delays = list(self.delays()) + [None]  # None marks the final try
        for attempt, delay in enumerate(delays, start=1):
            try:
                return fn(*args, **kwargs)
            except (KeyboardInterrupt, SystemExit):
                raise
            except fatal:
                raise
            except transient as e:
                last = e
                if delay is None:
                    break  # budget spent
                if deadline is not None and time.monotonic() + delay > deadline:
                    logger.warning(
                        "%s: not retrying (%.1fs deadline would pass): %r",
                        what, self.deadline_s, e,
                    )
                    break
                obs.counter("retry.attempts").inc()
                logger.warning(
                    "%s failed (attempt %d/%d): %r — retrying in %.2fs",
                    what, attempt, self.attempts, e, delay,
                )
                if on_retry is not None:
                    on_retry(attempt, e, delay)
                time.sleep(delay)
        obs.counter("retry.giveups").inc()
        obs.event("retry.giveup", what=what, attempts=self.attempts)
        raise RetryGiveUp(
            f"{what}: gave up after {self.attempts} attempt(s): {last!r}"
        ) from last
