"""Metrics registry: counters, gauges, histograms and quantile windows.

Counterpart of the JAX package's ``obs/metrics.py``, with the same
instruments, snapshot layout, nearest-rank quantiles and flush contract.
The registry is process-local and always live (an increment is a dict
lookup and an add under one lock), so callers can embed ``snapshot()`` in
their records even when the event stream is off. ``flush()`` writes the
snapshot as one ``metrics`` event into the tracer's stream when
``TIP_OBS_DIR`` is set, and runs at process exit through the tracer's
atexit hook.

Instruments the port feeds: ``serving.*`` (``serving/``), ``breaker.*``
(``resilience/breaker.py``), ``retry.*`` (``resilience/retry.py``),
``scheduler.*`` / ``journal.*`` / ``lease.*`` / ``fleet.*`` / ``faults.*``
(the run scheduler and its resilience layer), the card's memory high-water
(``record_device_memory``, the JAX names) and kernel launch counts handed
in by the caller (``record_kernel_launches``). The JAX package's compile hook
(``install_jax_hooks``) reads jax's compiler events and has no counterpart.
"""

import sys
import threading
import time

_lock = threading.RLock()
_counters = {}
_gauges = {}
_hists = {}
_quantiles = {}
# Per-family descriptions for the exporter's `# HELP` lines: explicit
# registrations via describe() win, then the standing-instrument table
# below, then the family name itself (HELP must never be empty).
_help = {}
# json.dumps of the last snapshot this process flushed into the stream: an
# unchanged registry must not write identical metrics events again.
_last_flushed = None


class Counter:
    """Monotonic counter (``inc``); snapshots as a number."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n=1):
        """Add ``n`` (default 1) to the counter."""
        with _lock:
            self.value += n
        return self


class Gauge:
    """Last-value gauge with a ``set_max`` high-water helper."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = None

    def set(self, v):
        """Set the gauge to ``v``."""
        self.value = v
        return self

    def set_max(self, v):
        """Raise the gauge to ``v`` if higher (high-water semantics)."""
        with _lock:
            if self.value is None or v > self.value:
                self.value = v
        return self


class Histogram:
    """Streaming summary histogram: count / sum / min / max."""

    __slots__ = ("count", "sum", "min", "max")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None

    def observe(self, v):
        """Record one observation."""
        v = float(v)
        with _lock:
            self.count += 1
            self.sum += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v
        return self


def _nearest_rank(window, q: float):
    """Nearest-rank percentile ``q`` (0..100) of a pre-sorted window."""
    if not window:
        return None
    rank = max(1, -(-int(q) * len(window) // 100))  # ceil(q*n/100)
    return window[min(rank, len(window)) - 1]


class Quantile:
    """Sliding-window percentile estimator (SLO p50/p95/p99).

    A bounded ring of the last ``cap`` observations — deterministic (no
    reservoir randomness), O(cap) memory by construction, and windowed the
    way SLO dashboards read latency: recent behavior, not the process's
    whole lifetime. ``percentile`` uses the nearest-rank definition, so
    p50 of [1, 2, 3] is 2, never an interpolated value no request actually
    saw.

    ``summary`` copies and sorts the ring ONCE under the registry lock, so
    its three percentiles describe a single consistent window even while
    writer threads (the serving dispatch pool) observe concurrently —
    p50 <= p95 <= p99 holds by construction, which three independent
    ``percentile`` calls could not guarantee mid-mutation.
    """

    __slots__ = ("count", "cap", "_ring", "_idx")

    def __init__(self, cap: int = 512):
        self.count = 0
        self.cap = max(1, int(cap))
        self._ring = []
        self._idx = 0

    def observe(self, v):
        """Record one observation into the window."""
        v = float(v)
        with _lock:
            self.count += 1
            if len(self._ring) < self.cap:
                self._ring.append(v)
            else:
                self._ring[self._idx] = v
                self._idx = (self._idx + 1) % self.cap
        return self

    def percentile(self, q: float):
        """Nearest-rank percentile ``q`` (0..100) of the window, or None."""
        with _lock:
            window = sorted(self._ring)
        return _nearest_rank(window, q)

    def summary(self) -> dict:
        """JSON-safe p50/p95/p99 + total observation count (one atomic
        copy-under-lock capture of the window; see the class docstring)."""
        with _lock:
            count = self.count
            window = sorted(self._ring)
        return {
            "count": count,
            "p50": _nearest_rank(window, 50),
            "p95": _nearest_rank(window, 95),
            "p99": _nearest_rank(window, 99),
        }


#: Descriptions for the port's standing instruments: the /metrics HELP
#: default when no seam registered its own text (the JAX package's words).
_STANDING_HELP = {
    "breaker.opened": "circuit breaker transitions into OPEN",
    "breaker.closed": "circuit breaker transitions back to CLOSED",
    "breaker.short_circuit": "calls rejected while the breaker was OPEN",
    "breaker.degraded": "calls served by the degraded fallback path",
    "breaker.open": "1 while the circuit breaker is OPEN, else 0",
    "retry.attempts": "retry-policy attempts across all scopes",
    "retry.giveups": "retry-policy exhaustions (budget spent)",
    "serving.request_ms": "serving request latency window (SLO quantiles)",
    "serving.rows": "rows admitted into serving badges",
    "serving.shed": "rows shed by serving admission control",
    "serving.scheduler_crashes": "serving engine scheduler-task deaths",
    "serving.backend_errors": "serving backend dispatch errors",
}


def describe(name: str, text: str) -> None:
    """Register the ``# HELP`` description for metric family ``name``.

    Owning seams call this once next to the instrument they create; the
    exporter falls back to the standing table, then the name itself.
    """
    if text:
        with _lock:
            _help[name] = " ".join(str(text).split())


def help_text(name: str) -> str:
    """The HELP description for ``name`` (never empty)."""
    with _lock:
        text = _help.get(name)
    return text or _STANDING_HELP.get(name) or str(name)


def counter(name: str) -> Counter:
    """Get-or-create the counter ``name``."""
    with _lock:
        c = _counters.get(name)
        if c is None:
            c = _counters[name] = Counter()
        return c


def gauge(name: str) -> Gauge:
    """Get-or-create the gauge ``name``."""
    with _lock:
        g = _gauges.get(name)
        if g is None:
            g = _gauges[name] = Gauge()
        return g


def histogram(name: str) -> Histogram:
    """Get-or-create the histogram ``name``."""
    with _lock:
        h = _hists.get(name)
        if h is None:
            h = _hists[name] = Histogram()
        return h


def quantile(name: str, cap: int = 512) -> Quantile:
    """Get-or-create the sliding-window quantile ``name``."""
    with _lock:
        q = _quantiles.get(name)
        if q is None:
            q = _quantiles[name] = Quantile(cap=cap)
        return q


def snapshot() -> dict:
    """Point-in-time registry state as plain JSON-safe dicts.

    The whole snapshot — quantile summaries included — is built under the
    (re-entrant) registry lock, so readers like ``slo_snapshot()`` and the
    exporter's ``/metrics`` see one coherent view while the batcher's
    dispatch threads mutate the windows: a quantile summary can never mix
    two windows, and counters/quantiles never disagree about which badges
    have landed.

    The ``quantiles`` key is additive next to the original three — the
    metrics event schema (obs/cli.py REQUIRED_KEYS) only pins presence of
    counters/gauges/histograms, so older readers keep parsing.
    """
    with _lock:
        snap = {
            "counters": {k: c.value for k, c in sorted(_counters.items())},
            "gauges": {k: g.value for k, g in sorted(_gauges.items())},
            "histograms": {
                k: {"count": h.count, "sum": h.sum, "min": h.min, "max": h.max}
                for k, h in sorted(_hists.items())
            },
        }
        if _quantiles:
            snap["quantiles"] = {
                k: q.summary() for k, q in sorted(_quantiles.items())
            }
    return snap


def flush() -> None:
    """Write one ``metrics`` event with the current snapshot (if non-empty).

    No-op when the stream is disabled, nothing was ever recorded, or the
    snapshot is byte-identical to the last one this process flushed (so
    periodic pollers do not spam duplicate events); safe to call
    repeatedly (phase boundaries, poll timers, atexit).
    """
    global _last_flushed
    from simple_tip_tpu_torch.obs import tracer

    if not tracer.enabled():
        return
    snap = snapshot()
    if not (
        snap["counters"]
        or snap["gauges"]
        or snap["histograms"]
        or snap.get("quantiles")
    ):
        return
    import json

    encoded = json.dumps(snap, sort_keys=True, default=repr)
    with _lock:
        if encoded == _last_flushed:
            return
        _last_flushed = encoded
    import os

    tracer.write(
        {"type": "metrics", "ts": time.time(), "pid": os.getpid(), **snap}
    )


def record_kernel_launches(counts) -> None:
    """Set ``kernel.<name>.launches`` to each count of ``counts`` (kernel
    name -> launches in this process)."""
    for name, n in counts.items():
        gauge(f"kernel.{name}.launches").set(int(n))


def record_device_memory() -> None:
    """High-water memory of each card this process has opened.

    ``device.<i>.peak_bytes_in_use`` (``torch.cuda.max_memory_allocated``,
    a high-water gauge) and ``device.<i>.bytes_reserved``
    (``torch.cuda.memory_reserved``). Nothing on the CPU, and nothing in a
    process that has not imported torch or opened a CUDA context: this
    never creates one. Never raises.
    """
    torch = sys.modules.get("torch")
    if torch is None:
        return
    try:
        if not torch.cuda.is_initialized():
            return
        for i in range(torch.cuda.device_count()):
            gauge(f"device.{i}.peak_bytes_in_use").set_max(
                int(torch.cuda.max_memory_allocated(i))
            )
            gauge(f"device.{i}.bytes_reserved").set(int(torch.cuda.memory_reserved(i)))
    except Exception:  # noqa: BLE001 - telemetry never takes the process down
        pass


def poll_device_memory() -> None:
    """One poll tick of the scheduler loop: sample the memory gauges and
    flush them if they changed."""
    record_device_memory()
    flush()


def reset() -> None:
    """Drop every registered instrument (test hook)."""
    global _last_flushed
    with _lock:
        _counters.clear()
        _gauges.clear()
        _hists.clear()
        _quantiles.clear()
        _help.clear()
        _last_flushed = None
