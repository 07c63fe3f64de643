"""Telemetry of the port: span tracing, a metrics registry, a live exporter.

Counterpart of the JAX package's ``obs`` package, reduced to what the
scoring service and the resilience helpers use:

- ``obs.span("serving.badge", rows=512)`` / ``@obs.traced()``  nested spans
  into the JSONL stream under ``TIP_OBS_DIR`` (``tracer``; no-op when unset);
- ``obs.event("serving.shed", rows=3)``                       lifecycle events;
- ``obs.counter`` / ``gauge`` / ``histogram`` / ``quantile``  the always-live
  registry (``metrics``), read by ``metrics_snapshot()``;
- ``exporter``: ``/healthz``, ``/metrics``, ``/slo`` over HTTP when
  ``TIP_OBS_HTTP`` is set.

Stdlib only. The JAX package's log bridge, feature store, cost model,
alert evaluator and inspection CLI are not ported.
"""

from simple_tip_tpu_torch.obs.metrics import (
    counter,
    flush as flush_metrics,
    gauge,
    histogram,
    quantile,
    snapshot as metrics_snapshot,
)
from simple_tip_tpu_torch.obs.tracer import (
    enabled,
    event,
    obs_dir,
    record_span,
    reset,
    span,
    traced,
)

__all__ = [
    "counter",
    "enabled",
    "event",
    "flush_metrics",
    "gauge",
    "histogram",
    "metrics_snapshot",
    "obs_dir",
    "quantile",
    "record_span",
    "reset",
    "reset_all",
    "span",
    "traced",
]


def reset_all() -> None:
    """Test hook: reset the tracer, the metrics registry and the exporter."""
    from simple_tip_tpu_torch.obs import exporter, metrics, tracer

    tracer.reset()
    metrics.reset()
    exporter.reset()
