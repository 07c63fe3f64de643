"""Telemetry of the port: span tracing, a metrics registry, a live exporter.

Counterpart of the JAX package's ``obs`` package, reduced to what the
scoring service and the resilience helpers use:

- ``obs.span("serving.badge", rows=512)`` / ``@obs.traced()``  nested spans
  into the JSONL stream under ``TIP_OBS_DIR`` (``tracer``; no-op when unset);
- ``obs.event("serving.shed", rows=3)``                       lifecycle events;
- ``obs.study_root("full_study", ...)``                       the study's root
  span, its id pinned into the environment for child processes;
- ``obs.counter`` / ``gauge`` / ``histogram`` / ``quantile``  the always-live
  registry (``metrics``), read by ``metrics_snapshot()``;
- ``exporter``: ``/healthz``, ``/metrics``, ``/slo`` over HTTP when
  ``TIP_OBS_HTTP`` is set.

- ``install_worker_logging`` (``logbridge``): a spawned worker's log
  records to stderr and into its event stream;
- ``record_device_memory`` / ``record_kernel_launches`` /
  ``poll_device_memory``: the card's memory high-water and the launch
  counts a caller hands in as gauges (the scheduler's workers flush them).

Stdlib only. The JAX package's compile hook, feature store, cost model,
alert evaluator and inspection CLI are not ported.
"""

from simple_tip_tpu_torch.obs.logbridge import install_worker_logging
from simple_tip_tpu_torch.obs.metrics import (
    counter,
    flush as flush_metrics,
    gauge,
    histogram,
    poll_device_memory,
    quantile,
    record_device_memory,
    record_kernel_launches,
    snapshot as metrics_snapshot,
)
from simple_tip_tpu_torch.obs.tracer import (
    enabled,
    event,
    obs_dir,
    record_span,
    reset,
    span,
    study_root,
    traced,
)

__all__ = [
    "counter",
    "enabled",
    "event",
    "flush_metrics",
    "gauge",
    "histogram",
    "install_worker_logging",
    "metrics_snapshot",
    "poll_device_memory",
    "obs_dir",
    "quantile",
    "record_device_memory",
    "record_kernel_launches",
    "record_span",
    "reset",
    "reset_all",
    "span",
    "study_root",
    "traced",
]


def reset_all() -> None:
    """Test hook: reset the tracer, the metrics registry and the exporter."""
    from simple_tip_tpu_torch.obs import exporter, logbridge, metrics, tracer

    logbridge.reset()
    tracer.reset()
    metrics.reset()
    exporter.reset()
