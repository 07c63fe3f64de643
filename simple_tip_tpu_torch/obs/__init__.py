"""Telemetry of the port: spans, metrics, the live exporter, and the
observability and planning plane over them.

Counterpart of the JAX package's ``obs`` package:

- ``obs.span("serving.badge", rows=512)`` / ``@obs.traced()``  nested spans
  into the JSONL stream under ``TIP_OBS_DIR`` (``tracer``; no-op when unset);
- ``obs.event("serving.shed", rows=3)``                       lifecycle events;
- ``obs.study_root("full_study", ...)``                       the study's root
  span, its id pinned into the environment for child processes;
- ``obs.counter`` / ``gauge`` / ``histogram`` / ``quantile``  the always-live
  registry (``metrics``), read by ``metrics_snapshot()``;
- ``exporter``: ``/healthz``, ``/metrics``, ``/slo``, ``/fleet`` and
  ``/alerts`` over HTTP when ``TIP_OBS_HTTP`` is set;
- ``devicemeter``: analytic program costs graded against the card's peaks
  (``utils/flops.py``: the H100 SXM's; any other device analytic-only),
  the per-dispatch gauges ``engine/run_program.py`` feeds, and the
  ``mfu_breakdown`` document;
- ``splice``: a ``utils/profiling.maybe_trace`` phase's ``torch.profiler``
  trace shifted under its span;
- ``store`` / ``costmodel``: the feature-store index of every run's cost
  features and the per-phase cost model over it (rows of platform ``tpu``
  left out), quoted by the scheduler, the fleet, admission and
  ``full_study``;
- ``slo`` / ``alerts``: SLO rule documents, burn rates, the alert state
  machine and incidents, ticked by the scoring engine, the run scheduler
  and the fleet parent;
- ``regress`` / ``live``: cross-run regression and trend gates, and
  ``tail`` / ``top`` / ``audit``;
- ``python -m simple_tip_tpu_torch.obs summary|export|check|regress|runs|
  predict|trend|roofline|alerts|incidents|tail|top|audit``: the
  inspection CLI (``cli``), with the JAX package's commands and exit codes.

- ``install_worker_logging`` (``logbridge``): a spawned worker's log
  records to stderr and into its event stream;
- ``record_device_memory`` / ``record_kernel_launches`` /
  ``poll_device_memory``: the card's memory high-water and the launch
  counts a caller hands in as gauges (the scheduler's workers flush them).

Stdlib only: every module here imports without torch (``devicemeter.
detect_device`` and ``maybe_trace``'s profiler import it when called). The
JAX package's compile hook (``install_jax_hooks``) has no counterpart: the
port compiles no XLA.
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
    """Test hook: reset the tracer, metrics, log bridge, alerts, exporter."""
    # alerts is imported here, not at module level, so the package root
    # stays free of import cycles: alerts imports exporter, metrics, slo.
    from simple_tip_tpu_torch.obs import alerts, exporter, logbridge, metrics, tracer

    logbridge.reset()
    tracer.reset()
    metrics.reset()
    alerts.reset()  # before exporter.reset(): drops its /alerts provider
    exporter.reset()
