"""Live telemetry plane: /healthz /metrics /slo /fleet /alerts (stdlib HTTP).

Counterpart of the JAX package's ``obs/exporter.py``: a daemon
``http.server`` thread that a long-lived process (the scoring engine, the
run scheduler, the fleet parent) mounts with :func:`start`:

- ``/healthz``  liveness and pushed component health: 200 when every
  component is ok, 503 otherwise;
- ``/metrics``  the metrics registry (counters, gauges, histograms, the
  quantile windows) in Prometheus text format, rendered as the JAX
  package renders it;
- ``/slo``      the scoring engine's ``slo_snapshot()`` (JSON), while an
  engine serves;
- ``/fleet``    the fleet parent's membership and lease view
  (``parallel/fleet.py``), while a fleet runs;
- ``/alerts``   the SLO evaluator's cached per-rule alert states, burn
  rates and open incidents (``obs/alerts.py``), while an evaluator is
  mounted in this process.

``TIP_OBS_HTTP`` unset / empty / ``0`` / ``off`` means no socket, no
thread; ``<port>`` binds that port on 127.0.0.1, ``auto`` an ephemeral
one. A bind failure logs a warning and leaves the exporter off.

Handler bodies read only in-memory state: health is pushed by its owners
(:func:`set_health`), and providers (:func:`set_provider`) must return
in-memory views. Stdlib only.
"""

import json
import logging
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from simple_tip_tpu_torch.obs import metrics

# Version stamp on the /healthz JSON body: scrapers archive health
# snapshots next to obs stream rows, so the doc outlives this writer.
SCHEMA = 1

logger = logging.getLogger(__name__)

_lock = threading.Lock()
_server: Optional[ThreadingHTTPServer] = None
_thread: Optional[threading.Thread] = None
_pid: Optional[int] = None  # owner pid: a spawned child must not reuse it
_started_monotonic: Optional[float] = None
# Route providers ("slo") and pushed health components. Plain
# dicts mutated under the GIL: handler threads only .get()/iterate copies.
_providers: Dict[str, Callable[[], dict]] = {}
_health: Dict[str, Dict] = {}

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")
ROUTES = ("/healthz", "/metrics", "/slo", "/fleet", "/alerts")


def _resolve_port() -> Optional[int]:
    """``TIP_OBS_HTTP`` as a bindable port, or None (disabled).

    Unset / empty / ``0`` / ``off`` disable the plane (the TIP_OBS_DIR
    no-op contract); ``auto`` means an ephemeral port (socket port 0);
    anything else must be an integer port. Invalid values warn and
    disable — a typo must not crash a study.
    """
    raw = os.environ.get("TIP_OBS_HTTP", "").strip().lower()
    if raw in ("", "0", "off"):
        return None
    if raw == "auto":
        return 0
    try:
        port = int(raw)
    except ValueError:
        logger.warning("TIP_OBS_HTTP=%r is not a port; exporter disabled", raw)
        return None
    if not 0 < port < 65536:
        logger.warning("TIP_OBS_HTTP=%r out of range; exporter disabled", raw)
        return None
    return port


def enabled() -> bool:
    """Whether the live plane is configured on (knob set to a port)."""
    return _resolve_port() is not None


def bound_port() -> Optional[int]:
    """The actually-bound port of this process's running exporter, or None."""
    with _lock:
        if _server is not None and _pid == os.getpid():
            return _server.server_address[1]
    return None


# -- rendering (module functions so handler bodies stay thin) --------------


def _san(name: str) -> str:
    """A metric name as a valid Prometheus identifier, ``tip_``-prefixed."""
    clean = _NAME_BAD.sub("_", str(name))
    if not clean or clean[0].isdigit():
        clean = "_" + clean
    return "tip_" + clean


def _fmt(v) -> str:
    """A sample value in Prometheus text format."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


def _help_line(fam: str, name: str) -> str:
    """One ``# HELP`` line for family ``fam`` (description from the
    registry; HELP text is single-line by the format's grammar)."""
    text = " ".join(metrics.help_text(name).split()) or name
    return f"# HELP {fam} {text}"


def render_metrics(snap: Optional[dict] = None) -> str:
    """The registry snapshot as Prometheus text exposition format.

    Counters become ``tip_<name>_total`` counter families; gauges map
    1:1; histograms (count/sum/min/max summaries) become a summary family
    plus ``_min``/``_max`` gauges; Quantile windows become summary
    families with ``quantile="0.5|0.95|0.99"`` labels. Non-numeric gauge
    values are skipped — the text format has no string samples. Every
    ``# TYPE`` is preceded by a ``# HELP`` with the family's registry
    description (``metrics.describe``/``help_text``), pinned by
    the JAX package's exporter test.
    """
    if snap is None:
        snap = metrics.snapshot()
    lines = [
        "# HELP tip_up exporter liveness (always 1 while serving)",
        "# TYPE tip_up gauge",
        "tip_up 1",
    ]
    for name, v in (snap.get("counters") or {}).items():
        if not isinstance(v, (int, float)):
            continue
        fam = _san(name) + "_total"
        lines.append(_help_line(fam, name))
        lines.append(f"# TYPE {fam} counter")
        lines.append(f"{fam} {_fmt(v)}")
    for name, v in (snap.get("gauges") or {}).items():
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            continue
        fam = _san(name)
        lines.append(_help_line(fam, name))
        lines.append(f"# TYPE {fam} gauge")
        lines.append(f"{fam} {_fmt(v)}")
    for name, h in (snap.get("histograms") or {}).items():
        if not isinstance(h, dict):
            continue
        fam = _san(name)
        lines.append(_help_line(fam, name))
        lines.append(f"# TYPE {fam} summary")
        lines.append(f"{fam}_count {_fmt(int(h.get('count') or 0))}")
        lines.append(f"{fam}_sum {_fmt(float(h.get('sum') or 0.0))}")
        for bound in ("min", "max"):
            if isinstance(h.get(bound), (int, float)):
                lines.append(
                    f"# HELP {fam}_{bound} {bound} observed by "
                    f"{metrics.help_text(name)}"
                )
                lines.append(f"# TYPE {fam}_{bound} gauge")
                lines.append(f"{fam}_{bound} {_fmt(h[bound])}")
    for name, q in (snap.get("quantiles") or {}).items():
        if not isinstance(q, dict):
            continue
        fam = _san(name)
        lines.append(_help_line(fam, name))
        lines.append(f"# TYPE {fam} summary")
        for label, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
            if isinstance(q.get(key), (int, float)):
                lines.append(f'{fam}{{quantile="{label}"}} {_fmt(q[key])}')
        lines.append(f"{fam}_count {_fmt(int(q.get('count') or 0))}")
    if _health:
        lines.append(
            "# HELP tip_health_ok pushed component health (1 ok, 0 failing)"
        )
        lines.append("# TYPE tip_health_ok gauge")
    for component, rec in sorted(_health.items()):
        lines.append(
            f'tip_health_ok{{component="{_NAME_BAD.sub("_", component)}"}} '
            f"{_fmt(bool(rec.get('ok')))}"
        )
    return "\n".join(lines) + "\n"


def render_healthz() -> dict:
    """The ``/healthz`` JSON body: overall verdict + pushed components."""
    components = {k: dict(v) for k, v in _health.items()}
    ok = all(bool(c.get("ok")) for c in components.values())
    uptime = (
        time.monotonic() - _started_monotonic
        if _started_monotonic is not None
        else None
    )
    return {
        "schema": SCHEMA,
        "ok": ok,
        "pid": os.getpid(),
        "uptime_s": round(uptime, 3) if uptime is not None else None,
        "components": components,
    }


# -- the HTTP surface ------------------------------------------------------


class _Handler(BaseHTTPRequestHandler):
    """Request handler for the live routes.

    Reads only in-memory state (the pushed health dict, the metrics
    registry snapshot, provider-cached views): a filesystem walk or device
    work here would block the caller behind the very stall it diagnoses.
    """

    server_version = "tip-obs-exporter/1"

    def _reply(self, status: int, body: str, ctype: str) -> None:
        """Send one complete response."""
        data = body.encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _reply_json(self, status: int, doc: dict) -> None:
        """Send one JSON response."""
        self._reply(
            status,
            json.dumps(doc, indent=2, sort_keys=True, default=repr) + "\n",
            "application/json",
        )

    def do_GET(self) -> None:  # noqa: N802 — http.server's casing
        """Serve one of the live routes from in-memory state."""
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        if path == "/healthz":
            doc = render_healthz()
            self._reply_json(200 if doc["ok"] else 503, doc)
        elif path == "/metrics":
            self._reply(200, render_metrics(), "text/plain; version=0.0.4")
        elif path in ("/slo", "/fleet", "/alerts"):
            provider = _providers.get(path[1:])
            if provider is None:
                self._reply_json(
                    404, {"error": f"no {path[1:]} provider mounted here"}
                )
                return
            try:
                doc = provider()
            except Exception as e:  # noqa: BLE001 — a bad provider must not kill the thread
                self._reply_json(500, {"error": repr(e)[:200]})
                return
            self._reply_json(200, doc if isinstance(doc, dict) else {"value": doc})
        else:
            self._reply_json(
                404, {"error": "unknown route", "routes": list(ROUTES)}
            )

    def log_message(self, fmt: str, *args) -> None:
        """Route http.server's per-request chatter to the debug log."""
        logger.debug("exporter: " + fmt, *args)


def start() -> Optional[int]:
    """Mount the live plane in this process (idempotent); the bound port.

    Returns None when ``TIP_OBS_HTTP`` is unset/off (the no-op contract),
    or when the bind fails (a sibling process already owns the port) —
    in both cases the caller proceeds exactly as before. A stale handle
    inherited across a fork is discarded, never reused: the server thread
    did not survive into the child.
    """
    global _server, _thread, _pid, _started_monotonic
    port = _resolve_port()
    if port is None:
        return None
    with _lock:
        if _server is not None and _pid == os.getpid():
            return _server.server_address[1]
        _server = None
        _thread = None
        try:
            server = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
        except OSError as e:
            logger.warning(
                "TIP_OBS_HTTP=%s: bind failed (%s); exporter disabled in "
                "pid %d", os.environ.get("TIP_OBS_HTTP"), e, os.getpid(),
            )
            return None
        server.daemon_threads = True
        thread = threading.Thread(
            target=server.serve_forever,
            kwargs={"poll_interval": 0.2},
            name="tip-obs-exporter",
            daemon=True,
        )
        thread.start()
        _server, _thread, _pid = server, thread, os.getpid()
        _started_monotonic = time.monotonic()
        bound = server.server_address[1]
    logger.info(
        "obs exporter serving http://127.0.0.1:%d%s (pid %d)",
        bound, "|".join(ROUTES), os.getpid(),
    )
    return bound


def stop() -> None:
    """Shut the exporter down (idempotent; only the owning pid's server)."""
    global _server, _thread, _started_monotonic
    with _lock:
        server, thread = _server, _thread
        _server = _thread = None
        _started_monotonic = None
        owned = _pid == os.getpid()
    if server is not None and owned:
        try:
            server.shutdown()
            server.server_close()
        except Exception:  # noqa: BLE001 — teardown is best-effort
            pass
        if thread is not None:
            thread.join(timeout=5)


def set_provider(name: str, fn: Callable[[], dict]) -> None:
    """Register the ``/slo``, ``/fleet`` or ``/alerts`` body source.

    ``fn`` runs on a request thread and MUST be an in-memory read (a
    cached view, the metrics registry) — never filesystem or device work.
    """
    _providers[name] = fn


def clear_provider(name: str) -> None:
    """Drop a route provider (no-op when absent)."""
    _providers.pop(name, None)


def set_health(component: str, ok: bool, **details) -> None:
    """Push one component's health verdict into ``/healthz``.

    Owning loops (the serving engine) call
    this on their own cadence; the handler only reads the stored dict.
    Any component with ``ok=False`` turns ``/healthz`` into a 503.
    """
    _health[component] = {"ok": bool(ok), **details}


def clear_health(component: str) -> None:
    """Drop a pushed health component (no-op when absent)."""
    _health.pop(component, None)


def reset() -> None:
    """Test hook: stop the server and drop providers + health state."""
    stop()
    _providers.clear()
    _health.clear()
