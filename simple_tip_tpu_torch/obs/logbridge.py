"""Worker log routing: a spawned worker's ``logger.*`` lands somewhere.

Counterpart of the JAX package's ``obs/logbridge.py``. Scheduler workers
are fresh spawned interpreters with no logging configuration, so
``install_worker_logging`` gives each one two sinks:

1. stderr, with a ``[pid/worker-idx]`` prefix so that interleaved worker
   output stays attributable;
2. the obs event stream (``type: "log"`` records) when ``TIP_OBS_DIR`` is
   set.

Idempotent per process, and the obs sink drops a record emitted while it
writes one instead of looping. Stdlib only.
"""

import logging
import os
import threading
import time

from simple_tip_tpu_torch.obs import tracer

_installed = False
_in_emit = threading.local()


class ObsLogHandler(logging.Handler):
    """Route log records into the obs JSONL stream as ``log`` events."""

    def emit(self, record):
        """Write one ``log`` event; recursion- and failure-safe."""
        if getattr(_in_emit, "on", False) or not tracer.enabled():
            return
        _in_emit.on = True
        try:
            tracer.write(
                {
                    "type": "log",
                    "ts": time.time(),
                    "pid": os.getpid(),
                    "level": record.levelname,
                    "logger": record.name,
                    "msg": self.format(record),
                }
            )
        except Exception:  # noqa: BLE001 — logging must never raise
            pass
        finally:
            _in_emit.on = False


def install_worker_logging(worker: str = "", level=logging.INFO) -> None:
    """Install the worker log sinks on the root logger (idempotent).

    ``worker`` is the scheduler's worker index (defaults to the
    ``TIP_OBS_WORKER`` env var the scheduler stamps on spawn); it appears in
    the stderr prefix as ``[pid/worker-idx]``. Existing root handlers are
    left alone — in the parent process (which usually has its own logging
    config) this only ADDS the obs sink, it never reformats the console.
    """
    global _installed
    root = logging.getLogger()
    # Idempotence is decided by INSPECTING the root logger, not only the
    # module flag: a scheduler phase that requeues after a worker death (or
    # a test's reset_all()) may re-enter here in a process whose logger
    # already carries the bridge — adding a second ObsLogHandler would
    # duplicate every record in the event stream from then on.
    has_bridge = any(isinstance(h, ObsLogHandler) for h in root.handlers)
    if _installed or has_bridge:
        _installed = True
        return
    _installed = True
    worker = worker or os.environ.get("TIP_OBS_WORKER", "").strip()
    tag = f"[{os.getpid()}/{worker}]" if worker else f"[{os.getpid()}]"
    if root.level > level or root.level == logging.NOTSET:
        root.setLevel(level)
    if not root.handlers:
        stderr_handler = logging.StreamHandler()
        stderr_handler.setFormatter(
            logging.Formatter(f"{tag} %(levelname)s %(name)s: %(message)s")
        )
        root.addHandler(stderr_handler)
    if tracer.enabled():
        obs_handler = ObsLogHandler()
        obs_handler.setFormatter(logging.Formatter("%(message)s"))
        root.addHandler(obs_handler)


def reset() -> None:
    """Forget the installed state (test hook; handlers are not removed)."""
    global _installed
    _installed = False
