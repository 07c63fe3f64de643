"""Card responsiveness watchdog, fronted by a circuit breaker.

Counterpart of the JAX package's ``utils/device_watchdog.py``. The probe
runs a small torch op on ``cuda`` in a SUBPROCESS, so a card that hangs in
its driver or at context creation wedges (and gets killed in) the probe,
never the caller, and the caller opens no CUDA context of its own: a parent
about to spawn card workers stays off the card. Probes are forked from a
``forkserver`` whose server has imported torch (and the caller's main
module) but opened no context: the torch import, most of a fresh
interpreter's probe time, is paid once per calling process. The server
keeps the environment it started with.

- **circuit breaker** (``resilience/breaker.py``): consecutive probe
  failures open a shared breaker; while it is open, callers skip the probe.
- **retry** (``resilience/retry.py``): a probe that cannot even spawn (a
  transient ``OSError``) is retried under the ``watchdog`` scope; a probe
  that ran and timed out is evidence, and is not retried here.
- **fault seam** ``watchdog.probe``: a plan can force ``timeout`` or
  ``fail`` without spawning anything.

Deliberate difference from the JAX package: where it switches the process
to the CPU backend after a failed probe or with the breaker open in
``degrade`` mode, the port raises ``BackendUnavailable`` with the reason, in
both breaker modes. Nothing of the port goes on on the CPU by itself;
``device="cpu"`` (``--device cpu``) is the only way onto it.
``degradation_reason()`` keeps its name and says why the last call found
the card unusable (``probe-timeout``, ``probe-fail``, ``breaker-open``).
Stdlib only.
"""

import logging
import multiprocessing
import os
from typing import Optional, Tuple

from simple_tip_tpu_torch import obs
from simple_tip_tpu_torch.resilience import (
    BackendUnavailable,
    CircuitBreaker,
    RetryGiveUp,
    RetryPolicy,
    faults,
)

logger = logging.getLogger(__name__)

_chip_probe_cache: dict = {}

# Why the last ensure_responsive_backend call found the card unusable
# (None = it did not): "probe-timeout", "probe-fail" or "breaker-open".
_last_reason: Optional[str] = None


def degradation_reason() -> Optional[str]:
    """Why the last ``ensure_responsive_backend`` raised, or None."""
    return _last_reason


def cards_hidden() -> bool:
    """True when ``CUDA_VISIBLE_DEVICES`` hides every card (a CPU worker)."""
    raw = os.environ.get("CUDA_VISIBLE_DEVICES")
    return raw is not None and raw.strip() in ("", "-1")


_probe_context = None


def _context():
    """The forkserver the probes are forked from (started at first use)."""
    global _probe_context
    if _probe_context is None:
        ctx = multiprocessing.get_context("forkserver")
        ctx.set_forkserver_preload(["__main__", "torch"])
        _probe_context = ctx
    return _probe_context


def _probe_target(kind: str, conn) -> None:
    """The probe's body: ``chips`` counts the visible cards and runs a small
    op on each; ``op`` runs one on the current card. Sends ``(outcome,
    detail)``; exits non-zero on a failure."""
    try:
        import torch

        if kind == "chips":
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            for i in range(n):
                x = torch.ones(8, device=f"cuda:{i}")
                assert float((x + 1).sum()) == 16.0
            conn.send(("ok", f"{'cuda' if n else 'cpu'} {n}"))
        else:
            x = torch.ones(8, device="cuda")
            assert float((x + 1).sum()) == 16.0
            torch.cuda.synchronize()
            conn.send(("ok", "cuda"))
    except BaseException as e:  # noqa: BLE001 - reported to the caller, then exit 1
        conn.send(("fail", repr(e)[-300:]))
        raise SystemExit(1)


def _spawn_probe(kind: str):
    """Start one probe process (retried for transient spawn errors); returns
    (the process, the receiving end of its pipe)."""
    ctx = _context()
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=_probe_target, args=(kind, send), daemon=True)
    proc.start()
    send.close()
    return proc, recv


def _run_probe(kind: str, timeout_s: float) -> Tuple[str, str]:
    """One probe round: ('ok', detail) | ('fail', detail) | ('timeout', '').

    The ``watchdog.probe`` fault seam can dictate the outcome without
    spawning anything. Spawn failures are retried with backoff
    (``TIP_RETRY_WATCHDOG_*``); a probe that timed out is killed (with a
    bounded wait: a child stuck in an uninterruptible driver call can
    survive SIGKILL) and not retried.
    """
    fault = faults.maybe_inject("watchdog.probe", timeout_s=timeout_s)
    if fault is not None and fault.kind == "timeout":
        return "timeout", ""
    if fault is not None and fault.kind == "fail":
        return "fail", "injected probe failure"
    try:
        proc, recv = RetryPolicy.from_env(
            scope="watchdog", attempts=2, base_s=0.5, deadline_s=30.0
        ).call(_spawn_probe, kind, describe="device probe spawn")
    except (RetryGiveUp, ValueError) as e:
        return "fail", f"probe could not run ({e})"
    try:
        if not recv.poll(timeout_s):
            proc.kill()
            proc.join(5)
            if proc.is_alive():  # pragma: no cover
                logger.error("probe child survived SIGKILL; abandoning it")
            return "timeout", ""
        try:
            outcome, detail = recv.recv()
        except EOFError:
            outcome, detail = "fail", "the probe died without an answer"
        proc.join(5)
        if outcome == "ok" and proc.exitcode == 0:
            return "ok", detail
        return "fail", f"probe exited {proc.exitcode} ({detail})"
    finally:
        recv.close()


def probe_local_chips(timeout_s: float = 90.0) -> int:
    """Number of responsive visible cards, without opening a CUDA context in
    this process.

    0 when ``CUDA_VISIBLE_DEVICES`` hides every card, when no card is
    visible, when the probe fails or times out, or at once when the breaker
    is open (not cached: the breaker may close before the next call).
    Otherwise the (timeout-keyed) result is cached: the probe costs a torch
    import and a context.
    """
    if cards_hidden():
        return 0
    if timeout_s in _chip_probe_cache:
        return _chip_probe_cache[timeout_s]
    breaker = CircuitBreaker.from_env()
    if breaker is not None and not breaker.allow():
        return 0
    outcome, out = _run_probe("chips", timeout_s)
    chips = 0
    if outcome == "ok":
        try:
            platform, n = out.strip().splitlines()[-1].split()
            chips = 0 if platform == "cpu" else int(n)
            obs.counter("watchdog.probe_ok").inc()
            if breaker is not None:
                breaker.record_success()
        except ValueError:
            logger.error("card-count probe output unparsable: %r", out[-200:])
            obs.counter("watchdog.probe_fail").inc()
    elif outcome == "timeout":
        logger.error(
            "card-count probe unresponsive after %.0fs: counting 0 cards", timeout_s
        )
        obs.counter("watchdog.probe_timeout").inc()
        if breaker is not None:
            breaker.record_failure()
    else:
        logger.error("card-count probe failed (%s): counting 0 cards", out)
        obs.counter("watchdog.probe_fail").inc()
        if breaker is not None:
            breaker.record_failure()
    _chip_probe_cache[timeout_s] = chips
    return chips


def _unavailable(reason: str, detail: str) -> BackendUnavailable:
    global _last_reason
    _last_reason = reason
    return BackendUnavailable(
        f"the CUDA card is not usable ({reason}: {detail}); nothing falls back "
        "to the CPU: pass device='cpu' (--device cpu) to run there"
    )


def ensure_responsive_backend(timeout_s: float = 90.0) -> str:
    """Return ``"cuda"`` once a tiny op has run on the card in a subprocess
    within ``timeout_s``; raise ``BackendUnavailable`` (with the reason in
    ``degradation_reason()``) when every card is hidden, when the breaker is
    open, or when the probe fails or times out. Never hangs.
    """
    global _last_reason
    _last_reason = None
    if cards_hidden():
        raise _unavailable("probe-fail", "CUDA_VISIBLE_DEVICES hides every card")
    breaker = CircuitBreaker.from_env()
    if breaker is not None and not breaker.allow():
        raise _unavailable(
            "breaker-open",
            "recent probes failed; wait out the cooldown or delete the "
            "breaker state file to force a probe",
        )
    outcome, detail = _run_probe("op", timeout_s)
    if outcome == "ok":
        platform = detail.strip().splitlines()[-1]
        obs.counter("watchdog.probe_ok").inc()
        obs.event("watchdog.probe", outcome="ok", platform=platform)
        if breaker is not None:
            breaker.record_success()
        return platform
    if breaker is not None:
        breaker.record_failure()
    if outcome == "timeout":
        logger.error("the CUDA card did not answer the probe within %.0fs", timeout_s)
        obs.counter("watchdog.probe_timeout").inc()
        obs.event("watchdog.probe", outcome="timeout", timeout_s=timeout_s)
        raise _unavailable("probe-timeout", f"no answer within {timeout_s:.0f}s")
    logger.error("card probe failed (%s)", detail)
    obs.counter("watchdog.probe_fail").inc()
    obs.event("watchdog.probe", outcome="fail", detail=str(detail)[:200])
    raise _unavailable("probe-fail", str(detail)[:300])
