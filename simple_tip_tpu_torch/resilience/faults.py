"""Deterministic fault injection at named seams (``TIP_FAULT_PLAN``).

Counterpart of the JAX package's ``resilience/faults.py``, with its plan
grammar, seams, kinds and claim-marker ledger, so one plan drives both
packages the same way. A plan names WHERE to inject (a seam), WHAT to
inject (a kind), WHICH invocations match and HOW OFTEN.

Plan source: ``TIP_FAULT_PLAN``, inline JSON or ``@/path/to/plan.json``. It
rides ``os.environ`` into every spawned worker. Schema::

    {"seed": 0,                     # optional; gates probabilistic faults
     "state_dir": "/path",          # optional; cross-process claim markers
     "faults": [
       {"site": "worker.run",       # the seam (see SITES)
        "kind": "die",              # the action (see KINDS)
        "match": {"model_id": [1]}, # attr filters; scalar or list values
        "times": 1,                 # max injections PER matched identity
                                    # (0/absent-with-match = unlimited)
        "p": 1.0,                   # injection probability (seeded)
        "delay_s": 0.5,             # die: sleep first (mp.Queue feeder flush)
        "wedge_s": 3600}]}          # wedge: how long to block

Seams (``SITES``), each one ``maybe_inject(site, **attrs)`` call:
``worker.run`` (a scheduler worker after claiming a run), ``watchdog.probe``
(the card probe: ``timeout`` / ``fail`` without spawning), ``sa_cache.load``
(``corrupt`` garbles an SA-fit cache entry before its read),
``artifact.write`` (``torn``: half the payload to the tmp file, then an
error; ``kill``: the same, then ``os._exit``), ``journal.append`` (``torn``
tears the line), ``host.die`` (a fleet member's tick: ``kill``),
``heartbeat.drop`` (``fail`` eats a membership beat), ``lease.steal``
(``fail`` denies a takeover) and ``alerts.save`` (a JAX-package seam the
port has no caller for).

Kinds (``KINDS``): ``die`` / ``wedge`` / ``error`` run inside ``fire``;
``timeout`` / ``fail`` / ``corrupt`` / ``torn`` / ``kill`` are returned to
the seam, which acts them out.

Determinism: ``times`` claims are ``O_CREAT|O_EXCL`` marker files under
``state_dir`` (``TIP_FAULT_STATE``, default ``$TIP_ASSETS/fault_state``)
keyed by (fault index, matched identity), so exactly N injections happen
however many processes race; ``p`` draws from ``random.Random`` seeded by
(plan seed, fault index, identity). Every injection counts
``faults.injected`` (and per site) and emits a ``fault.injected`` event.

Stdlib only.
"""

import json
import logging
import os
import random
import time
from typing import Dict, List, Optional

from simple_tip_tpu_torch import obs

logger = logging.getLogger(__name__)

#: The named seams production code exposes (documented above; fire() warns
#: on a plan naming anything else so a typo'd site cannot silently no-op).
SITES = (
    "worker.run",
    "watchdog.probe",
    "sa_cache.load",
    "artifact.write",
    "journal.append",
    "host.die",
    "heartbeat.drop",
    "lease.steal",
    "alerts.save",
)

#: Process-level kinds executed by fire() itself, and seam-interpreted
#: kinds returned to the caller.
EXECUTED_KINDS = ("die", "wedge", "error")
RETURNED_KINDS = ("timeout", "fail", "corrupt", "torn", "kill")
KINDS = EXECUTED_KINDS + RETURNED_KINDS


class InjectedFault(RuntimeError):
    """Raised by ``error``-kind faults (and ``torn`` write seams)."""


class Fault:
    """One declared fault: a seam, an action, filters and a budget."""

    def __init__(self, spec: Dict, index: int):
        self.index = index
        self.site = spec.get("site", "")
        self.kind = spec.get("kind", "error")
        self.match = dict(spec.get("match") or {})
        self.times = spec.get("times", 1)
        self.p = float(spec.get("p", 1.0))
        self.delay_s = float(spec.get("delay_s", 0.5))
        self.wedge_s = float(spec.get("wedge_s", 3600.0))
        self.msg = spec.get("msg", "")
        if self.site not in SITES:
            logger.warning("fault plan: unknown site %r (known: %s)", self.site, SITES)
        if self.kind not in KINDS:
            logger.warning("fault plan: unknown kind %r (known: %s)", self.kind, KINDS)

    def matches(self, attrs: Dict) -> bool:
        """Whether this fault's ``match`` filters accept ``attrs``."""
        for key, want in self.match.items():
            have = attrs.get(key)
            if isinstance(want, (list, tuple)):
                if have not in want:
                    return False
            elif have != want:
                return False
        return True

    def identity(self, attrs: Dict) -> str:
        """Stable per-matched-entity key: the values of the matched attrs.

        ``times`` budgets are PER identity, so ``match: {"model_id":
        [0, 3]}, times: 1`` fails the first attempt of run 0 AND of run 3
        — the semantics the old per-id attempt markers implemented.
        """
        parts = [f"{k}={attrs.get(k)!r}" for k in sorted(self.match)]
        return ",".join(parts) or "any"


class FaultPlan:
    """A parsed fault plan bound to a claim-marker state directory."""

    def __init__(self, spec: Dict, state_dir: Optional[str] = None):
        self.seed = int(spec.get("seed", 0))
        self.faults: List[Fault] = [
            Fault(f, i) for i, f in enumerate(spec.get("faults") or [])
        ]
        self.state_dir = state_dir or spec.get("state_dir") or _default_state_dir()

    @classmethod
    def from_obj(cls, obj, state_dir: Optional[str] = None) -> "FaultPlan":
        """Plan from an in-memory dict (the scheduler's compat shims)."""
        return cls(dict(obj or {}), state_dir=state_dir)

    def _claim(self, fault: Fault, identity: str) -> bool:
        """Atomically claim one of ``fault.times`` injection slots.

        Marker files under ``state_dir`` are the cross-process ledger:
        ``O_CREAT|O_EXCL`` succeeds for exactly one process per slot, so a
        requeued attempt on a fresh worker sees the budget already spent.
        A ``times`` of 0 (or None) means unlimited — no ledger needed.
        """
        if not fault.times:
            return True
        try:
            os.makedirs(self.state_dir, exist_ok=True)
        except OSError:
            return False  # unclaimable ledger: never inject uncounted
        safe = "".join(c if c.isalnum() or c in "=_-" else "_" for c in identity)
        for n in range(int(fault.times)):
            marker = os.path.join(
                self.state_dir, f"fault{fault.index}_{safe}_{n}.claimed"
            )
            try:
                os.close(os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
                return True
            except FileExistsError:
                continue
            except OSError:
                return False
        return False

    def _gate(self, fault: Fault, identity: str) -> bool:
        """Seeded probability gate — same plan + attrs, same decision."""
        if fault.p >= 1.0:
            return True
        rng = random.Random(f"{self.seed}|{fault.index}|{identity}")
        return rng.random() < fault.p

    def fire(self, site: str, **attrs) -> Optional[Fault]:
        """Inject the first matching fault at ``site``, if any.

        ``die``/``wedge``/``error`` kinds execute here (they are
        process-level); seam-interpreted kinds are returned for the
        caller to act out. Returns None when nothing fires.
        """
        for fault in self.faults:
            if fault.site != site or not fault.matches(attrs):
                continue
            identity = fault.identity(attrs)
            if not self._gate(fault, identity) or not self._claim(fault, identity):
                continue
            obs.counter("faults.injected").inc()
            obs.counter(f"faults.injected.{site}").inc()
            obs.event(
                "fault.injected", site=site, kind=fault.kind, identity=identity,
                **{k: v for k, v in attrs.items() if isinstance(v, (str, int, float))},
            )
            logger.warning(
                "FAULT INJECTED at %s: kind=%s identity=%s", site, fault.kind, identity
            )
            if fault.kind == "die":
                # Let any in-flight mp.Queue feeder release its write lock
                # before dying (see run_scheduler's _test_die).
                time.sleep(fault.delay_s)
                os._exit(1)
            if fault.kind == "wedge":
                time.sleep(fault.wedge_s)
                return fault
            if fault.kind == "error":
                raise InjectedFault(
                    fault.msg or f"injected fault at {site} ({identity})"
                )
            return fault
        return None


def _default_state_dir() -> str:
    """Claim-marker directory: ``TIP_FAULT_STATE`` or the asset bus."""
    raw = os.environ.get("TIP_FAULT_STATE", "").strip()
    if raw:
        return raw
    from simple_tip_tpu_torch.config import output_folder

    return os.path.join(output_folder(), "fault_state")


# (raw env value, parsed plan) — plans are re-parsed only when the env
# string changes (tests flip it per-case; production sets it once).
_env_cache = (None, None)


def active_plan() -> Optional[FaultPlan]:
    """The process's env-configured fault plan, or None (the normal case)."""
    global _env_cache
    raw = os.environ.get("TIP_FAULT_PLAN", "").strip()
    if not raw:
        return None
    if raw == _env_cache[0]:
        return _env_cache[1]
    try:
        if raw.startswith("@"):
            with open(raw[1:], encoding="utf-8") as f:
                spec = json.load(f)
        else:
            spec = json.loads(raw)
        plan = FaultPlan(spec)
    except (OSError, ValueError) as e:
        # A broken plan must fail the chaos run loudly, not silently skip
        # every injection and let the test pass vacuously.
        raise ValueError(f"TIP_FAULT_PLAN unparsable: {e}") from e
    _env_cache = (raw, plan)
    return plan


def maybe_inject(site: str, **attrs) -> Optional[Fault]:
    """Production seam hook: fire the env plan at ``site`` (fast no-op
    when ``TIP_FAULT_PLAN`` is unset)."""
    plan = active_plan()
    if plan is None:
        return None
    return plan.fire(site, **attrs)


def corrupt_file(path: str) -> None:
    """Garble ``path`` in place (the ``corrupt`` kind's effect): truncate
    to half and flip the remaining bytes, so any framed/pickled payload
    fails to parse rather than silently reading wrong."""
    try:
        with open(path, "rb") as f:
            data = f.read()
        with open(path, "wb") as f:
            f.write(bytes(b ^ 0xFF for b in data[: max(1, len(data) // 2)]))
    except OSError as e:  # pragma: no cover — corruption of a missing file
        logger.warning("fault corrupt_file(%s) could not run: %s", path, e)
