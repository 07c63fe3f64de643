"""Fault tolerance for study execution: inject, retry, journal, lease, break.

Counterparts of the JAX package's ``resilience`` modules, with the same
knobs, grammars and files:

- ``faults``   deterministic fault injection at named seams
  (``TIP_FAULT_PLAN``): worker kill / wedge, a card-probe timeout, a
  corrupted SA-fit cache entry, a torn artifact write;
- ``retry``    one retry policy (backoff, jitter, monotonic deadline,
  transient / fatal classes; ``TIP_RETRY_*``);
- ``journal``  the crash-safe journal of completed (case study, phase,
  run) units under ``$TIP_ASSETS/journal/runs.jsonl``, shared with the JAX
  package on one ``TIP_ASSETS``: a restarted phase skips finished runs;
- ``breaker``  a closed / open / half-open circuit breaker over the card
  probe (``TIP_BREAKER_*``); ``BackendUnavailable`` is what the port's
  watchdog raises, since nothing of the port degrades to the CPU;
- ``lease``    file-backed work leases with fencing epochs and heartbeat
  membership, the substrate of ``parallel/fleet.py``.

Stdlib only: the scheduler's synthetic-phase workers import this package
without torch.
"""

from simple_tip_tpu_torch.resilience.breaker import BackendUnavailable, CircuitBreaker
from simple_tip_tpu_torch.resilience.faults import (
    FaultPlan,
    InjectedFault,
    active_plan,
    corrupt_file,
    maybe_inject,
)
from simple_tip_tpu_torch.resilience.journal import RunJournal, journal_from_env
from simple_tip_tpu_torch.resilience.lease import (
    COORDINATOR_UNIT,
    FenceToken,
    LeaseLost,
    LeaseManager,
    Membership,
    fleet_now,
)
from simple_tip_tpu_torch.resilience.retry import RetryGiveUp, RetryPolicy

__all__ = [
    "BackendUnavailable",
    "COORDINATOR_UNIT",
    "CircuitBreaker",
    "FaultPlan",
    "FenceToken",
    "InjectedFault",
    "LeaseLost",
    "LeaseManager",
    "Membership",
    "RetryGiveUp",
    "RetryPolicy",
    "RunJournal",
    "active_plan",
    "corrupt_file",
    "fleet_now",
    "journal_from_env",
    "maybe_inject",
]
