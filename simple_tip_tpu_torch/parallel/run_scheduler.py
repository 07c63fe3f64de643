"""Run-level parallelism: worker processes over model ids.

Counterpart of the JAX package's ``parallel/run_scheduler.py``, with its
phases, knobs and failure contract:

- ``spawn`` (never ``fork``): CUDA cannot be used in a forked child once
  the parent has initialised it, and the parent never initialises it here
  (``utils/device_watchdog.probe_local_chips`` counts the cards in a
  subprocess). Each worker is a fresh interpreter.
- Work is a queue of model ids (or, with ``group_size`` G above 1, of
  G-id group tuples that one phase call scores together), not a
  pre-chunked split, so a slow run does not strand its worker's other ids.
- Platform policy (``default_worker_platforms``): the first
  ``local_chips`` workers are ``default`` (the card: their phase gets
  ``device=None``), the rest ``cpu`` (``device="cpu"`` and an empty
  ``CUDA_VISIBLE_DEVICES``, so they never open a context);
  ``TIP_WORKER_PLATFORMS`` (comma list of ``default`` / ``cpu``, cycled)
  overrides it, and ``default,default`` puts two workers on one card.
  The case studies (``CaseStudy._dispatch_workers``) use this policy only
  for an override: one card serves several processes, so without one
  every worker of a card phase is ``default``.
- Failures are per model id: a worker exception (or death) marks that id
  failed and the scheduler raises ONE error at the end listing them.
  Artifacts are file-granular, so re-running the failed ids is safe.
- Wedge recovery: workers announce each unit before running it. A unit
  past ``run_timeout_s`` (``TIP_RUN_TIMEOUT_S``, default 3600 s) gets its
  worker terminated and is requeued ONCE onto a freshly spawned worker
  (``TIP_RETRY_SCHED_*`` tunes the budget); a second timeout marks it
  failed. A worker that dies without reporting is handled the same way.
  The fresh worker is CPU-pinned, as in the JAX package, for synthetic
  phases and for real phases placed on the CPU only; a real phase with a
  worker on the card gets a fresh card worker, so no run of a card phase
  is scored on the CPU. Each requeue is logged, counted
  (``scheduler.timeouts`` / ``scheduler.worker_deaths``,
  ``scheduler.requeues``) and evented (``scheduler.requeue`` with the id
  and the new worker's ``platform``).
- Resume: with a journal (``resilience/journal.py``: ``TIP_JOURNAL``, or
  a set ``TIP_ASSETS``) the journaled ids are skipped before units form.
- Fleet (``fleet=``, ``parallel/fleet.py``): ids are claimed through
  file-backed leases and committed through the journal with a fence.

Synthetic phases (``_test_*``) import no torch, so their workers spawn in
well under a second; the module itself is stdlib only.
"""

import logging
import multiprocessing as mp
import os
import queue as queue_mod
import time
from typing import Dict, List, Optional, Set

from simple_tip_tpu_torch import obs
from simple_tip_tpu_torch.ops import launch_counts
from simple_tip_tpu_torch.resilience import (
    LeaseLost,
    RetryPolicy,
    faults,
    journal_from_env,
)

logger = logging.getLogger(__name__)

# Grace added to run_timeout_s before presuming a silent worker pool wedged
# at startup: a fresh spawn pays the interpreter, the torch import and the
# card's context (tens of seconds).
_STARTUP_GRACE_S = 120.0

# Device-memory poll period for the scheduler loop (TIP_OBS_MEMPOLL_S, 0
# disables): with telemetry on, the gauges are sampled and flushed on this
# cadence. The parent opens no CUDA context, so its poll records nothing
# of the card; each card worker records its own after every unit.
_DEFAULT_MEMPOLL_S = 30.0

# Consecutive wedged-journal probes before /healthz flips the journal
# component unhealthy. One failed non-blocking flock probe is ordinary
# contention with a fenced commit or a compaction; several in a row (at the
# ~1s health cadence) means a holder died or stalled with the lock held —
# the wedge /healthz exists to surface.
_JOURNAL_WEDGE_POLLS = 3

# Cadence of the health push + scheduler gauges while the phase loop runs.
_HEALTH_PUSH_S = 1.0

# Registered phase runners, by name so the spawn pickling stays trivial.
# Each maps (case_study_obj, [model_id], kwargs) -> None and must itself be
# single-process (num_workers forced to 1 inside the worker). A real phase
# gets the worker's ``device``: None (the card) on a ``default`` worker,
# "cpu" on a ``cpu`` one.


def _phase_test_prio(cs, ids, **kw):
    cs.run_prio_eval(ids, num_workers=1, **kw)


def _phase_active_learning(cs, ids, **kw):
    cs.run_active_learning_eval(ids, num_workers=1, **kw)


def _phase_at_collection(cs, ids, **kw):
    cs.collect_activations(ids, num_workers=1, **kw)


def _phase_test_sleep(
    cs,
    ids,
    seconds=0.5,
    marker_dir=None,
    fail_ids=(),
    barrier_n=0,
    barrier_timeout=120.0,
    **kw,
):
    """Scheduler-test phase: sleeps, records a [start, end] interval marker.

    Sleeping (not spinning) lets the concurrency-overlap test pass on a
    busy host; ``fail_ids`` exercises the per-id failure path. With
    ``barrier_n`` > 0, the phase first rendezvouses until that many DISTINCT
    worker pids have arrived (filesystem barrier) — without real
    concurrency, one worker could drain the whole queue while the other is
    still paying interpreter startup, making interval overlap flaky.
    """
    for i in ids:
        if i in set(fail_ids):
            raise RuntimeError(f"synthetic failure for run {i}")
        if marker_dir and barrier_n:
            with open(os.path.join(marker_dir, f"arrived_{os.getpid()}"), "w"):
                pass
            deadline = time.time() + barrier_timeout
            while time.time() < deadline:
                arrived = [
                    f for f in os.listdir(marker_dir) if f.startswith("arrived_")
                ]
                if len(arrived) >= barrier_n:
                    break
                time.sleep(0.05)
        start = time.time()
        time.sleep(seconds)
        if marker_dir:
            with open(os.path.join(marker_dir, f"run_{i}.txt"), "w") as f:
                f.write(f"{start} {time.time()} {os.getpid()}")


def _phase_test_fault(cs, ids, marker_dir=None, plan=None, seconds=0.0, **kw):
    """Scheduler-chaos phase: run ids under an INLINE fault plan.

    ``plan`` is a fault-plan dict (resilience/faults.py) whose ``worker.run``
    faults fire per id (``die`` hard-exits the worker, ``wedge`` blocks
    until SIGTERM, ``error`` raises), its ``times`` ledger the claim
    markers under ``marker_dir``. Env-driven plans (``TIP_FAULT_PLAN``)
    fire at the ``_worker_main`` seam instead; this phase also writes
    attempt and completion markers.
    """
    fault_plan = (
        faults.FaultPlan.from_obj(plan, state_dir=marker_dir) if plan else None
    )
    for i in ids:
        if marker_dir:
            with open(os.path.join(marker_dir, f"attempt_{i}"), "a") as f:
                f.write(f"{os.getpid()}\n")
        if fault_plan is not None:
            fault_plan.fire("worker.run", model_id=i)
        if seconds:
            time.sleep(seconds)
        if marker_dir:
            with open(os.path.join(marker_dir, f"run_{i}.txt"), "w") as f:
                f.write(f"{time.time()} {time.time()} {os.getpid()}")


def _phase_test_wedge(cs, ids, marker_dir=None, wedge_ids=(), always_wedge=False, **kw):
    """Shim over ``_test_fault``: the FIRST attempt at a ``wedge_ids`` id
    blocks far beyond any test timeout (a hung device call stand-in: it
    never returns and must be terminated); the retry
    (requeued onto a fresh worker, which sees the spent fault claim)
    completes. ``always_wedge`` (``times: 0`` = unlimited) wedges every
    attempt — the both-attempts-dead path.
    """
    plan = {
        "faults": [
            {
                "site": "worker.run",
                "kind": "wedge",
                "match": {"model_id": list(wedge_ids)},
                "times": 0 if always_wedge else 1,
            }
        ]
    }
    _phase_test_fault(cs, ids, marker_dir=marker_dir, plan=plan, **kw)


def _phase_test_die(cs, ids, marker_dir=None, die_ids=(), **kw):
    """Shim over ``_test_fault``: the first attempt at a ``die_ids``
    id hard-exits the worker without reporting (segfault/OOM-kill
    stand-in); the requeued retry completes. The fault's ``delay_s``
    (default 0.5) lets the mp.Queue feeder flush the preceding done_q
    "start" put and RELEASE the shared write-lock semaphore before dying —
    ``os._exit`` mid-feeder-write would deadlock every sibling process on
    the orphaned lock (an mp.Queue property, not a scheduler bug).
    """
    plan = {
        "faults": [
            {
                "site": "worker.run",
                "kind": "die",
                "match": {"model_id": list(die_ids)},
                "times": 1,
                "delay_s": 0.5,
            }
        ]
    }
    _phase_test_fault(cs, ids, marker_dir=marker_dir, plan=plan, **kw)


PHASES = {
    "test_prio": _phase_test_prio,
    "active_learning": _phase_active_learning,
    "at_collection": _phase_at_collection,
    "_test_sleep": _phase_test_sleep,
    "_test_fault": _phase_test_fault,
    "_test_wedge": _phase_test_wedge,
    "_test_die": _phase_test_die,
}

#: Phases that never touch the case study or torch: workers skip the torch
#: import and the case study for them, so they spawn in well under a second.
_SYNTHETIC_PHASES = frozenset(p for p in PHASES if p.startswith("_test_"))


def _unit_members(unit) -> List[int]:
    """Model ids inside one work unit (scalar id, or a G-id group tuple)."""
    return list(unit) if isinstance(unit, (tuple, list)) else [unit]


def _worker_main(
    case_study,
    phase,
    work_q,
    done_q,
    stop_event,
    phase_kwargs,
    env_overrides,
    backend_flags=None,
    cpu_threads=0,
):
    """Entry point of one spawned worker process.

    ``env_overrides`` carries ``TIP_OBS_PLATFORM`` (``default`` or ``cpu``),
    which picks the ``device`` a real phase gets. ``backend_flags`` (the
    parent's ``device.backend_flags()``) are applied before the case study
    is built, so the worker picks the parent's cuDNN algorithms.
    ``cpu_threads`` is a CPU worker's share of the host's cores, used
    unless ``OMP_NUM_THREADS`` is set.
    """
    os.environ.update(env_overrides)
    # Fresh interpreter, no logging config: route logger.* to stderr with a
    # [pid/worker-idx] prefix and, with TIP_OBS_DIR set, into the stream.
    obs.install_worker_logging()
    phase_kwargs = dict(phase_kwargs)
    if phase in _SYNTHETIC_PHASES:
        # Synthetic/chaos phases never touch the case study or the card:
        # skipping the torch import keeps the spawn cheap.
        cs = None
    else:
        platform = os.environ.get("TIP_OBS_PLATFORM", "default")
        phase_kwargs["device"] = "cpu" if platform == "cpu" else None
        if backend_flags is not None:
            from simple_tip_tpu_torch.device import apply_backend_flags

            apply_backend_flags(**backend_flags)
        if platform == "cpu" and cpu_threads and not os.environ.get("OMP_NUM_THREADS"):
            import torch

            torch.set_num_threads(int(cpu_threads))
        from simple_tip_tpu_torch.casestudies.base import get_case_study

        cs = get_case_study(case_study)
    fn = PHASES[phase]
    while True:
        try:
            # Blocking with timeout (NOT get_nowait): queue items travel
            # through a feeder thread, so an early get_nowait can see Empty
            # before already-put ids reach the pipe and silently strand them.
            # The stop event, set by the scheduler only once every id has
            # resolved, is the exit signal. A unit is one model id or a G-id
            # group tuple: the phase fn receives all its ids in ONE call so
            # the grouped chain can score them per dispatch.
            unit = work_q.get(timeout=0.5)
        except queue_mod.Empty:
            if stop_event.is_set():
                # Explicit flush (not only atexit): the scheduler may
                # terminate() a worker that dallies at shutdown.
                obs.flush_metrics()
                return
            continue
        ids = _unit_members(unit)
        # Announce the claim so the scheduler can detect a wedged/killed
        # worker holding this unit and requeue it.
        done_q.put(("start", unit, os.getpid()))
        try:
            # Env-plan fault seam: a TIP_FAULT_PLAN "worker.run" fault
            # kills, wedges or errors this attempt AFTER the claim is
            # announced, for any phase (error kinds report as per-id
            # failures). Fired per member so a plan matching any grouped id
            # still triggers.
            for model_id in ids:
                faults.maybe_inject("worker.run", phase=phase, model_id=model_id)
            span_kw = (
                {"model_id": ids[0]} if len(ids) == 1 else {"model_ids": ids}
            )
            with obs.span(
                "run", phase=phase, case_study=case_study, **span_kw
            ):
                fn(cs, ids, **phase_kwargs)
            done_q.put(("done", unit, None))
        except (KeyboardInterrupt, SystemExit) as e:
            # Report the interrupted unit, then actually stop: an
            # interrupted worker must not keep draining the queue.
            done_q.put(("done", unit, repr(e)))
            obs.flush_metrics()
            raise
        except BaseException as e:  # noqa: BLE001 — reported; scheduler decides
            done_q.put(("done", unit, repr(e)))
        obs.record_device_memory()
        obs.record_kernel_launches(launch_counts())
        obs.flush_metrics()


def default_worker_platforms(num_workers: int, local_chips: int) -> List[str]:
    """Platform per worker: cards first, CPU for the overflow workers.

    ``TIP_WORKER_PLATFORMS`` (comma list of ``default``/``cpu``, cycled)
    overrides the policy: ``default,default`` puts two workers on one card.
    """
    override = os.environ.get("TIP_WORKER_PLATFORMS", "").strip()
    if override:
        entries = [e.strip() for e in override.split(",") if e.strip()]
        return [entries[i % len(entries)] for i in range(num_workers)]
    n_accel = min(max(local_chips, 0), num_workers)
    return ["default"] * n_accel + ["cpu"] * (num_workers - n_accel)


def run_phase_parallel(
    case_study: str,
    phase: str,
    model_ids: List[int],
    num_workers: int,
    phase_kwargs: Optional[Dict] = None,
    worker_platforms: Optional[List[str]] = None,
    run_timeout_s: Optional[float] = None,
    fleet=None,
    group_size: int = 1,
    backend_flags: Optional[Dict[str, bool]] = None,
) -> None:
    """Run ``phase`` for ``model_ids`` across ``num_workers`` processes.

    ``group_size > 1`` makes the work unit a TUPLE of up to G model ids
    instead of a single id (cross-run dispatch fusion: the phase fn gets
    all of a unit's ids in one call, so the grouped chain runner scores
    them per-dispatch). Journaling, fencing and the failure report stay at
    MODEL granularity: journaled members are filtered out BEFORE units are
    formed — a resumed phase replays only a group's unjournaled members —
    and in fleet mode each member carries its own lease/fence token, so a
    lost lease discards exactly that member's commit, never the group's.

    ``run_timeout_s`` bounds one id's attempt on one worker (default env
    ``TIP_RUN_TIMEOUT_S``, 3600): past it the worker is presumed wedged in a
    dead device call, gets terminated, and the id is requeued once onto a
    fresh worker: CPU-pinned for a synthetic phase or a real phase placed
    on the CPU only, on the card for a real phase with a card worker.
    Raises ``RuntimeError`` at the end if any id failed, naming every
    failed id and its error; completed ids keep their artifacts either way.

    ``backend_flags`` (``device.backend_flags()``) are applied in each
    worker of a real phase before its case study is built.

    ``fleet`` (a :class:`~simple_tip_tpu_torch.parallel.fleet.FleetContext`)
    switches the claim path onto file-backed leases so MULTIPLE host-level
    schedulers can share one phase: ids are enqueued only after this host
    wins their lease (late joiners steal expired leases), in-flight leases
    are renewed every tick, completions commit through the journal with a
    fencing token (a host whose lease was stolen cannot double-commit),
    failures are released for cross-host retry up to the fleet attempt
    budget (``TIP_RETRY_FLEET_*``), and ids finished or failed on OTHER
    hosts count toward completion. Fleet mode requires a journal (pin
    ``TIP_ASSETS`` or ``TIP_JOURNAL``) — it is the single commit point.
    """
    if phase not in PHASES:
        raise ValueError(f"unknown phase {phase!r}; one of {sorted(PHASES)}")
    if run_timeout_s is None:
        run_timeout_s = float(os.environ.get("TIP_RUN_TIMEOUT_S", "3600"))
    phase_kwargs = dict(phase_kwargs or {})

    # Journaled resume (resilience/journal.py): ids already journaled as
    # completed for this (case study, phase) are skipped outright — a
    # restarted study pays nothing for finished runs and rides the
    # restart-safe SAFitCache/artifact bus back to warm state. Off unless
    # the bus is pinned (TIP_ASSETS) or TIP_JOURNAL names a path.
    journal = journal_from_env(case_study, phase)
    if fleet is not None and journal is None:
        raise ValueError(
            "fleet execution requires a journal as the commit point: pin "
            "TIP_ASSETS or set TIP_JOURNAL to a shared path"
        )
    already_done = journal.completed() if journal is not None else set()
    skipped = [m for m in model_ids if m in already_done]
    pending = [m for m in model_ids if m not in already_done]
    if skipped:
        logger.info(
            "[%s] %s: skipping %d/%d runs already journaled as complete "
            "(journal: %s; delete it to force re-runs)",
            case_study, phase, len(skipped), len(model_ids), journal.path,
        )
        obs.counter("scheduler.journal_skips").inc(len(skipped))
        for m in skipped:
            obs.event("scheduler.skip_journaled", model_id=m, phase=phase)

    # Group units form AFTER the journal filter: a resumed mid-group run
    # re-chunks only the unjournaled members (exactly-once at model
    # granularity; tests/test_torch_run_scheduler.py holds it).
    group_size = max(1, int(group_size))
    if group_size > 1:
        units = [
            tuple(pending[i : i + group_size])
            for i in range(0, len(pending), group_size)
        ]
    else:
        units = list(pending)

    num_workers = max(1, min(num_workers, max(1, len(units))))
    if worker_platforms is None:
        worker_platforms = ["default"] * num_workers
    placed = [worker_platforms[i % len(worker_platforms)] for i in range(num_workers)]
    # Where a reaped unit, a reaped worker's place and a stalled pool go.
    # The JAX contract is a fresh CPU-pinned worker; a real phase with a
    # worker on the card stays on the card, so that none of its runs is
    # scored on the CPU by a fallback.
    rescue_platform = (
        "default" if phase not in _SYNTHETIC_PHASES and "default" in placed else "cpu"
    )

    # Requeue budget from the unified retry policy (resilience/retry.py):
    # attempts=2 keeps the historical contract (one requeue onto a fresh
    # worker, then fail). Only the scoped TIP_RETRY_SCHED_*
    # knobs tune it (inherit=False): requeues cost a whole run_timeout_s
    # each, so a blanket TIP_RETRY_ATTEMPTS bump for cache/probe IO must
    # not silently multiply hour-long wedge retries. Under a fleet the
    # budget is promoted to host scope (TIP_RETRY_FLEET_*): local requeues
    # AND cross-host lease epochs draw from the same attempt contract.
    max_requeues = (
        RetryPolicy.from_env(
            scope="fleet" if fleet is not None else "sched",
            inherit=False,
            attempts=2,
        ).attempts
        - 1
    )

    # Resolve the obs run directory BEFORE any spawn: an ``auto``
    # TIP_OBS_DIR pins itself into os.environ here, so every worker (which
    # inherits the parent environment) appends into the SAME run directory
    # and the streams merge across the spawn boundary.
    obs.enabled()
    # Live telemetry: serve /healthz + /metrics from THIS process while the
    # phase runs. No-op unless TIP_OBS_HTTP is set. The endpoint handlers
    # read only in-memory state, so every filesystem-backed health input
    # (breaker state file, journal flock) is polled HERE, on the scheduler
    # loop's cadence, and pushed in.
    from simple_tip_tpu_torch.obs import exporter
    from simple_tip_tpu_torch.resilience.breaker import CircuitBreaker

    http_port = exporter.start()
    health_breaker = CircuitBreaker.from_env() if http_port is not None else None
    # The JAX package quotes its cost model's estimate here (predicted_s on
    # the span); the port has no cost model, which is that model's answer
    # on an empty index: no estimate.
    phase_span = obs.span(
        "scheduler.phase", phase=phase, case_study=case_study,
        runs=len(model_ids), workers=num_workers,
        journal_skipped=len(skipped),
        fused_chain=os.environ.get("TIP_FUSED_CHAIN", "").strip().lower()
        in ("1", "on", "true"),
    )
    phase_span.__enter__()
    phase_started = time.perf_counter()

    ctx = mp.get_context("spawn")
    work_q = ctx.Queue()
    # Retries ride a SEPARATE queue read only by the fresh retry workers:
    # putting a retry back on the shared queue would let an idle worker of
    # the first pool (possibly wedged on the same hung call) steal it and
    # wedge again, burning the id's retry budget.
    retry_q = ctx.Queue()
    done_q = ctx.Queue()
    stop_event = ctx.Event()
    if fleet is None:
        for u in units:
            work_q.put(u)
            for m in _unit_members(u):
                obs.event("scheduler.announce", model_id=m, phase=phase)
    # Fleet mode enqueues nothing up front: an id reaches work_q only once
    # THIS host wins its lease (see _fleet_tick below), so two members
    # sharing a phase partition the ids instead of both running all of them.

    workers: List = []
    worker_queue: Dict[int, object] = {}  # pid -> the queue that worker reads
    # A CPU worker's share of the host's cores (unless OMP_NUM_THREADS is
    # set): N workers at torch's default thread count would oversubscribe.
    cpu_threads = max(1, (os.cpu_count() or 1) // num_workers)

    def _spawn(platform: str, queue=work_q):
        # A CPU worker sees no card, so it never opens a CUDA context.
        env = {"CUDA_VISIBLE_DEVICES": ""} if platform == "cpu" else {}
        # Stamp the worker's stream identity: index + platform land in the
        # child's meta event and its stderr log prefix.
        env["TIP_OBS_WORKER"] = str(len(workers))
        env["TIP_OBS_PLATFORM"] = platform
        w = ctx.Process(
            target=_worker_main,
            args=(case_study, phase, queue, done_q, stop_event, phase_kwargs, env,
                  backend_flags, cpu_threads),
            daemon=True,
        )
        w.start()
        workers.append(w)
        worker_queue[w.pid] = queue
        return w

    if pending:
        for platform in placed:
            _spawn(platform)
    logger.info(
        "[%s] %s: %d runs (%d journal-skipped) across %d workers "
        "(platforms: %s, run timeout %.0fs)",
        case_study,
        phase,
        len(pending),
        len(skipped),
        num_workers,
        placed,
        run_timeout_s,
    )

    # Journal-skipped ids are pre-resolved successes; everything below
    # (the progress loop, the final failure report) sees them as done.
    results: Dict[int, Optional[str]] = {m: None for m in skipped}
    in_flight: Dict = {}  # unit (id or id-tuple) -> {"pid", "deadline"}
    requeues: Dict = {}  # unit -> requeue count so far

    # Fleet-mode state. ``claimed`` holds the fence token for every id whose
    # lease THIS host currently owns (renewed each tick, presented at the
    # journal commit). ``done_elsewhere``/``failed_elsewhere`` are ids some
    # OTHER member resolved — they count toward completion here without
    # ever entering ``results``.
    claimed: Dict[int, object] = {}
    done_elsewhere: Set[int] = set()
    failed_elsewhere: Dict[int, str] = {}

    def _outstanding() -> List[int]:
        """Ids nobody (here or elsewhere) has resolved yet."""
        return [
            m
            for m in model_ids
            if m not in results
            and m not in done_elsewhere
            and m not in failed_elsewhere
        ]

    _wedge_polls = [0]  # consecutive wedged-journal probes (debounced)

    def _push_health() -> None:
        """Poll the filesystem-backed health inputs, refresh the live
        scheduler gauges, run one alert-evaluator tick, and push the
        health components into the exporter. Runs on the scheduler loop
        (``_HEALTH_PUSH_S`` cadence) so HTTP handler threads never touch
        the breaker state file or the journal flock themselves."""
        breaker_ok = True
        if health_breaker is not None:
            breaker_ok = health_breaker.healthy()
            obs.gauge("breaker.open").set(0 if breaker_ok else 1)
        outstanding = len(_outstanding())
        obs.gauge("scheduler.in_flight").set(len(in_flight))
        obs.gauge("scheduler.outstanding").set(outstanding)
        if http_port is None:
            return
        if health_breaker is not None:
            exporter.set_health(
                "breaker", ok=breaker_ok, **health_breaker.snapshot()
            )
        if journal is not None:
            _wedge_polls[0] = _wedge_polls[0] + 1 if journal.wedged() else 0
            exporter.set_health(
                "journal",
                ok=_wedge_polls[0] < _JOURNAL_WEDGE_POLLS,
                wedged_polls=_wedge_polls[0],
                path=journal.path,
            )
        exporter.set_health(
            "scheduler", ok=True, phase=phase, case_study=case_study,
            outstanding=outstanding, in_flight=len(in_flight),
            workers_alive=sum(1 for w in workers if w.is_alive()),
        )

    def _fleet_tick() -> None:
        """One fleet housekeeping pass: heartbeat + coordinator duties,
        refresh the elsewhere view, claim unowned ids, renew held leases."""
        if fleet is None:
            return
        fleet.tick(workers)
        done_else, failed_else = fleet.elsewhere()
        for m in done_else:
            if m not in results and m not in claimed:
                done_elsewhere.add(m)
        for m, err in failed_else.items():
            if m not in results and m not in claimed and m not in done_elsewhere:
                failed_elsewhere[m] = err
        new_claims: List[int] = []
        for m in pending:
            if (
                m in results
                or m in claimed
                or m in done_elsewhere
                or m in failed_elsewhere
            ):
                continue
            tok = fleet.try_claim(m)
            if tok is None:
                continue  # leased to (or failed on) another member
            claimed[m] = tok
            new_claims.append(m)
        # Chunk this tick's winnings into group units (ragged tail flushes
        # same tick — every sweep covers all pending ids, so holding a
        # partial group back could strand it). Each member keeps its OWN
        # fence token; only the dispatch unit is grouped.
        for i in range(0, len(new_claims), group_size):
            chunk = new_claims[i : i + group_size]
            work_q.put(tuple(chunk) if group_size > 1 else chunk[0])
            for m in chunk:
                obs.event("scheduler.announce", model_id=m, phase=phase)
        for m, tok in list(claimed.items()):
            if m in results:
                continue
            try:
                fleet.renew(tok)
            except LeaseLost:
                # Stolen mid-run (our lease expired, or a straggler
                # speculation re-leased it). Keep the claim entry: the
                # fenced journal commit — not this loop — decides whether
                # our in-progress attempt still counts.
                obs.counter("lease.lost_renewals").inc()

    def _handle(msg) -> None:
        kind, unit, payload = msg
        if kind == "start":
            # Deadlines ride the monotonic clock: an NTP step mid-run must
            # not fire (or indefinitely defer) a wedge timeout.
            in_flight[unit] = {
                "pid": payload,
                "deadline": time.monotonic() + run_timeout_s,
            }
            for model_id in _unit_members(unit):
                obs.event(
                    "scheduler.start", model_id=model_id, phase=phase,
                    worker_pid=payload,
                )
            return
        in_flight.pop(unit, None)
        # A unit reports once, but members RESOLVE individually: journal
        # marks, fence commits and the failure report all stay at model
        # granularity so grouped dispatch never widens the exactly-once
        # unit.
        for model_id in _unit_members(unit):
            if model_id in results:
                continue  # late duplicate after a requeue race; first wins
            if fleet is not None:
                if payload is None:
                    # Fenced commit: the journal is the single commit
                    # point. A host whose lease was stolen mid-run (expired
                    # while wedged, speculative re-lease of a straggler) is
                    # rejected HERE — its finished work is discarded, the
                    # stealer's commit stands, and every member lands in
                    # the journal exactly once. Only THIS member's commit
                    # is discarded; its group-mates' leases stand on their
                    # own tokens.
                    tok = claimed.pop(model_id, None)
                    try:
                        if tok is None:
                            raise LeaseLost(
                                f"no live lease held for run {model_id}"
                            )
                        journal.mark_done(model_id, fence=tok)
                    except LeaseLost as e:
                        obs.counter("lease.fence_rejects").inc()
                        obs.event(
                            "scheduler.fence_reject", model_id=model_id,
                            phase=phase, error=str(e)[:200],
                        )
                        logger.warning(
                            "[%s] %s: run %d finished but its lease was "
                            "lost (%s); discarding — the stealing host owns "
                            "this unit",
                            case_study, phase, model_id, e,
                        )
                        continue
                    fleet.release(tok)
                    results[model_id] = None
                    logger.info(
                        "[%s] %s: run %d done", case_study, phase, model_id
                    )
                    obs.event("scheduler.done", model_id=model_id, phase=phase)
                else:
                    tok = claimed.pop(model_id, None)
                    final = fleet.report_failure(model_id, tok, str(payload))
                    if final is not None:
                        results[model_id] = final
                        logger.error(
                            "[%s] %s: run %d FAILED fleet-wide: %s",
                            case_study, phase, model_id, final,
                        )
                        obs.event(
                            "scheduler.fail", model_id=model_id, phase=phase,
                            error=str(final)[:300],
                        )
                    else:
                        logger.warning(
                            "[%s] %s: run %d failed here (%s); lease "
                            "released for retry on another member",
                            case_study, phase, model_id, payload,
                        )
                        obs.event(
                            "scheduler.release_retry", model_id=model_id,
                            phase=phase, error=str(payload)[:200],
                        )
                continue
            results[model_id] = payload
            if payload is None:
                logger.info("[%s] %s: run %d done", case_study, phase, model_id)
                obs.event("scheduler.done", model_id=model_id, phase=phase)
                if journal is not None:
                    journal.mark_done(model_id)
            else:
                logger.error(
                    "[%s] %s: run %d FAILED: %s",
                    case_study, phase, model_id, payload,
                )
                obs.event(
                    "scheduler.fail", model_id=model_id, phase=phase,
                    error=str(payload)[:300],
                )

    def _reap_stuck() -> None:
        """Terminate wedged/dead workers holding a unit; requeue it once onto
        a fresh ``rescue_platform`` worker.

        A unit is reaped and requeued WHOLE (its members resolve together on
        a worker), but the give-up path and fleet failure reporting stay
        per member."""
        now = time.monotonic()
        by_pid = {w.pid: w for w in workers}
        for unit, info in list(in_flight.items()):
            members = _unit_members(unit)
            w = by_pid.get(info["pid"])
            worker_dead = w is not None and not w.is_alive()
            if now <= info["deadline"] and not worker_dead:
                continue
            reason = (
                "worker died mid-run"
                if worker_dead
                else f"no result after {run_timeout_s:.0f}s (wedged device call?)"
            )
            obs.counter(
                "scheduler.worker_deaths" if worker_dead else "scheduler.timeouts"
            ).inc()
            if w is not None and w.is_alive():
                logger.error(
                    "[%s] %s: run(s) %s %s — terminating worker pid %s",
                    case_study, phase, members, reason, w.pid,
                )
                w.terminate()
            in_flight.pop(unit, None)
            # A reaped work_q worker leaves the main pool one short; without a
            # replacement, still-unclaimed ids on work_q would strand behind
            # the stall timeout (or be abandoned outright on a 1-worker pool).
            outstanding = len(_outstanding()) - sum(
                len(_unit_members(u)) for u in in_flight
            )
            if w is not None and worker_queue.get(w.pid) is work_q and outstanding > 1:
                _spawn(rescue_platform)  # reads work_q
            if all(m in results for m in members):
                continue  # a first attempt already reported; nothing to redo
            n = requeues.get(unit, 0)
            if n >= max_requeues:
                for model_id in members:
                    if model_id in results:
                        continue
                    if fleet is not None:
                        # Local budget spent: hand the member back to the
                        # fleet. Another host retries it (or it fails
                        # fleet-wide once the shared attempt budget is gone).
                        tok = claimed.pop(model_id, None)
                        final = fleet.report_failure(model_id, tok, reason)
                        if final is not None:
                            results[model_id] = final
                            logger.error(
                                "[%s] %s: run %d FAILED fleet-wide: %s",
                                case_study, phase, model_id, final,
                            )
                        else:
                            logger.warning(
                                "[%s] %s: run %d local requeues spent (%s); "
                                "lease released for retry on another member",
                                case_study, phase, model_id, reason,
                            )
                            obs.event(
                                "scheduler.release_retry", model_id=model_id,
                                phase=phase, error=reason[:200],
                            )
                        continue
                    spent = "once" if n == 1 else f"{n} times"
                    results[model_id] = (
                        f"{reason}; already requeued {spent} — giving up"
                    )
                    logger.error(
                        "[%s] %s: run %d failed after %d requeue(s)",
                        case_study, phase, model_id, n,
                    )
            else:
                requeues[unit] = n + 1
                logger.warning(
                    "[%s] %s: requeueing run(s) %s onto a fresh %s worker "
                    "(%s; attempt %d/%d)",
                    case_study, phase, members, rescue_platform, reason, n + 2,
                    max_requeues + 1,
                )
                obs.counter("scheduler.requeues").inc()
                for model_id in members:
                    obs.event(
                        "scheduler.requeue", model_id=model_id, phase=phase,
                        reason=reason, platform=rescue_platform,
                    )
                retry_q.put(unit)
                _spawn(rescue_platform, queue=retry_q)

    # A worker can also wedge BEFORE claiming anything (a card that hangs at
    # context creation): then in_flight stays empty and no per-id deadline
    # exists. Track overall progress; past the stall threshold with nothing
    # in flight, replace the whole stuck pool once (``rescue_platform``).
    # The threshold includes a startup grace on top of run_timeout_s so a
    # small test timeout does not misread normal interpreter+torch startup
    # (seconds to tens of seconds) as a wedged pool.
    stall_timeout_s = run_timeout_s + _STARTUP_GRACE_S
    last_progress = time.monotonic()
    startup_rescued = False
    mempoll_s = float(os.environ.get("TIP_OBS_MEMPOLL_S", str(_DEFAULT_MEMPOLL_S)))
    last_mempoll = time.monotonic()
    _push_health()  # seed /healthz before the first loop iteration
    last_health = time.monotonic()

    while _outstanding():
        _fleet_tick()
        # Runs whether or not the exporter is live: _push_health gates the
        # HTTP pushes itself, and the alert evaluator rides this cadence.
        if time.monotonic() - last_health >= _HEALTH_PUSH_S:
            last_health = time.monotonic()
            _push_health()
        if (
            mempoll_s > 0
            and obs.enabled()
            and time.monotonic() - last_mempoll >= mempoll_s
        ):
            last_mempoll = time.monotonic()
            obs.poll_device_memory()
        try:
            _handle(done_q.get(timeout=1.0))
            last_progress = time.monotonic()
            continue
        except queue_mod.Empty:
            pass
        _reap_stuck()
        if in_flight:
            last_progress = time.monotonic()  # per-id deadlines own this case
        elif fleet is not None and not claimed:
            # Every unresolved id is leased to another member: waiting on
            # the fleet to finish (or on an expiry we can steal) is
            # progress, not a local stall.
            last_progress = time.monotonic()
        elif time.monotonic() - last_progress > stall_timeout_s:
            alive = [w for w in workers if w.is_alive()]
            if alive and not startup_rescued:
                logger.error(
                    "[%s] %s: no worker claimed any run for %.0fs — presuming "
                    "the pool wedged at startup; replacing it with fresh %s "
                    "workers",
                    case_study, phase, stall_timeout_s, rescue_platform,
                )
                for w in alive:
                    w.terminate()
                startup_rescued = True
                n_rescue = min(num_workers, len(model_ids) - len(results))
                obs.counter("scheduler.startup_rescues").inc()
                obs.event(
                    "scheduler.pool_rescue", phase=phase, platform=rescue_platform,
                    workers=n_rescue,
                )
                for _ in range(n_rescue):
                    _spawn(rescue_platform)
                last_progress = time.monotonic()
            elif alive:
                logger.error(
                    "[%s] %s: the replacement pool also made no progress for "
                    "%.0fs — giving up",
                    case_study, phase, stall_timeout_s,
                )
                break
        if not any(w.is_alive() for w in workers) and not in_flight:
            # Final drain, then give up: nobody is left to produce results.
            while True:
                try:
                    _handle(done_q.get_nowait())
                except queue_mod.Empty:
                    break
            if _outstanding():
                break

    stop_event.set()
    for w in workers:
        w.join(timeout=30)
        if w.is_alive():  # pragma: no cover — wedged worker (hung card)
            logger.error("worker pid %s wedged at shutdown; terminating", w.pid)
            w.terminate()

    if fleet is not None:
        # Clean leaver: requeue any claim we still hold so surviving members
        # pick those ids up immediately instead of waiting out the lease TTL.
        for m, tok in list(claimed.items()):
            if m in results:
                continue
            try:
                fleet.release(tok)
            except Exception:  # noqa: BLE001 — best-effort; expiry is the backstop
                pass
        claimed.clear()

    span_extra = (
        dict(
            done_elsewhere=len(done_elsewhere),
            failed_elsewhere=len(failed_elsewhere),
        )
        if fleet is not None
        else {}
    )
    phase_span.set(
        completed=sum(1 for e in results.values() if e is None),
        failed=sum(1 for e in results.values() if e is not None),
        actual_s=round(time.perf_counter() - phase_started, 3),
        **span_extra,
    ).__exit__(None, None, None)
    # Final high-water sample even for phases shorter than the poll period.
    if obs.enabled():
        obs.record_device_memory()
    obs.flush_metrics()
    _push_health()  # terminal state: outstanding=0 (or the failure counts)

    failed = {m: e for m, e in results.items() if e is not None}
    failed.update(failed_elsewhere)
    missing = [
        m
        for m in model_ids
        if m not in results and m not in done_elsewhere and m not in failed_elsewhere
    ]
    if failed or missing:
        parts = [f"run {m}: {e}" for m, e in sorted(failed.items())]
        parts += [f"run {m}: worker died without reporting" for m in missing]
        raise RuntimeError(
            f"{phase} failed for {len(parts)}/{len(model_ids)} runs "
            f"(completed runs kept their artifacts; re-run the failed ids): "
            + "; ".join(parts)
        )
