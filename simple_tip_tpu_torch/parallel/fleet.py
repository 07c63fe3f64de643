"""Host-level fleet execution over the lease substrate.

Counterpart of the JAX package's ``parallel/fleet.py``: several host-level
schedulers (separate machines sharing a filesystem, or processes standing
in for them) run ONE phase together, and any of them can be preempted
mid-unit without losing work or completing it twice.

- ``FleetContext``: one member's view of the fleet root (``leases/``,
  ``members/``, ``failed/``, ``attempts/``). The scheduler calls ``tick()``
  every loop (heartbeat, coordinator duties, the ``host.die`` fault seam),
  ``try_claim`` / ``renew`` / ``release`` around the lease protocol,
  ``elsewhere()`` for units other members resolved and ``report_failure``
  to spend the fleet-wide attempt budget (``TIP_RETRY_FLEET_*``).
- Coordinator: the member holding the ``__coordinator__`` lease. Its one
  extra duty is straggler speculation: a lease older than
  ``TIP_FLEET_STRAGGLER_S`` is expired early (never revoked; the fencing
  epoch at the journal decides which commit stands). Without that knob
  the timeout is sized from the active plan's per-run estimate, else the
  cost model's (``obs/costmodel.py``); with neither (an empty index) there
  is no speculation.
- ``run_phase_fleet``: spawns N member processes, each the ordinary
  ``run_phase_parallel`` with a ``FleetContext``, and watches the journal;
  if every member dies with work left it launches standbys (up to
  ``TIP_FLEET_MAX_STANDBYS``, default 1) that steal the expired leases.
  Its loop refreshes the ``/fleet`` view and ticks the SLO evaluator
  (``obs/alerts.py``) on the beat cadence.

Exactly once: a member commits a unit only through
``RunJournal.mark_done(fence=token)``. Stdlib only.
"""

import json
import logging
import multiprocessing as mp
import os
import time
from typing import Dict, List, Optional, Set, Tuple

from simple_tip_tpu_torch import obs
from simple_tip_tpu_torch.resilience import (
    COORDINATOR_UNIT,
    LeaseLost,
    LeaseManager,
    Membership,
    RetryPolicy,
    faults,
    fleet_now,
    journal_from_env,
)
from simple_tip_tpu_torch.resilience.lease import _safe

logger = logging.getLogger(__name__)

#: How often (fraction of the membership TTL) a member heartbeats and the
#: coordinator lease is renewed/contested. 3 beats per TTL tolerates two
#: dropped beats before the fleet declares the member gone.
_BEATS_PER_TTL = 3.0


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        logger.warning("%s=%r is not a number; using %s", name, raw, default)
        return default


class FleetContext:
    """One member's handle on a shared fleet root.

    The root directory is the fleet: ``leases/`` (work-unit and
    coordinator leases), ``members/`` (heartbeat files), ``failed/``
    (fleet-wide permanent failures) and ``attempts/`` (the cross-host
    attempt ledger). Everything rides atomic file ops on the shared bus —
    no network protocol, same as the rest of the repo's filesystem bus.
    """

    def __init__(
        self,
        root: str,
        host_id: str,
        case_study: str,
        phase: str,
        lease_ttl_s: float = 30.0,
        member_ttl_s: float = 10.0,
        journal=None,
    ):
        self.root = root
        self.host_id = str(host_id)
        self.case_study = case_study
        self.phase = phase
        self.leases = LeaseManager(
            os.path.join(root, "leases"), owner=self.host_id, ttl_s=lease_ttl_s
        )
        # The coordinator lease rides the (shorter) membership TTL so a
        # dead coordinator is replaced within about one heartbeat interval,
        # not a full work-lease TTL.
        self._coord_mgr = LeaseManager(
            os.path.join(root, "leases"), owner=self.host_id, ttl_s=member_ttl_s
        )
        self.members = Membership(
            os.path.join(root, "members"), self.host_id, ttl_s=member_ttl_s
        )
        self.failed_dir = os.path.join(root, "failed")
        self.attempts_dir = os.path.join(root, "attempts")
        self.beat_interval_s = member_ttl_s / _BEATS_PER_TTL
        self._journal = journal
        self._coord_tok = None
        self._last_fleet_view: Dict = {}
        self._ticks = 0
        self._last_beat = 0.0  # monotonic; 0 forces a beat on the first tick
        self._last_elsewhere = 0.0
        self._elsewhere_cache: Tuple[Set, Dict] = (set(), {})
        self._straggler_cache = ("unset",)
        # Total attempts per unit ACROSS hosts (local requeues are separate
        # and cheaper; this bounds how many hosts re-run a poisoned unit).
        self.attempt_budget = RetryPolicy.from_env(
            scope="fleet", inherit=False, attempts=2
        ).attempts

    # -- journal -----------------------------------------------------------

    def _get_journal(self):
        if self._journal is None:
            self._journal = journal_from_env(self.case_study, self.phase)
        return self._journal

    # -- per-tick housekeeping --------------------------------------------

    def tick(self, workers: Optional[List] = None) -> None:
        """One housekeeping pass; the scheduler calls this every loop.

        Fires the ``host.die`` chaos seam (kind ``kill`` terminates this
        member's worker pool and hard-exits — the whole-host preemption),
        then, on the beat cadence, heartbeats and runs coordinator duties.
        """
        self._ticks += 1
        role = "coordinator" if self._coord_tok is not None else "member"
        fault = faults.maybe_inject(
            "host.die", host=self.host_id, role=role, tick=self._ticks,
            phase=self.phase,
        )
        if fault is not None and fault.kind == "kill":
            # Terminate the worker pool BEFORE exiting: os._exit skips the
            # daemon-cleanup atexit hooks, and orphaned workers would keep
            # draining queues for a host the fleet considers dead.
            for w in workers or []:
                try:
                    if w.is_alive():
                        w.terminate()
                except Exception:  # noqa: BLE001 — dying anyway
                    pass
            obs.event("fleet.host_die", host=self.host_id, role=role)
            obs.flush_metrics()
            logger.error("fleet member %s killed by host.die fault", self.host_id)
            os._exit(1)
        now = time.monotonic()
        if now - self._last_beat < self.beat_interval_s:
            return
        self._last_beat = now
        self.members.beat(role=role, phase=self.phase)
        self._coordinate()
        # Refresh the cached /fleet view on the same cadence: the bus reads
        # happen here (one beat per interval), never on an HTTP thread.
        self.fleet_view()

    def _coordinate(self) -> None:
        """Renew-or-contest the coordinator lease; speculate if we hold it."""
        if self._coord_tok is not None:
            try:
                self._coord_mgr.renew(self._coord_tok)
            except LeaseLost:
                # Fenced out (e.g. our own heartbeat stalled past the TTL
                # and a standby took over). Step down; the new coordinator
                # is authoritative.
                self._coord_tok = None
                obs.event("fleet.demoted", host=self.host_id)
                logger.warning(
                    "fleet member %s lost the coordinator lease", self.host_id
                )
        if self._coord_tok is None:
            tok = self._coord_mgr.claim(COORDINATOR_UNIT)
            if tok is not None:
                self._coord_tok = tok
                if tok.epoch > 1:
                    # epoch 1 is the founding claim; every later epoch means
                    # the previous coordinator died/stalled and we took over.
                    obs.counter("fleet.handoffs").inc()
                    obs.event(
                        "fleet.handoff", host=self.host_id, epoch=tok.epoch
                    )
                    logger.warning(
                        "fleet member %s PROMOTED to coordinator (epoch %d)",
                        self.host_id, tok.epoch,
                    )
                else:
                    obs.event("fleet.coordinator", host=self.host_id)
                    logger.info(
                        "fleet member %s is the coordinator", self.host_id
                    )
        if self._coord_tok is not None:
            self._speculate_stragglers()

    # -- straggler speculation --------------------------------------------

    def _straggler_timeout(self) -> Optional[float]:
        """Age past which a live lease is speculatively re-leased, or None.

        ``TIP_FLEET_STRAGGLER_S`` (0 disables). Without it: the p95 of the
        plan's (else the cost model's) per-run estimate times
        ``TIP_FLEET_STRAGGLER_SLACK`` (default 4), at least 1 s; None
        (nothing speculated) when there is no estimate."""
        if self._straggler_cache != ("unset",):
            return self._straggler_cache[0]
        timeout: Optional[float] = None
        raw = os.environ.get("TIP_FLEET_STRAGGLER_S", "").strip()
        if raw:
            try:
                timeout = float(raw) or None  # 0 disables
            except ValueError:
                logger.warning("TIP_FLEET_STRAGGLER_S=%r is not a number", raw)
        else:
            try:
                # Plan first: speculation sized from the same per-phase
                # prediction the planner committed to (and `obs audit`
                # grades), falling back to the live cost model.
                from simple_tip_tpu_torch import plan as _plan
                from simple_tip_tpu_torch.obs import costmodel

                est = _plan.phase_estimate(self.phase, 1, workers=1)
                if est is None:
                    est = costmodel.quick_phase_estimate(
                        self.phase, 1, workers=1
                    )
            except Exception:  # noqa: BLE001 — advisory, never fatal
                est = None
            if est is not None:
                slack = _env_float("TIP_FLEET_STRAGGLER_SLACK", 4.0)
                p95 = est["predicted_s"] + 2.0 * (est.get("error_s") or 0.0)
                timeout = max(p95 * slack, 1.0)
        self._straggler_cache = (timeout,)
        return timeout

    def _speculate_stragglers(self) -> None:
        timeout = self._straggler_timeout()
        if timeout is None:
            return
        now = fleet_now()
        for rec in self.leases.active():
            unit = rec.get("unit")
            if unit == COORDINATOR_UNIT:
                continue
            age = now - float(rec.get("claimed_ts", now))
            if age <= timeout:
                continue
            # Expire early, never revoke: if the straggler is merely slow
            # it may still commit first — the fencing epoch at the journal
            # decides the race, this is only a hint that lets someone else
            # start a second attempt.
            if self.leases.expire_now(unit):
                obs.counter("fleet.speculations").inc()
                obs.event(
                    "fleet.speculate", unit=unit, holder=rec.get("owner"),
                    age_s=round(age, 3), timeout_s=round(timeout, 3),
                )
                logger.warning(
                    "fleet: unit %s on %s is a straggler (%.1fs > %.1fs); "
                    "lease expired for speculative re-run",
                    unit, rec.get("owner"), age, timeout,
                )

    # -- live fleet view (the exporter's /fleet route) ---------------------

    def fleet_view(self) -> Dict:
        """Aggregate the fleet's live state into one JSON-safe dict.

        Per-host heartbeat age with a ``stale`` verdict (age past the
        membership TTL — the host stopped beating but has not rejoined),
        the coordinator lease (owner + fencing epoch), every in-flight
        work lease with its age and straggler verdict (the same timeout
        the coordinator speculates on), and this member's own identity.

        Reads the filesystem bus, so callers refresh it on the beat
        cadence (``tick()`` does) and the HTTP exporter serves the CACHED
        copy via :meth:`last_fleet_view` — handlers never walk the bus.
        """
        now = fleet_now()
        members = {}
        for host, rec in self.members.table().items():
            age = max(0.0, now - float(rec.get("ts", now)))
            members[host] = {
                "age_s": round(age, 3),
                "stale": age > self.members.ttl_s,
                "role": rec.get("role"),
                "phase": rec.get("phase"),
                "pid": rec.get("pid"),
            }
        timeout = self._straggler_timeout()
        coordinator = None
        leases = []
        for rec in self.leases.active():
            unit = rec.get("unit")
            age = max(0.0, now - float(rec.get("claimed_ts", now)))
            entry = {
                "unit": unit,
                "owner": rec.get("owner"),
                "epoch": rec.get("epoch"),
                "age_s": round(age, 3),
            }
            if unit == COORDINATOR_UNIT:
                coordinator = entry
                continue
            entry["verdict"] = (
                "straggler" if timeout is not None and age > timeout else "ok"
            )
            leases.append(entry)
        view = {
            "host": self.host_id,
            "case_study": self.case_study,
            "phase": self.phase,
            "is_coordinator": self._coord_tok is not None,
            "coordinator": coordinator,
            "members": members,
            "member_ttl_s": self.members.ttl_s,
            "leases": sorted(leases, key=lambda r: str(r["unit"])),
            "in_flight": len(leases),
            "straggler_timeout_s": timeout,
            "ts": now,
        }
        self._last_fleet_view = view
        return view

    def last_fleet_view(self) -> Dict:
        """The newest :meth:`fleet_view` result — a pure in-memory read,
        safe as an exporter route provider."""
        return self._last_fleet_view

    # -- claims ------------------------------------------------------------

    def try_claim(self, model_id):
        """A fence token for ``model_id`` if this host may run it, else None
        (someone else holds it, or it already failed fleet-wide)."""
        _, failed = self.elsewhere()
        if model_id in failed:
            return None
        return self.leases.claim(str(model_id))

    def renew(self, token) -> None:
        self.leases.renew(token)

    def release(self, token) -> None:
        self.leases.release(token)

    # -- cross-host completion view ---------------------------------------

    def elsewhere(self) -> Tuple[Set, Dict]:
        """(done ids, failed id -> error) as resolved by ANY member.

        Done is simply the journal (the commit point); failed is the
        fleet's permanent-failure directory. Cached for half a beat so the
        scheduler can call this every loop without hammering the bus.
        """
        now = time.monotonic()
        if now - self._last_elsewhere < min(0.5, self.beat_interval_s):
            return self._elsewhere_cache
        self._last_elsewhere = now
        journal = self._get_journal()
        done = journal.completed() if journal is not None else set()
        failed: Dict = {}
        try:
            names = os.listdir(self.failed_dir)
        except OSError:
            names = []
        for name in names:
            if not (name.startswith("failed_") and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(self.failed_dir, name), encoding="utf-8") as f:
                    rec = json.load(f)
            except (OSError, ValueError):
                continue
            if isinstance(rec, dict) and "unit" in rec:
                failed[rec["unit"]] = str(rec.get("error", "failed fleet-wide"))
        self._elsewhere_cache = (done, failed)
        return self._elsewhere_cache

    # -- failures ----------------------------------------------------------

    def report_failure(self, model_id, token, error: str) -> Optional[str]:
        """Spend one fleet-wide attempt for ``model_id``.

        Returns the final error string once the shared budget
        (``TIP_RETRY_FLEET_ATTEMPTS``) is exhausted — the unit is recorded
        in ``failed/`` so no member re-claims it — or None after releasing
        the lease for another member to retry.
        """
        unit = _safe(str(model_id))
        os.makedirs(self.attempts_dir, exist_ok=True)
        path = os.path.join(self.attempts_dir, f"attempts_{unit}.json")
        # The per-unit lease lock also serializes the attempt ledger: two
        # members reporting the same unit must not both read n and write n+1.
        with self.leases._locked(str(model_id)):
            rec = {"attempts": 0, "errors": []}
            try:
                with open(path, encoding="utf-8") as f:
                    loaded = json.load(f)
                if isinstance(loaded, dict):
                    rec = loaded
            except (OSError, ValueError):
                pass
            rec["attempts"] = int(rec.get("attempts", 0)) + 1
            rec["errors"] = (list(rec.get("errors", [])) + [
                {"host": self.host_id, "error": str(error)[:300], "ts": fleet_now()}
            ])[-5:]
            tmp = f"{path}.{os.getpid()}.tmp"
            try:
                with open(tmp, "w", encoding="utf-8") as f:
                    json.dump(rec, f)
                os.replace(tmp, path)
            except OSError as e:
                logger.warning("fleet attempt ledger write failed: %s", e)
            attempts = rec["attempts"]
        if token is not None:
            self.release(token)
        if attempts < self.attempt_budget:
            obs.counter("fleet.retries_released").inc()
            return None
        final = (
            f"{error} (fleet attempts {attempts}/{self.attempt_budget} "
            f"exhausted across hosts)"
        )
        os.makedirs(self.failed_dir, exist_ok=True)
        fpath = os.path.join(self.failed_dir, f"failed_{unit}.json")
        try:
            tmp = f"{fpath}.{os.getpid()}.tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(
                    {"unit": model_id, "error": final, "attempts": attempts}, f
                )
            os.replace(tmp, fpath)
        except OSError as e:
            logger.warning("fleet failure record write failed: %s", e)
        obs.counter("fleet.failures").inc()
        obs.event(
            "fleet.fail", unit=model_id, host=self.host_id,
            attempts=attempts, error=str(error)[:200],
        )
        return final

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Clean departure: give up the coordinator role and stop beating."""
        if self._coord_tok is not None:
            try:
                self._coord_mgr.release(self._coord_tok)
            except Exception:  # noqa: BLE001 — expiry is the backstop
                pass
            self._coord_tok = None
        self.members.leave()


def _fleet_member_main(
    host_id,
    root,
    case_study,
    phase,
    model_ids,
    num_workers,
    phase_kwargs,
    run_timeout_s,
    lease_ttl_s,
    member_ttl_s,
    env_overrides,
):
    """Entry point of one spawned fleet member process.

    A member is just ``run_phase_parallel`` with a :class:`FleetContext`:
    the same scheduler, worker pool and requeue machinery, plus the lease
    claim path. Exit code 0 when every unit this member saw is resolved
    (here or elsewhere), 1 on failure — the parent decides whether a
    standby is warranted.
    """
    os.environ.update(env_overrides)
    obs.install_worker_logging()
    from simple_tip_tpu_torch.parallel.run_scheduler import run_phase_parallel

    ctx = FleetContext(
        root, host_id, case_study, phase,
        lease_ttl_s=lease_ttl_s, member_ttl_s=member_ttl_s,
    )
    rc = 0
    with obs.span(
        "fleet.member", host=host_id, phase=phase, case_study=case_study
    ):
        try:
            run_phase_parallel(
                case_study, phase, list(model_ids), num_workers,
                phase_kwargs=phase_kwargs, run_timeout_s=run_timeout_s,
                fleet=ctx,
            )
        except Exception as e:  # noqa: BLE001 — reported via exit code
            logger.error("fleet member %s failed: %s", host_id, e)
            rc = 1
        finally:
            ctx.close()
    obs.flush_metrics()
    if rc:
        raise SystemExit(rc)


def run_phase_fleet(
    case_study: str,
    phase: str,
    model_ids: List[int],
    root: str,
    n_hosts: int = 2,
    workers_per_host: int = 1,
    phase_kwargs: Optional[Dict] = None,
    run_timeout_s: Optional[float] = None,
    lease_ttl_s: float = 5.0,
    member_ttl_s: float = 5.0,
    member_env: Optional[List[Dict[str, str]]] = None,
    max_standbys: Optional[int] = None,
    deadline_s: float = 600.0,
) -> None:
    """Run ``phase`` across ``n_hosts`` member processes sharing ``root``.

    Each member is a full host-level scheduler (``run_phase_parallel`` with
    ``workers_per_host`` workers); the lease directory under ``root``
    partitions the ids between them. Membership is elastic: members that
    die (preemption, the ``host.die`` chaos seam) simply stop renewing and
    the survivors steal their expired leases; if EVERY member dies with
    work outstanding, standby members are launched late (up to
    ``max_standbys``, default ``TIP_FLEET_MAX_STANDBYS`` = 1) and catch up
    from the journal. ``member_env`` optionally gives per-member env
    overrides (e.g. ``TIP_FLEET_CLOCK_SKEW_S`` for one member in the chaos
    suite). Raises ``RuntimeError`` if any unit is unresolved or failed
    fleet-wide once the fleet drains (or ``deadline_s`` passes).
    """
    journal = journal_from_env(case_study, phase)
    if journal is None:
        raise ValueError(
            "fleet execution requires a journal as the commit point: pin "
            "TIP_ASSETS or set TIP_JOURNAL to a shared path"
        )
    if max_standbys is None:
        max_standbys = int(_env_float("TIP_FLEET_MAX_STANDBYS", 1.0))
    os.makedirs(root, exist_ok=True)
    obs.enabled()  # pin an auto obs dir before any member spawns
    probe = FleetContext(
        root, "fleet-parent", case_study, phase,
        lease_ttl_s=lease_ttl_s, member_ttl_s=member_ttl_s, journal=journal,
    )
    # Live telemetry: the fleet parent serves the coordinator-aggregated
    # /fleet view (and /healthz, /metrics) while the fleet runs. No-op unless
    # TIP_OBS_HTTP is set; members do not mount: one port, one view.
    from simple_tip_tpu_torch.obs import alerts as alerts_mod
    from simple_tip_tpu_torch.obs import exporter

    http_port = exporter.start()
    if http_port is not None:
        exporter.set_provider("fleet", probe.last_fleet_view)
        probe.fleet_view()  # seed the cache so the route is never empty

    ctx = mp.get_context("spawn")
    members: List = []

    def _spawn_member(host_id: str, env: Dict[str, str]):
        # NOT daemonic: members spawn their own (daemonic) worker pools,
        # and a daemonic process may not have children.
        p = ctx.Process(
            target=_fleet_member_main,
            args=(
                host_id, root, case_study, phase, list(model_ids),
                workers_per_host, dict(phase_kwargs or {}), run_timeout_s,
                lease_ttl_s, member_ttl_s,
                {"TIP_FLEET_HOST": host_id, **env},
            ),
            name=f"fleet-{host_id}",
        )
        p.start()
        members.append(p)
        logger.info("fleet: launched member %s (pid %s)", host_id, p.pid)
        return p

    member_env = list(member_env or [])
    for i in range(n_hosts):
        env = member_env[i] if i < len(member_env) else {}
        _spawn_member(f"host{i}", env)

    def _unresolved() -> List[int]:
        done, failed = probe.elsewhere()
        return [m for m in model_ids if m not in done and m not in failed]

    standbys = 0
    deadline = time.monotonic() + deadline_s
    next_view = 0.0
    try:
        while _unresolved():
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"fleet did not drain within {deadline_s:.0f}s; "
                    f"unresolved: {_unresolved()}"
                )
            if (
                http_port is not None or alerts_mod.enabled()
            ) and time.monotonic() >= next_view:
                # Refresh the cached /fleet view on the beat cadence from
                # THIS loop: handler threads only ever read the cache. The
                # SLO evaluator rides the same beat (its fleet-members-alive
                # rule samples the gauge set here), with or without a live
                # exporter.
                next_view = time.monotonic() + probe.beat_interval_s
                view = probe.fleet_view()
                fleet_members = view.get("members", {})
                alive = [
                    h for h, m in fleet_members.items() if not m.get("stale")
                ]
                obs.gauge("fleet.members_alive").set(len(alive))
                alerts_mod.tick()
                if http_port is not None:
                    exporter.set_health(
                        "fleet", ok=bool(alive), members_alive=len(alive),
                        members_total=len(fleet_members),
                        unresolved=len(_unresolved()),
                    )
            if not any(p.is_alive() for p in members):
                if standbys >= max_standbys:
                    break  # nobody left and no standby budget: report below
                standbys += 1
                obs.counter("fleet.elastic_joins").inc()
                obs.event("fleet.standby", host=f"standby{standbys}")
                logger.warning(
                    "fleet: all members dead with work outstanding; "
                    "launching standby%d", standbys,
                )
                _spawn_member(f"standby{standbys}", {})
            time.sleep(0.2)
    finally:
        if http_port is not None:
            # Unhook: the probe goes out of scope with this call frame, and
            # a dangling provider would serve a view of a finished fleet.
            exporter.clear_provider("fleet")
            exporter.clear_health("fleet")
        for p in members:
            p.join(timeout=30)
            if p.is_alive():
                logger.error("fleet member pid %s wedged; terminating", p.pid)
                p.terminate()
                p.join(timeout=10)

    done, failed = probe.elsewhere()
    missing = [m for m in model_ids if m not in done and m not in failed]
    if failed or missing:
        parts = [f"run {m}: {failed[m]}" for m in sorted(failed) if m in failed]
        parts += [f"run {m}: unresolved (no member completed it)" for m in missing]
        raise RuntimeError(
            f"{phase} fleet failed for {len(parts)}/{len(model_ids)} runs: "
            + "; ".join(parts)
        )
    logger.info(
        "fleet: %s complete — %d units journaled across %d member(s) "
        "(+%d standby)", phase, len(done & set(model_ids)),
        n_hosts, standbys,
    )
