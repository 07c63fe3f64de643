"""Alert evaluation engine: state machine, persistence, sinks, incidents.

The procedural half of obs v5 (the declarative half — rule documents and
burn-rate math — is ``obs/slo.py``). An :class:`Evaluator` consumes the
live metrics registry in-process plus the feature-store index
cross-process, and drives one state machine per rule::

    inactive -> pending -> firing -> resolved

- **pending**   the slow-burn warn condition holds, or the fast-burn page
  condition holds but hasn't yet held for the rule's ``for_s``;
- **firing**    the fast-burn condition held for ``for_s`` — the page;
- **resolved**  a firing rule whose burn dropped below both thresholds;
  behaves like inactive for re-trips (a fresh breach starts a fresh
  pending), but keeps the resolve timestamp for the operator.

Crash-safety and the fleet: state is one JSON file (``TIP_ALERT_STATE``
dir, default ``$TIP_ASSETS/obs/alerts/``) written atomically (pid-unique
tmp + fsync + ``os.replace``, the bus pattern) and carrying a monotonic
**fence**: every save re-reads the on-disk fence and loses (adopting the
disk state instead of writing) when another evaluator advanced it — a
stale fleet member can never roll back a newer evaluator's transitions,
and transitions are emitted only AFTER the save wins, so a resolve is
emitted exactly once per state-file history. A restarted evaluator
resumes mid-firing with the original ``started_ts`` intact (sample
windows persist too, so recovery still needs real healthy ticks). The
save path carries the ``alerts.save`` fault seam, so chaos plans can
kill the evaluator mid-persist.

Transitions go to pluggable sinks (``TIP_ALERT_SINKS``, default
``stderr,jsonl``): a one-line stderr pager, the append-only
``alerts.jsonl`` next to the state file, and a webhook-shaped file sink
(``webhook:/path`` — each transition as a POST-shaped JSON doc, the
test/integration stand-in for a real receiver). Every transition is also
a schema-stamped obs event (``alert.firing`` etc.) in the span stream.

Incidents: a rule entering firing opens an incident record stamped with
the active ExecutionPlan fingerprint and a correlation of the alert
window against the run's obs streams — overlapping span names,
request_ids, breaker/chaos/fault events. Resolving closes it with
duration and budget-burn, appending the record to ``incidents.jsonl``.

Surfaces: the exporter's ``/alerts`` route serves :meth:`Evaluator.view`
(an in-memory cached dict — the blocking-endpoint contract); ``obs
alerts`` / ``obs incidents`` read the state file cross-process. Owner
loops (scheduler health cadence, fleet beat, ScoringEngine) mount the
evaluator via the module-level :func:`tick` — rate-limited
(``TIP_ALERT_EVAL_S``), failure-safe, and a cheap no-op when no rule
document is configured.

Stdlib-only (imports without torch), crash-safe like the rest of obs.
"""

import hashlib
import json
import logging
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

from simple_tip_tpu_torch.obs import metrics, slo

logger = logging.getLogger(__name__)

#: Stamp on the state file, every transition record and every incident
#: row (the obs JSONL schema contract).
SCHEMA = 1

STATE_ENV = "TIP_ALERT_STATE"
SINKS_ENV = "TIP_ALERT_SINKS"
EVAL_S_ENV = "TIP_ALERT_EVAL_S"

STATES = ("inactive", "pending", "firing", "resolved")

#: Feature-store rows are re-read at most this often (they change on
#: `obs runs` cadence, not per tick).
_INDEX_REFRESH_S = 30.0
#: Quiet-state persistence cadence: transitions always persist
#: immediately; sample windows at most this often.
_PERSIST_S = 5.0
#: Obs-event name prefixes the incident correlator collects as "what else
#: happened in the alert window".
_CORRELATE_EVENTS = ("breaker.", "fault.", "chaos.", "scheduler.fail",
                     "serving.backend_error", "fleet.")


def default_state_dir() -> str:
    """The alert-state directory: ``TIP_ALERT_STATE`` or
    ``$TIP_ASSETS/obs/alerts``."""
    raw = os.environ.get(STATE_ENV, "").strip()
    if raw:
        return os.path.abspath(raw)
    assets = os.environ.get("TIP_ASSETS", os.path.join(os.getcwd(), "assets"))
    return os.path.join(os.path.abspath(assets), "obs", "alerts")


def _state_path(state_dir: str) -> str:
    return os.path.join(state_dir, "alert_state.json")


def alerts_log_path(state_dir: Optional[str] = None) -> str:
    """The append-only transition log next to the state file."""
    return os.path.join(state_dir or default_state_dir(), "alerts.jsonl")


def incidents_path(state_dir: Optional[str] = None) -> str:
    """The append-only closed-incident log next to the state file."""
    return os.path.join(state_dir or default_state_dir(), "incidents.jsonl")


class AlertStore:
    """Fenced, atomic persistence for the evaluator's state document.

    ``load`` returns the on-disk document (empty skeleton when absent/
    corrupt — a torn state file must not kill the evaluator). ``save``
    implements the fencing-token protocol described in the module
    docstring: it re-reads the on-disk fence and REFUSES to write when a
    higher fence landed since this evaluator's last load, returning the
    winner's document so the caller adopts it instead of clobbering.
    """

    def __init__(self, state_dir: Optional[str] = None):
        self.state_dir = state_dir or default_state_dir()
        self.path = _state_path(self.state_dir)

    def _read(self) -> dict:
        try:
            with open(self.path, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return {}
        return doc if isinstance(doc, dict) and doc.get("schema") == SCHEMA else {}

    def load(self) -> dict:
        """The persisted state document (skeleton when absent/corrupt)."""
        doc = self._read()
        doc.setdefault("schema", SCHEMA)
        doc.setdefault("fence", 0)
        doc.setdefault("rules", {})
        doc.setdefault("incidents_open", {})
        return doc

    def save(self, doc: dict, expected_fence: int) -> Tuple[bool, dict]:
        """Persist ``doc`` if nobody outran ``expected_fence``.

        Returns ``(True, doc)`` on a winning write (``doc["fence"]`` is
        advanced), ``(False, winner)`` when a newer evaluator already
        wrote — the caller must adopt ``winner`` and drop its pending
        transitions. The ``alerts.save`` fault seam fires before the
        atomic rename, so a chaos plan can kill the evaluator between
        deciding a transition and persisting it.
        """
        on_disk = self._read()
        disk_fence = int(on_disk.get("fence", 0) or 0)
        if disk_fence > expected_fence:
            return False, self.load()
        doc = dict(doc)
        doc["schema"] = SCHEMA
        doc["fence"] = disk_fence + 1
        doc["pid"] = os.getpid()
        doc["updated_ts"] = time.time()
        from simple_tip_tpu_torch.resilience import faults

        faults.maybe_inject("alerts.save", fence=doc["fence"])
        os.makedirs(self.state_dir, exist_ok=True)
        tmp = f"{self.path}.{os.getpid()}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, sort_keys=True, default=repr)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        return True, doc


# -- sinks -----------------------------------------------------------------


def _parse_sinks(state_dir: str) -> List[Tuple[str, Optional[str]]]:
    """``TIP_ALERT_SINKS`` as (kind, path) pairs; default stderr+jsonl."""
    raw = os.environ.get(SINKS_ENV, "").strip() or "stderr,jsonl"
    if raw.lower() in ("0", "off", "none"):
        return []
    out: List[Tuple[str, Optional[str]]] = []
    for tok in raw.split(","):
        tok = tok.strip()
        if tok == "stderr":
            out.append(("stderr", None))
        elif tok == "jsonl":
            out.append(("jsonl", alerts_log_path(state_dir)))
        elif tok.startswith("webhook:"):
            out.append(("webhook", tok.split(":", 1)[1]))
        elif tok:
            logger.warning("%s: unknown sink %r ignored", SINKS_ENV, tok)
    return out


def _emit_transition(sinks, rec: dict) -> None:
    """Fan one transition out to every sink + the obs event stream.

    Failure-safe per sink: a full disk or unwritable webhook path must
    not take down the process being watched.
    """
    from simple_tip_tpu_torch import obs

    try:
        obs.event(
            f"alert.{rec['to']}", schema=SCHEMA, rule=rec["rule"],
            severity=rec["severity"],
            **({"incident": rec["incident"]} if rec.get("incident") else {}),
        )
    except Exception:  # noqa: BLE001 — telemetry never takes the host down
        pass
    line = json.dumps(rec, sort_keys=True, default=repr)
    for kind, path in sinks:
        try:
            if kind == "stderr":
                burn = rec.get("burn_fast")
                sys.stderr.write(
                    f"ALERT {rec['to'].upper()} [{rec['severity']}] "
                    f"{rec['rule']}: value={rec.get('value')} "
                    f"burn={'-' if burn is None else round(burn, 2)}x"
                    f"{' incident=' + rec['incident'] if rec.get('incident') else ''}\n"
                )
                sys.stderr.flush()
            elif kind == "jsonl":
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "a", encoding="utf-8") as f:
                    f.write(line + "\n")
            elif kind == "webhook":
                # POST-shaped doc: what a real webhook receiver would get.
                body = json.dumps(
                    {"schema": SCHEMA, "method": "POST", "path": "/alert",
                     "headers": {"content-type": "application/json"},
                     "body": rec},
                    sort_keys=True, default=repr,
                )
                with open(path, "a", encoding="utf-8") as f:
                    f.write(body + "\n")
        except OSError as e:
            logger.warning("alert sink %s failed: %s", kind, e)


# -- incident correlation --------------------------------------------------


def _correlate(start: float, end: float) -> dict:
    """What else happened in ``[start, end]``: spans, request_ids, events.

    Reads the run's obs streams (``TIP_OBS_DIR``) — a filesystem walk,
    so this runs only on incident open/close from the evaluator's owner
    loop, never in an HTTP handler. Empty (never raises) when the stream
    is disabled or unreadable.
    """
    empty = {"spans": {}, "events": {}, "request_ids": []}
    try:
        from simple_tip_tpu_torch import obs

        run_dir = obs.obs_dir()
        if not run_dir:
            return empty
        from simple_tip_tpu_torch.obs.cli import load_events

        events, _files, _bad = load_events(run_dir)
    except Exception:  # noqa: BLE001 — correlation is best-effort color
        return empty
    spans: Dict[str, int] = {}
    names: Dict[str, int] = {}
    rids: List[str] = []
    for rec in events:
        ts = rec.get("ts")
        if not isinstance(ts, (int, float)):
            continue
        kind = rec.get("type")
        attrs = rec.get("attrs") or {}
        if kind == "span":
            t1 = ts + float(rec.get("dur", 0) or 0)
            if t1 < start or ts > end:
                continue
            name = str(rec.get("name", "?"))
            spans[name] = spans.get(name, 0) + 1
        elif kind == "event":
            if ts < start or ts > end:
                continue
            name = str(rec.get("name", ""))
            if name.startswith(_CORRELATE_EVENTS):
                names[name] = names.get(name, 0) + 1
        else:
            continue
        raw = attrs.get("request_ids") or attrs.get("request_id")
        if isinstance(raw, str):
            rids.extend(r for r in raw.split(",") if r)
        elif isinstance(raw, (list, tuple)):
            rids.extend(str(r) for r in raw)
    top_spans = dict(
        sorted(spans.items(), key=lambda kv: (-kv[1], kv[0]))[:12]
    )
    seen = set()
    uniq = []
    for r in rids:
        if r not in seen:
            seen.add(r)
            uniq.append(r)
    return {"spans": top_spans, "events": names, "request_ids": uniq[:32]}


def _plan_fingerprint() -> str:
    """The active ExecutionPlan id ("unplanned" when none / on error)."""
    try:
        from simple_tip_tpu_torch.plan.plan import active_plan_id

        return active_plan_id()
    except Exception:  # noqa: BLE001 — the stamp is color, never a blocker
        return "unplanned"


# -- the evaluator ---------------------------------------------------------


class Evaluator:
    """Per-rule alert state machines over live + cross-process signals.

    Deterministic under an explicit clock: every public entry takes
    ``now`` (wall seconds) so tests and the smoke replay trajectories
    without sleeping. Production mounts call :meth:`tick`, which
    rate-limits, snapshots the registry and delegates to
    :meth:`evaluate`.
    """

    def __init__(
        self,
        rules_doc: Optional[dict] = None,
        state_dir: Optional[str] = None,
        min_interval_s: Optional[float] = None,
    ):
        self.rules_doc = rules_doc if rules_doc is not None else slo.load_rules()
        self.rules = (self.rules_doc or {}).get("rules", [])
        self.store = AlertStore(state_dir)
        self.sinks = _parse_sinks(self.store.state_dir)
        if min_interval_s is None:
            try:
                min_interval_s = float(os.environ.get(EVAL_S_ENV, "") or 1.0)
            except ValueError:
                min_interval_s = 1.0
        self.min_interval_s = max(0.0, min_interval_s)
        self._doc = self.store.load()  # restart-resume: adopt persisted state
        self._last_eval = 0.0
        self._last_persist = 0.0
        self._index_rows: List[dict] = []
        self._index_read = 0.0
        self._view: dict = self._build_view(time.time())
        self._needs_index = any(
            r["objective"]["kind"] == "index" for r in self.rules
        )
        # /alerts serves this instance's cached view: a plain in-memory
        # read, per the blocking-endpoint contract.
        from simple_tip_tpu_torch.obs import exporter

        exporter.set_provider("alerts", self.view)

    @property
    def enabled(self) -> bool:
        """Whether any rule survived document resolution."""
        return bool(self.rules)

    # -- public entry points ----------------------------------------------

    def tick(self, now: Optional[float] = None) -> List[dict]:
        """One rate-limited production tick over the live registry."""
        if not self.enabled:
            return []
        now = time.time() if now is None else float(now)
        if now - self._last_eval < self.min_interval_s:
            return []
        return self.evaluate(metrics.snapshot(), now=now)

    def evaluate(self, snap: dict, now: Optional[float] = None) -> List[dict]:
        """Evaluate every rule against ``snap``; the emitted transitions.

        Samples each rule, advances its burn windows and state machine,
        opens/closes incidents, persists (fenced), and only then emits
        transitions — losing the fence race drops this tick's transitions
        and adopts the winner's state, so the transition history in
        ``alerts.jsonl`` matches the state-file history exactly once.
        """
        now = time.time() if now is None else float(now)
        self._last_eval = now
        index_rows = self._load_index(now)
        prev_counters = self._doc.get("prev_counters")
        transitions: List[dict] = []
        for rule in self.rules:
            rs = self._doc["rules"].setdefault(
                rule["name"], {"state": "inactive", "samples": []}
            )
            rs["severity"] = rule["severity"]  # the CLI renders from disk
            sample = slo.sample_rule(rule, snap, prev_counters, index_rows)
            if sample is not None:
                rs["samples"] = list(rs.get("samples") or [])
                rs["samples"].append([round(now, 3), round(sample["bad"], 4)])
                rs["last_value"] = sample["value"]
            keep_s = rule["windows"]["slow"]["window_s"] + 60.0
            rs["samples"] = slo.prune_samples(
                rs.get("samples") or [], now, keep_s
            )
            transitions.extend(self._advance(rule, rs, now))
        self._doc["prev_counters"] = dict(snap.get("counters") or {})
        persisted = self._persist(now, force=bool(transitions))
        if not persisted:
            # Fence lost: a newer evaluator owns the state now. Its
            # transitions are already emitted by it; ours never happened.
            return []
        if transitions:
            for rec in transitions:
                _emit_transition(self.sinks, rec)
        self._view = self._build_view(now)
        return transitions

    def view(self) -> dict:
        """The cached in-memory /alerts document (handler-thread safe)."""
        return self._view

    # -- state machine -----------------------------------------------------

    def _advance(self, rule: dict, rs: dict, now: float) -> List[dict]:
        """Advance one rule's state machine; its transition records."""
        budget = rule["budget"]
        w = rule["windows"]
        burn_f = slo.burn_rate(rs["samples"], now, w["fast"]["window_s"], budget)
        burn_s = slo.burn_rate(rs["samples"], now, w["slow"]["window_s"], budget)
        rs["burn_fast"] = None if burn_f is None else round(burn_f, 4)
        rs["burn_slow"] = None if burn_s is None else round(burn_s, 4)
        fast_hot = burn_f is not None and burn_f >= w["fast"]["burn"]
        slow_hot = burn_s is not None and burn_s >= w["slow"]["burn"]
        state = rs.get("state", "inactive")
        out: List[dict] = []

        def to(new_state: str) -> None:
            rec = {
                "schema": SCHEMA,
                "ts": round(now, 3),
                "rule": rule["name"],
                "severity": rule["severity"],
                "from": state,
                "to": new_state,
                "value": rs.get("last_value"),
                "burn_fast": rs["burn_fast"],
                "burn_slow": rs["burn_slow"],
                "budget": budget,
            }
            rs["state"] = new_state
            rs["since_ts"] = round(now, 3)
            if new_state == "firing":
                rs["started_ts"] = round(now, 3)
                rec["incident"] = self._open_incident(rule, rs, now)
            elif new_state == "resolved":
                rec["started_ts"] = rs.get("started_ts")
                rec["incident"] = self._close_incident(rule, rs, now)
            out.append(rec)

        if fast_hot:
            if state != "firing":
                if rs.get("pending_since") is None:
                    rs["pending_since"] = round(now, 3)
                held = now - rs["pending_since"]
                if held >= rule["for_s"] and state != "firing":
                    if state not in ("pending",) and rule["for_s"] > 0:
                        # A cold rule crossing the page threshold always
                        # passes through pending first (the hold window),
                        # so operators see the escalation, not a jump.
                        to("pending")
                        state = "pending"
                    to("firing")
                elif state not in ("pending",):
                    to("pending")
        elif slow_hot:
            if state == "firing":
                pass  # still burning the budget: the page stays up
            elif state != "pending":
                rs["pending_since"] = round(now, 3)
                to("pending")
        else:
            rs["pending_since"] = None
            if state == "firing":
                to("resolved")
            elif state == "pending":
                to("inactive")
        return out

    # -- incidents ---------------------------------------------------------

    def _open_incident(self, rule: dict, rs: dict, now: float) -> str:
        """Open the incident record for a rule entering firing; its id."""
        ident = hashlib.sha256(
            f"{rule['name']}:{now:.3f}".encode()
        ).hexdigest()[:8]
        inc_id = f"inc-{ident}"
        lookback = rule["windows"]["fast"]["window_s"]
        start = (rs.get("pending_since") or now) - lookback
        inc = {
            "schema": SCHEMA,
            "id": inc_id,
            "rule": rule["name"],
            "severity": rule["severity"],
            "opened_ts": round(now, 3),
            "window_start_ts": round(start, 3),
            "plan": _plan_fingerprint(),
            "value": rs.get("last_value"),
            "burn_fast": rs.get("burn_fast"),
            "budget": rule["budget"],
            "correlated": _correlate(start, now),
        }
        self._doc["incidents_open"][rule["name"]] = inc
        rs["incident"] = inc_id
        return inc_id

    def _close_incident(
        self, rule: dict, rs: dict, now: float
    ) -> Optional[str]:
        """Close a firing rule's incident: duration, budget-burn, append."""
        inc = self._doc["incidents_open"].pop(rule["name"], None)
        if inc is None:
            return None
        opened = float(inc.get("opened_ts") or now)
        duration = max(0.0, now - opened)
        window = [s[1] for s in rs.get("samples") or []
                  if opened <= s[0] <= now]
        mean_bad = (sum(window) / len(window)) if window else 0.0
        inc = dict(inc)
        inc["closed_ts"] = round(now, 3)
        inc["duration_s"] = round(duration, 3)
        # Budget accounting the operator can act on: bad_s is raw error
        # time inside the incident; budget_burn_x is how many times
        # faster than the budget it burned while open.
        inc["bad_s"] = round(mean_bad * duration, 3)
        inc["budget_burn_x"] = round(mean_bad / rule["budget"], 3)
        inc["correlated"] = _correlate(
            float(inc.get("window_start_ts") or opened), now
        )
        try:
            path = incidents_path(self.store.state_dir)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "a", encoding="utf-8") as f:
                f.write(json.dumps(inc, sort_keys=True, default=repr) + "\n")
        except OSError as e:
            logger.warning("incident log write failed: %s", e)
        rs["incident"] = None
        rs["last_incident"] = inc["id"]
        return inc["id"]

    # -- plumbing ----------------------------------------------------------

    def _load_index(self, now: float) -> List[dict]:
        """Feature-store rows for index rules, refreshed on a slow cadence."""
        if not self._needs_index:
            return []
        if now - self._index_read >= _INDEX_REFRESH_S or not self._index_read:
            self._index_read = now
            try:
                from simple_tip_tpu_torch.obs import store

                self._index_rows = store.load_corpus()
            except Exception:  # noqa: BLE001 — a torn index is not an outage
                self._index_rows = []
        return self._index_rows

    def _persist(self, now: float, force: bool) -> bool:
        """Fenced save (transitions force it; quiet ticks batch). True
        when this evaluator still owns the state afterwards."""
        if not force and now - self._last_persist < _PERSIST_S:
            return True
        self._last_persist = now
        ok, doc = self.store.save(
            self._doc, int(self._doc.get("fence", 0) or 0)
        )
        self._doc = doc
        if not ok:
            logger.warning(
                "alert state fence lost (pid %d): adopting the newer "
                "evaluator's state", os.getpid(),
            )
            self._view = self._build_view(now)
        return ok

    def _build_view(self, now: float) -> dict:
        """The /alerts document (rebuilt per evaluation, served cached)."""
        rules = []
        for rule in self.rules:
            rs = self._doc.get("rules", {}).get(rule["name"], {})
            rules.append(
                {
                    "rule": rule["name"],
                    "severity": rule["severity"],
                    "state": rs.get("state", "inactive"),
                    "since_ts": rs.get("since_ts"),
                    "started_ts": rs.get("started_ts"),
                    "value": rs.get("last_value"),
                    "burn_fast": rs.get("burn_fast"),
                    "burn_slow": rs.get("burn_slow"),
                    "budget": rule["budget"],
                    "incident": rs.get("incident"),
                }
            )
        return {
            "schema": SCHEMA,
            "generated_ts": round(now, 3),
            "source": (self.rules_doc or {}).get("source"),
            "state_dir": self.store.state_dir,
            "firing": sum(1 for r in rules if r["state"] == "firing"),
            "pending": sum(1 for r in rules if r["state"] == "pending"),
            "rules": rules,
            "incidents_open": sorted(
                self._doc.get("incidents_open", {}).values(),
                key=lambda i: i.get("opened_ts") or 0,
            ),
        }


# -- module-level singleton (the owner-loop mount point) -------------------

_singleton: Optional[Evaluator] = None


def enabled() -> bool:
    """Whether an alert rule document is configured for this process."""
    return slo.rules_configured()


def get(create: bool = True) -> Optional[Evaluator]:
    """The process's evaluator (lazily created when rules are configured)."""
    global _singleton
    if _singleton is not None:
        return _singleton
    if not create or not slo.rules_configured():
        return None
    _singleton = Evaluator()
    return _singleton


def tick(now: Optional[float] = None) -> None:
    """The production mount: evaluate if configured, swallow everything.

    Owner loops (scheduler health cadence, fleet beat, ScoringEngine)
    call this unconditionally; it is a single env read when alerting is
    off, rate-limited when on, and failure-safe always — the watcher
    must never take down the watched.
    """
    try:
        ev = get()
        if ev is not None:
            ev.tick(now=now)
    except Exception:  # noqa: BLE001 — telemetry never takes the host down
        logger.debug("alert tick failed", exc_info=True)


def reset() -> None:
    """Test hook: drop the singleton and its /alerts provider."""
    global _singleton
    _singleton = None
    try:
        from simple_tip_tpu_torch.obs import exporter

        exporter.clear_provider("alerts")
    except Exception:  # noqa: BLE001 — teardown is best-effort
        pass


# -- cross-process readers + CLI entries (obs alerts / obs incidents) ------


def load_state(state_dir: Optional[str] = None) -> Optional[dict]:
    """The persisted state document, or None when nothing ever evaluated.

    Raises ``ValueError`` on a present-but-corrupt file so the CLI can
    distinguish "no evaluator ran" (exit 3) from "bad input" (exit 2).
    """
    path = _state_path(state_dir or default_state_dir())
    try:
        with open(path, encoding="utf-8") as f:
            raw = f.read()
    except OSError:
        return None
    try:
        doc = json.loads(raw)
    except ValueError as e:
        raise ValueError(f"{path}: corrupt alert state ({e})") from e
    if not isinstance(doc, dict) or doc.get("schema") != SCHEMA:
        raise ValueError(f"{path}: not a schema-{SCHEMA} alert state document")
    return doc


def load_incidents(
    state_dir: Optional[str] = None,
) -> Tuple[List[dict], List[dict]]:
    """``(open, closed)`` incidents from the state file + incidents.jsonl.

    Torn tail lines are skipped (the append-only crash contract); a
    corrupt state file propagates ``ValueError`` like :func:`load_state`.
    """
    state_dir = state_dir or default_state_dir()
    doc = load_state(state_dir)
    open_incs = sorted(
        (doc or {}).get("incidents_open", {}).values(),
        key=lambda i: i.get("opened_ts") or 0,
    )
    closed: List[dict] = []
    try:
        with open(incidents_path(state_dir), encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and rec.get("schema") == SCHEMA:
                    closed.append(rec)
    except OSError:
        pass
    return open_incs, closed


def _iso(ts) -> str:
    from simple_tip_tpu_torch.obs.cli import _iso_utc

    return _iso_utc(ts)


def render_alerts(doc: dict) -> str:
    """The state document as the ``obs alerts`` fixed-width table."""
    lines = [
        f"{'rule':<26} {'sev':<5} {'state':<9} {'burn_f':>8} {'burn_s':>8} "
        f"{'value':>10} {'since (utc)':<26} incident"
    ]
    for name in sorted(doc.get("rules", {})):
        rs = doc["rules"][name]

        def _b(v):
            return "-" if not isinstance(v, (int, float)) else f"{v:.2f}x"

        value = rs.get("last_value")
        shown = "-" if not isinstance(value, (int, float)) else f"{value:.4g}"
        sev = rs.get("severity") if isinstance(rs.get("severity"), str) else "-"
        lines.append(
            f"{name:<26} {sev:<5} "
            f"{rs.get('state', 'inactive'):<9} {_b(rs.get('burn_fast')):>8} "
            f"{_b(rs.get('burn_slow')):>8} {shown:>10} "
            f"{_iso(rs.get('since_ts')):<26} {rs.get('incident') or '-'}"
        )
    firing = sum(
        1 for rs in doc.get("rules", {}).values() if rs.get("state") == "firing"
    )
    lines.append(
        f"\n{firing} firing, "
        f"{sum(1 for rs in doc.get('rules', {}).values() if rs.get('state') == 'pending')} "
        f"pending (fence {doc.get('fence')}, updated {_iso(doc.get('updated_ts'))})"
    )
    return "\n".join(lines)


def render_incidents(open_incs: List[dict], closed: List[dict]) -> str:
    """Open + closed incidents as the ``obs incidents`` table."""
    lines = [
        f"{'id':<13} {'rule':<26} {'sev':<5} {'opened (utc)':<26} "
        f"{'dur_s':>8} {'burn_x':>7} {'req_ids':>7} {'plan':<16} state"
    ]
    for inc in open_incs + closed:
        is_open = "closed_ts" not in inc
        rids = len((inc.get("correlated") or {}).get("request_ids") or [])
        burn = inc.get("budget_burn_x")
        dur = "-" if is_open else f"{float(inc.get('duration_s', 0) or 0):.1f}"
        burn_s = "-" if not isinstance(burn, (int, float)) else f"{burn:.2f}"
        lines.append(
            f"{inc.get('id', '?'):<13} {inc.get('rule', '?'):<26} "
            f"{inc.get('severity', '-'):<5} {_iso(inc.get('opened_ts')):<26} "
            f"{dur:>8} {burn_s:>7} "
            f"{rids:>7} {str(inc.get('plan', '-')):<16} "
            f"{'OPEN' if is_open else 'closed'}"
        )
    return "\n".join(lines)


def cli_alerts(state_dir: Optional[str] = None, as_json: bool = False) -> int:
    """``obs alerts`` entry: render the persisted rule states; exit code.

    Trend-style codes: 0 nothing firing, 1 at least one rule firing,
    2 corrupt state file, 3 no evaluator ever persisted state (a skip).
    """
    # CLI command body (dispatched only from obs/cli.py): stdout/stderr IS
    # the contract here, same as the cli.py entry surface itself.
    try:
        doc = load_state(state_dir)
    except ValueError as e:
        sys.stderr.write(f"obs alerts: {e}\n")
        return 2
    if doc is None:
        sys.stderr.write(
            "obs alerts: no alert state found — no evaluator has run "
            "(set TIP_ALERT_RULES or write $TIP_ASSETS/obs/slo_rules.json; "
            "exit 3: nothing to report, not a failure)\n"
        )
        return 3
    body = (
        json.dumps(doc, indent=2, sort_keys=True, default=repr)
        if as_json
        else render_alerts(doc)
    )
    print(body)  # tiplint: disable=bare-print (`obs alerts` command body; stdout is the CLI contract)
    firing = any(
        rs.get("state") == "firing" for rs in doc.get("rules", {}).values()
    )
    return 1 if firing else 0


def cli_incidents(
    state_dir: Optional[str] = None,
    as_json: bool = False,
    limit: Optional[int] = None,
) -> int:
    """``obs incidents`` entry: the incident timeline; exit code.

    0 all incidents closed, 1 at least one open, 2 corrupt state,
    3 no incidents ever recorded (a skip, not a failure).
    """
    # CLI command body (dispatched only from obs/cli.py): stdout/stderr IS
    # the contract here, same as the cli.py entry surface itself.
    try:
        open_incs, closed = load_incidents(state_dir)
    except ValueError as e:
        sys.stderr.write(f"obs incidents: {e}\n")
        return 2
    if limit is not None:
        closed = closed[-limit:]
    if not open_incs and not closed:
        sys.stderr.write(
            "obs incidents: no incidents recorded (exit 3: nothing to "
            "report, not a failure)\n"
        )
        return 3
    body = (
        json.dumps(
            {"schema": SCHEMA, "open": open_incs, "closed": closed},
            indent=2, sort_keys=True, default=repr,
        )
        if as_json
        else render_incidents(open_incs, closed)
    )
    print(body)  # tiplint: disable=bare-print (`obs incidents` command body; stdout is the CLI contract)
    return 1 if open_incs else 0
