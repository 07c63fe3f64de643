"""Live study inspection: merged tail, refreshing top table, plan audit.

Three operator workflows over the same events-JSONL plumbing the rest of
obs reads post-hoc, but built to run WHILE the study runs:

- :func:`tail` (``obs tail [--follow]``) — one merged, start-aligned tail
  of every process's event stream in a run directory. Incremental byte
  cursors with torn-tail tolerance: a line a writer is mid-appending is
  carried until its newline lands, never dropped and never mis-parsed,
  and files that appear late (a worker spawning mid-phase) join the
  merge on the next poll.
- :func:`top` (``obs top``) — a refreshing phase-progress / queue-depth /
  badge-fill table: announce/start/done/requeue lifecycle counts per
  phase plus the latest registry gauges, recomputed per refresh.
- :func:`audit` (``obs audit``) — grades every completed
  ``scheduler.phase`` span's ``predicted_s`` against its ``actual_s``
  (the pairs run_scheduler stamps; obs v3 collected them but never
  closed the loop), prints per-phase error distributions, and emits them
  as feature-store rows (``--index``) and trend-gateable snapshots
  (``--json`` + ``obs trend``) so cost-model drift fails CI like any
  other regression.

Stdlib-only; output goes through a writable ``out`` stream (default
stdout) so library callers and tests capture it without touching the
process's fds.
"""

import json
import os
import sys
import time
from typing import Dict, List, Optional

# A follow that nobody stops is still bounded: every poll loop carries a
# monotonic deadline (default one day) per the naked-retry contract — on
# this deployment dependencies wedge rather than error, and an unbounded
# poll against a dead study would be a hang.
DEFAULT_FOLLOW_S = 86400.0
_POLL_S = 0.5
# Idle-backoff ceiling for follow mode: each poll that yields no bytes
# doubles the interval up to this cap (reset to the base on activity), so
# a quiet study doesn't busy-rescan its run directory twice a second.
_POLL_CAP_S = 8.0


def _next_poll_s(cur_s: float, base_s: float, active: bool) -> float:
    """The next follow-mode poll interval: base while the streams are
    producing, exponential backoff to ``_POLL_CAP_S`` while idle."""
    if active:
        return base_s
    return min(max(base_s, cur_s) * 2.0, max(base_s, _POLL_CAP_S))

# Version stamp on every emitted audit document: `obs audit --json` output
# is a trend snapshot (regress.load_snapshot consumes it), so the docs
# outlive this writer like any other obs stream row.
SCHEMA = 1


class StreamCursor:
    """Incremental reader of one JSONL stream with torn-tail tolerance.

    Keeps a byte offset plus a carry buffer: each :meth:`poll` reads only
    the bytes appended since the last, and the trailing partial line (a
    writer caught mid-append — the torn tail) is carried until its
    newline arrives instead of being parsed short or dropped.
    """

    def __init__(self, path: str):
        self.path = path
        self.offset = 0
        self._carry = b""
        self.bad_lines = 0

    def poll(self) -> List[dict]:
        """Parse and return the records appended since the last poll."""
        try:
            with open(self.path, "rb") as f:
                f.seek(self.offset)
                chunk = f.read()
        except OSError:
            return []
        if not chunk:
            return []
        self.offset += len(chunk)
        data = self._carry + chunk
        lines = data.split(b"\n")
        self._carry = lines.pop()  # torn tail: kept for the next poll
        out = []
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                self.bad_lines += 1
                continue
            if isinstance(rec, dict):
                rec["_file"] = os.path.basename(self.path)
                out.append(rec)
        return out


def _err(msg: str) -> None:
    """CLI diagnostic to stderr: this module is the obs CLI's live
    surface, so stderr is its diagnostic contract while stdout (the
    ``out`` stream) carries the payload — same split as ``obs predict``.
    """
    sys.stderr.write(msg + "\n")
    sys.stderr.flush()


def _stream_paths(target) -> List[str]:
    """The events-JSONL files of ``target`` (dir(s) or explicit files).

    An explicit ``events-*.jsonl`` file operand also pulls in its sibling
    segments: the tracer rotates to a fresh ``events-<pid>-<n>.jsonl``
    after compaction (the ``obs.evicted`` marker), and a follow pinned to
    the pre-rotation segment alone would go silent mid-study. Rescanning
    the parent directory each poll is what lets ``tail --follow`` ride
    through rotation.
    """
    targets = target if isinstance(target, (list, tuple)) else [target]
    dirs = []
    explicit = []
    for t in targets:
        if os.path.isdir(t):
            dirs.append(t)
        else:
            explicit.append(t)
            base = os.path.basename(t)
            if base.startswith("events-") and base.endswith(".jsonl"):
                dirs.append(os.path.dirname(t) or ".")
    paths = list(explicit)
    for d in dirs:
        try:
            names = sorted(os.listdir(d))
        except OSError:
            continue
        paths.extend(
            os.path.join(d, n)
            for n in names
            if n.startswith("events-") and n.endswith(".jsonl")
        )
    seen = set()
    unique = []
    for p in paths:
        if p not in seen:
            seen.add(p)
            unique.append(p)
    return unique


def iter_tail(
    target,
    follow: bool = False,
    poll_s: float = _POLL_S,
    duration_s: Optional[float] = None,
    max_events: Optional[int] = None,
):
    """Yield merged events from ``target``'s streams, oldest-ts first.

    Non-follow mode drains whatever is on disk once. Follow mode keeps
    polling (rediscovering new stream files each pass, so late-spawning
    workers join the merge) until ``duration_s`` passes or ``max_events``
    have been yielded; within one poll batch events are ts-sorted —
    cross-poll order is arrival order, the live-tail contract. Idle polls
    back the interval off exponentially to ``_POLL_CAP_S`` (reset to
    ``poll_s`` the moment a stream produces events) so a quiet study
    isn't rescanned at full cadence.
    """
    cursors: Dict[str, StreamCursor] = {}
    deadline = time.monotonic() + (
        duration_s if duration_s is not None else DEFAULT_FOLLOW_S
    )
    yielded = 0
    cur_poll = poll_s
    while True:
        live = set(_stream_paths(target))
        for path in live:
            if path not in cursors:
                cursors[path] = StreamCursor(path)
        # Segments the tracer compacted away (no longer listed, gone from
        # disk) leave dead cursors behind; prune them so a long follow
        # over many rotations doesn't poll an unbounded stale set.
        for path in [p for p in cursors if p not in live]:
            if not os.path.exists(path):
                del cursors[path]
        batch = []
        for cursor in cursors.values():
            batch.extend(cursor.poll())
        batch.sort(key=lambda r: (r.get("ts") or 0, r.get("pid") or 0))
        for rec in batch:
            yield rec
            yielded += 1
            if max_events is not None and yielded >= max_events:
                return
        if not follow:
            return
        now = time.monotonic()
        if now >= deadline:
            return
        cur_poll = _next_poll_s(cur_poll, poll_s, active=bool(batch))
        time.sleep(min(cur_poll, deadline - now))


def format_event(rec: dict, t0: Optional[float]) -> str:
    """One tail line: start-aligned offset, pid, type, name, attrs."""
    ts = rec.get("ts")
    if isinstance(ts, (int, float)) and t0 is not None:
        clock = f"+{max(0.0, ts - t0):9.3f}s"
    else:
        clock = " " * 10 + "-"
    kind = str(rec.get("type", "?"))
    name = str(rec.get("name", "")) if kind != "metrics" else "(registry)"
    if kind == "log":
        name = f"[{rec.get('level', '?')}] {str(rec.get('msg', ''))[:120]}"
    attrs = rec.get("attrs")
    detail = ""
    if isinstance(attrs, dict) and attrs:
        detail = " " + json.dumps(attrs, sort_keys=True, default=repr)[:160]
    dur = rec.get("dur")
    if kind == "span" and isinstance(dur, (int, float)):
        detail = f" dur={dur:.3f}s" + detail
    return f"{clock} pid={rec.get('pid', '?'):<7} {kind:<7} {name}{detail}"


def tail(
    target,
    follow: bool = False,
    poll_s: float = _POLL_S,
    duration_s: Optional[float] = None,
    max_events: Optional[int] = None,
    out=None,
) -> int:
    """``obs tail`` entry: stream formatted events to ``out``; exit code.

    The alignment origin is the earliest ts seen (the study's first meta
    line in practice), so every process's events print on one clock.
    """
    out = out or sys.stdout
    t0: Optional[float] = None
    n = 0
    for rec in iter_tail(
        target, follow=follow, poll_s=poll_s,
        duration_s=duration_s, max_events=max_events,
    ):
        ts = rec.get("ts")
        if t0 is None and isinstance(ts, (int, float)):
            t0 = ts
        out.write(format_event(rec, t0) + "\n")
        out.flush()
        n += 1
    if n == 0 and not follow:
        _err(f"obs tail: no events under {target}")
        return 3
    return 0


# -- top -------------------------------------------------------------------


def top_snapshot(events) -> dict:
    """Aggregate a study's live progress from its event stream.

    Per phase: announced / started / done / failed / requeued lifecycle
    counts and the derived queue depth (announced but not yet resolved).
    Plus the newest registry gauges and badge-fill/queue metrics from
    ``metrics`` flush events — the serving liveness columns.
    """
    phases: Dict[str, Dict[str, int]] = {}
    gauges: Dict[str, float] = {}
    counters: Dict[str, float] = {}

    def bucket(phase) -> Dict[str, int]:
        return phases.setdefault(
            str(phase or "?"),
            {"announced": 0, "started": 0, "done": 0, "failed": 0,
             "requeued": 0, "expected": 0},
        )

    for rec in events:
        kind = rec.get("type")
        if kind == "event":
            name = rec.get("name", "")
            attrs = rec.get("attrs") or {}
            short = {
                "scheduler.announce": "announced",
                "scheduler.start": "started",
                "scheduler.done": "done",
                "scheduler.fail": "failed",
                "scheduler.requeue": "requeued",
            }.get(name)
            if short:
                bucket(attrs.get("phase"))[short] += 1
        elif kind == "span" and rec.get("name") == "scheduler.phase":
            attrs = rec.get("attrs") or {}
            b = bucket(attrs.get("phase"))
            runs = attrs.get("runs")
            if isinstance(runs, (int, float)):
                b["expected"] = max(b["expected"], int(runs))
        elif kind == "metrics":
            for k, v in (rec.get("gauges") or {}).items():
                if isinstance(v, (int, float)):
                    gauges[k] = v
            for k, v in (rec.get("counters") or {}).items():
                if isinstance(v, (int, float)):
                    counters[k] = max(counters.get(k, 0), v)
    for b in phases.values():
        b["queue"] = max(0, b["announced"] - b["done"] - b["failed"])
    return {"phases": phases, "gauges": gauges, "counters": counters}


def render_top(snap: dict) -> str:
    """The :func:`top_snapshot` dict as a fixed-width progress table."""
    lines = [
        f"{'phase':<24} {'done':>6} {'fail':>6} {'queue':>6} "
        f"{'requeue':>8} {'announced':>10}"
    ]
    for phase, b in sorted(snap.get("phases", {}).items()):
        expected = f"/{b['expected']}" if b.get("expected") else ""
        lines.append(
            f"{phase:<24} {b['done']:>6} {b['failed']:>6} {b['queue']:>6} "
            f"{b['requeued']:>8} {str(b['announced']) + expected:>10}"
        )
    gauges = snap.get("gauges", {})
    interesting = {
        k: v
        for k, v in sorted(gauges.items())
        if k.startswith(("serving.", "scheduler.")) or "badge" in k
    }
    if interesting:
        lines.append("")
        for k, v in interesting.items():
            lines.append(f"  {k:<40} {v}")
    # Dispatch counters are the grouped-path liveness signal: a G-sweep
    # that stopped incrementing group_chain_dispatches is wedged even
    # while its gauges hold their last value.
    counters = snap.get("counters", {})
    dispatch = {
        k: v
        for k, v in sorted(counters.items())
        if k.startswith("run_program.") or k.startswith("serving.")
    }
    if dispatch:
        lines.append("")
        for k, v in dispatch.items():
            shown = int(v) if float(v).is_integer() else v
            lines.append(f"  {k:<40} {shown}")
    return "\n".join(lines)


def top(
    target,
    refresh_s: float = 2.0,
    iterations: Optional[int] = None,
    out=None,
) -> int:
    """``obs top`` entry: render the progress table every ``refresh_s``.

    ``iterations=1`` is the one-shot mode (CI / tests); otherwise the
    loop runs until its day-long deadline or Ctrl-C, re-reading the run
    directory each pass (re-reads are cheap at study scale, and a full
    re-read is what makes late files and compactions harmless).
    """
    from simple_tip_tpu_torch.obs.cli import load_events

    out = out or sys.stdout
    deadline = time.monotonic() + DEFAULT_FOLLOW_S
    n = 0
    while True:
        events, files, _bad = load_events(target)
        if not files and n == 0:
            _err(f"obs top: no events under {target}")
            return 3
        n += 1
        if n > 1:
            out.write("\x1b[2J\x1b[H")  # clear + home between refreshes
        out.write(render_top(top_snapshot(events)) + "\n")
        out.flush()
        if iterations is not None and n >= iterations:
            return 0
        if time.monotonic() >= deadline:
            return 0
        time.sleep(max(0.1, refresh_s))


# -- audit -----------------------------------------------------------------


def audit_events(events, source: str = "") -> dict:
    """Grade every predicted-vs-actual pair in one run's events.

    Returns a trend-gateable snapshot document::

        {"kind": "audit", "source": ..., "spans": [per-span grades],
         "by_phase": {phase: {count, mean_abs_error_s, mean_rel_err,
                              bias_s}},
         "phases": {"audit.<phase>": mean_abs_error_s}}

    ``phases`` carries mean ABSOLUTE error seconds per phase — the shape
    ``obs trend`` gates, so a drifted cost model (errors jumping out of
    the historical band) fails CI exactly like a runtime regression.
    """
    spans = []
    for rec in events:
        if rec.get("type") != "span":
            continue
        attrs = rec.get("attrs") or {}
        pred, act = attrs.get("predicted_s"), attrs.get("actual_s")
        if not (
            isinstance(pred, (int, float)) and isinstance(act, (int, float))
        ):
            continue
        err = float(act) - float(pred)
        spans.append(
            {
                "span": str(rec.get("name", "?")),
                "phase": str(attrs.get("phase") or rec.get("name", "?")),
                "case_study": attrs.get("case_study"),
                "predicted_s": round(float(pred), 6),
                "actual_s": round(float(act), 6),
                "error_s": round(err, 6),
                "rel_err": round(err / float(pred), 6) if pred else None,
            }
        )
    by_phase: Dict[str, dict] = {}
    for s in spans:
        agg = by_phase.setdefault(
            s["phase"], {"count": 0, "_abs": 0.0, "_signed": 0.0, "_rel": 0.0}
        )
        agg["count"] += 1
        agg["_abs"] += abs(s["error_s"])
        agg["_signed"] += s["error_s"]
        agg["_rel"] += abs(s["rel_err"] or 0.0)
    for phase, agg in by_phase.items():
        n = agg.pop("count")
        by_phase[phase] = {
            "count": n,
            "mean_abs_error_s": round(agg.pop("_abs") / n, 6),
            "bias_s": round(agg.pop("_signed") / n, 6),
            "mean_rel_err": round(agg.pop("_rel") / n, 6),
        }
    return {
        "schema": SCHEMA,
        "kind": "audit",
        "source": str(source),
        "spans": spans,
        "by_phase": by_phase,
        "phases": {
            f"audit.{phase}": agg["mean_abs_error_s"]
            for phase, agg in by_phase.items()
        },
        "degraded": False,
        "counters": {},
    }


def render_audit(doc: dict) -> str:
    """The audit document as a per-phase plan-vs-actual table."""
    lines = [
        f"{'phase':<24} {'n':>4} {'mean|err|':>10} {'bias':>10} "
        f"{'mean rel':>9}"
    ]
    for phase, agg in sorted(doc.get("by_phase", {}).items()):
        lines.append(
            f"{phase:<24} {agg['count']:>4} {agg['mean_abs_error_s']:>9.3f}s "
            f"{agg['bias_s']:>+9.3f}s {agg['mean_rel_err']:>8.1%}"
        )
    for s in doc.get("spans", []):
        rel = f"{s['rel_err']:+.1%}" if s["rel_err"] is not None else "-"
        lines.append(
            f"  {s['phase']:<22} predicted {s['predicted_s']:>8.3f}s  "
            f"actual {s['actual_s']:>8.3f}s  ({rel})"
        )
    return "\n".join(lines)


def audit(
    targets,
    index: Optional[str] = None,
    as_json: bool = False,
    out=None,
) -> int:
    """``obs audit`` entry: grade run dirs, print/emit; exit code.

    Exit 0 with grades on stdout (``--json``: the snapshot document —
    feed a chronological series of them to ``obs trend`` to gate model
    drift); exit 3 when no span in the targets carries a
    predicted_s/actual_s pair (nothing to audit — same contract as
    ``obs predict``'s insufficient corpus); diagnostics on stderr. With
    ``index``, the targets are also refreshed into the feature store,
    whose obs-run normalizer emits the per-phase ``audit.*`` error rows.
    """
    from simple_tip_tpu_torch.obs.cli import load_events

    out = out or sys.stdout
    events, files, bad = load_events(targets)
    # load_events lists a missing operand as an (unreadable) candidate
    # file; "no streams" means nothing on disk actually backed the merge.
    if not any(os.path.exists(f) for f in files):
        if as_json:
            out.write(
                json.dumps(
                    {"schema": SCHEMA, "kind": "audit", "error": "no_streams"}
                )
                + "\n"
            )
        _err(f"obs audit: no events-*.jsonl streams under {targets}")
        return 2
    doc = audit_events(
        events, source=targets[0] if len(targets) == 1 else ";".join(targets)
    )
    if bad:
        _err(f"obs audit: skipped {bad} torn line(s)")
    if index:
        from simple_tip_tpu_torch.obs import store

        report = store.refresh(targets, index)
        _err(
            f"obs audit: indexed {len(report['indexed'])} source(s) "
            f"(+{report['rows_appended']} rows) into {report['index']}"
        )
    if as_json:
        out.write(json.dumps(doc, indent=2, sort_keys=True) + "\n")
    else:
        out.write(render_audit(doc) + "\n")
    if not doc["spans"]:
        _err(
            "obs audit: no span carries both predicted_s and actual_s — "
            "nothing to grade (exit 3; run with the feature-store index "
            "populated so the scheduler stamps predictions)"
        )
        return 3
    return 0
