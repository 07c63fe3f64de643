"""Run-inspection CLI: merge a run's JSONL streams, summarize, export.

``python -m simple_tip_tpu_torch.obs <command> <run-dir-or-files>``:

- ``summary``  merge every ``events-*.jsonl`` in the run directory and print
  a per-process, per-span-name (phase) and per-scheduled-run table plus the
  summed metrics counters — the after-the-fact answer to "where did this
  study's wall-clock go";
- ``export``   write a Chrome/Perfetto ``trace_event`` JSON (``-o`` path;
  load in https://ui.perfetto.dev or chrome://tracing) so a whole 100-run
  study is one flame chart: one track group per process (worker-stamped),
  spans as complete events, lifecycle events as instants, metrics flushes
  as counter tracks;
- ``check``    validate a trace (CI self-check): every line parses or is
  counted as a torn tail, every event carries the schema's required keys,
  every file opens with its ``meta`` stamp. Exit 1 on schema violations.
- ``regress``  diff two runs (trace dirs, ``summary --json`` documents or
  bench records — see ``obs/regress.py``) per phase/metric; prints the
  comparison table and exits nonzero on any regression (phase-duration
  growth past the threshold, a ``degraded`` false->true flip, health
  counter growth). ``--against`` names the baseline explicitly; with no
  current operand the newest ``BENCH_r*.json`` in the working directory
  is compared.
- ``runs``     build/refresh the telemetry feature store (``obs/store.py``):
  normalize obs run dirs + ``BENCH_r*.json`` + ``HOST_PHASE.json`` +
  ``MULTICHIP_r*.json`` under the given roots into schema-versioned
  (run, phase) feature rows in the append-only index at ``TIP_OBS_INDEX``
  (default ``$TIP_ASSETS/obs/index``), then print the queryable table.
- ``predict``  fit the per-phase cost model (``obs/costmodel.py``) over the
  index and estimate wall-clock for a proposed study config (case studies
  x runs x phases x backend x workers), with a stated error and a loud
  insufficient-corpus fallback.
- ``trend``    gate the LAST of N chronological snapshots against robust
  median/MAD trend bands over its non-degraded predecessors
  (``obs/regress.py``'s N-run upgrade of the 2-run diff).
- ``roofline`` per-program MFU / achieved-bandwidth table with a
  compute-bound vs HBM-bound verdict per program (``obs/devicemeter.py``),
  from ``MFU_BREAKDOWN.json`` captures or a run's live dispatch gauges.
- ``alerts``   the SLO evaluator's per-rule alert states and burn rates
  from the persisted state file (``obs/alerts.py``); exit 1 while any
  rule is firing, so a watch loop can page on the exit code alone.
- ``incidents`` the incident timeline: open incidents from the state file
  plus the closed records in ``incidents.jsonl``, each correlating its
  alert window to spans, request_ids and the active plan fingerprint.

Exit codes (``regress`` and ``trend``, so CI can tell skip from failure):
**0** inside the band / no regression, **1** regression detected,
**2** bad input (unreadable/unrecognizable snapshot), **3** no comparable
baseline (empty corpus, all-degraded history — a skip, not a failure).
``predict`` reuses 3 for "insufficient corpus for every requested phase".

``export --splice-xla`` additionally reads each span's ``xla_trace_dir``
attribute (written by ``utils/profiling.maybe_trace`` when
``TIP_PROFILE_DIR`` is set: there the ``torch.profiler`` Chrome trace of
the phase; the flag keeps the JAX package's name), shifts it onto the span
clock and emits the host and device timelines into the SAME Perfetto
file, grouped under ``xla:<span>`` track groups (``obs/splice.py``).

Merging is tolerant by construction: files are read line-wise, unparsable
lines (a crash's torn tail) are skipped and counted, and ordering is by the
events' wall-clock ``ts`` — the streams share the host clock, which is
exactly why spans record ``time.time`` starts next to their monotonic
durations.

Counterpart of the JAX package's ``obs/cli.py``: the same commands, the
same exit codes. Stdlib only: it runs on hosts with no card and no torch.
"""

import argparse
import datetime
import json
import os
import sys


def _iso_utc(ts) -> str:
    """Epoch seconds as UTC ISO-8601 with millisecond precision."""
    if not isinstance(ts, (int, float)):
        return "-"
    dt = datetime.datetime.fromtimestamp(ts, datetime.timezone.utc)
    return dt.strftime("%Y-%m-%dT%H:%M:%S.") + f"{dt.microsecond // 1000:03d}Z"


def filter_phase(events, phase: str):
    """The events belonging to ``phase``: spans named it (or attributed to
    it via ``attrs.phase``) and lifecycle events attributed to it. ``meta``
    events survive so process identity still renders; metrics/log records
    are dropped (they are not phase-scoped and would mislead)."""
    kept = []
    for rec in events:
        kind = rec.get("type")
        if kind == "meta":
            kept.append(rec)
            continue
        if kind not in ("span", "event"):
            continue
        attrs = rec.get("attrs") or {}
        if rec.get("name") == phase or attrs.get("phase") == phase:
            kept.append(rec)
    return kept


def iter_trace_files(target):
    """Yield the JSONL files of ``target`` (a run dir, a file, or several)."""
    targets = target if isinstance(target, (list, tuple)) else [target]
    for t in targets:
        if os.path.isdir(t):
            names = sorted(
                n
                for n in os.listdir(t)
                if n.startswith("events-") and n.endswith(".jsonl")
            )
            for n in names:
                yield os.path.join(t, n)
        else:
            yield t


def load_events(target):
    """Merge ``target``'s streams into one ts-ordered event list.

    Returns ``(events, files, bad_lines)``; every event is annotated with
    its source file under ``_file``. Lines that fail to parse (torn crash
    tails) are skipped and counted, never fatal.
    """
    events, files, bad = [], [], 0
    for path in iter_trace_files(target):
        files.append(path)
        try:
            with open(path, encoding="utf-8") as f:
                for lineno, line in enumerate(f, start=1):
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        bad += 1
                        continue
                    if not isinstance(rec, dict):
                        bad += 1
                        continue
                    rec["_file"] = os.path.basename(path)
                    # File-order position: spans are written on EXIT with
                    # their (earlier) start ts, so ts order is NOT file
                    # order — ``check`` needs the latter for the meta stamp.
                    rec["_line"] = lineno
                    events.append(rec)
        except OSError as e:
            print(f"obs: cannot read {path}: {e}", file=sys.stderr)
    events.sort(key=lambda r: (r.get("ts") or 0, r.get("pid") or 0))
    return events, files, bad


def _processes(events):
    """pid -> {worker, platform, first, last, spans, events, logs} rollup."""
    procs = {}
    for rec in events:
        pid = rec.get("pid")
        if pid is None:
            continue
        p = procs.setdefault(
            pid,
            {"worker": "", "platform": "", "first": None, "last": None,
             "spans": 0, "events": 0, "logs": 0},
        )
        ts = rec.get("ts")
        if isinstance(ts, (int, float)):
            p["first"] = ts if p["first"] is None else min(p["first"], ts)
            end = ts + rec.get("dur", 0) if rec.get("type") == "span" else ts
            p["last"] = end if p["last"] is None else max(p["last"], end)
        kind = rec.get("type")
        if kind == "meta":
            p["worker"] = str(rec.get("worker", p["worker"]) or p["worker"])
            p["platform"] = str(rec.get("platform", p["platform"]) or p["platform"])
        elif kind == "span":
            p["spans"] += 1
        elif kind == "event":
            p["events"] += 1
        elif kind == "log":
            p["logs"] += 1
    return procs


def _span_table(events):
    """span name -> (count, total_s, max_s) aggregate."""
    table = {}
    for rec in events:
        if rec.get("type") != "span":
            continue
        name = str(rec.get("name", "?"))
        dur = float(rec.get("dur", 0) or 0)
        cnt, tot, mx = table.get(name, (0, 0.0, 0.0))
        table[name] = (cnt + 1, tot + dur, max(mx, dur))
    return table


def _scheduler_runs(events):
    """model id -> lifecycle rollup from the scheduler's ``scheduler.*`` events."""
    runs = {}
    for rec in events:
        if rec.get("type") != "event":
            continue
        name = str(rec.get("name", ""))
        if not name.startswith("scheduler."):
            continue
        attrs = rec.get("attrs") or {}
        mid = attrs.get("model_id")
        if mid is None:
            continue
        r = runs.setdefault(
            mid, {"events": [], "first": None, "last": None, "pid": None}
        )
        stage = name.split(".", 1)[1]
        r["events"].append(stage)
        ts = rec.get("ts")
        if isinstance(ts, (int, float)):
            r["first"] = ts if r["first"] is None else min(r["first"], ts)
            r["last"] = ts if r["last"] is None else max(r["last"], ts)
        if stage == "start" and attrs.get("worker_pid") is not None:
            r["pid"] = attrs["worker_pid"]
    return runs


def _summed_counters(events):
    """Final metrics flush per pid, counters summed across processes."""
    last_by_pid = {}
    for rec in events:
        if rec.get("type") == "metrics" and rec.get("pid") is not None:
            last_by_pid[rec["pid"]] = rec
    summed = {}
    for rec in last_by_pid.values():
        for name, value in (rec.get("counters") or {}).items():
            if isinstance(value, (int, float)):
                summed[name] = summed.get(name, 0) + value
    return summed


def summarize(events, files, bad) -> str:
    """Render the merged run as the deterministic text summary."""
    out = []
    spans = [r for r in events if r.get("type") == "span"]
    out.append(
        f"files: {len(files)}  events: {len(events)}  spans: {len(spans)}  "
        f"bad lines: {bad}"
    )
    tss = [r["ts"] for r in events if isinstance(r.get("ts"), (int, float))]
    t0 = min(tss) if tss else 0.0
    if tss:
        out.append(f"start: {_iso_utc(t0)}")

    procs = _processes(events)
    if procs:
        out.append("")
        out.append("processes:")
        for pid in sorted(procs):
            p = procs[pid]
            first = 0.0 if p["first"] is None else p["first"] - t0
            last = 0.0 if p["last"] is None else p["last"] - t0
            tag = f"worker={p['worker'] or '-'} platform={p['platform'] or '-'}"
            out.append(
                f"  pid {pid:<8} {tag:<28} spans={p['spans']:<5} "
                f"events={p['events']:<5} logs={p['logs']:<5} "
                f"window={first:.3f}s..{last:.3f}s"
            )

    table = _span_table(events)
    if table:
        out.append("")
        out.append("spans by name (the per-phase table):")
        out.append(f"  {'name':<40} {'count':>6} {'total_s':>10} {'mean_s':>9} {'max_s':>9}")
        for name in sorted(table, key=lambda n: -table[n][1]):
            cnt, tot, mx = table[name]
            out.append(
                f"  {name:<40} {cnt:>6} {tot:>10.3f} {tot / cnt:>9.3f} {mx:>9.3f}"
            )

    runs = _scheduler_runs(events)
    if runs:
        out.append("")
        out.append("scheduled runs:")
        out.append(
            f"  {'model_id':<9} {'start_utc':<26} {'lifecycle':<34} "
            f"{'wall_s':>8} {'worker_pid':>11}"
        )
        for mid in sorted(runs, key=lambda m: (str(type(m)), m)):
            r = runs[mid]
            wall = (
                (r["last"] - r["first"])
                if r["first"] is not None and r["last"] is not None
                else 0.0
            )
            out.append(
                f"  {str(mid):<9} {_iso_utc(r['first']):<26} "
                f"{','.join(r['events']):<34} {wall:>8.3f} "
                f"{str(r['pid'] if r['pid'] is not None else '-'):>11}"
            )

    counters = _summed_counters(events)
    if counters:
        out.append("")
        out.append("counters (summed over processes):")
        for name in sorted(counters):
            out.append(f"  {name:<44} {counters[name]}")
    return "\n".join(out)


def to_chrome_trace(events) -> dict:
    """The merged events as a Chrome/Perfetto ``trace_event`` document.

    Timestamps become microseconds relative to the earliest event; spans are
    ``X`` complete events, lifecycle events ``i`` instants, log records
    ``i`` instants in a ``log`` category, and each metrics flush fans out
    into ``C`` counter samples. Process metadata (``M``) names each track
    group ``pid <pid> [worker i] [(platform)]``.
    """
    tss = [r["ts"] for r in events if isinstance(r.get("ts"), (int, float))]
    t0 = min(tss) if tss else 0.0

    def us(ts):
        return max(0, int(round((ts - t0) * 1e6)))

    trace = []
    for pid, p in sorted(_processes(events).items()):
        label = f"pid {pid}"
        if p["worker"]:
            label += f" worker {p['worker']}"
        if p["platform"]:
            label += f" ({p['platform']})"
        trace.append(
            {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
             "args": {"name": label}}
        )
    for rec in events:
        kind = rec.get("type")
        pid = rec.get("pid", 0)
        tid = rec.get("tid", 0)
        ts = rec.get("ts")
        if not isinstance(ts, (int, float)):
            continue
        if kind == "span":
            args = dict(rec.get("attrs") or {})
            if "error" in rec:
                args["error"] = rec["error"]
            trace.append(
                {"ph": "X", "name": str(rec.get("name", "?")), "cat": "span",
                 "pid": pid, "tid": tid, "ts": us(ts),
                 "dur": max(1, int(round(float(rec.get("dur", 0) or 0) * 1e6))),
                 "args": args}
            )
        elif kind == "event":
            trace.append(
                {"ph": "i", "name": str(rec.get("name", "?")), "cat": "event",
                 "pid": pid, "tid": tid, "ts": us(ts), "s": "t",
                 "args": dict(rec.get("attrs") or {})}
            )
        elif kind == "log":
            trace.append(
                {"ph": "i", "name": f"{rec.get('level', '?')}: {rec.get('msg', '')}"[:120],
                 "cat": "log", "pid": pid, "tid": tid, "ts": us(ts), "s": "t",
                 "args": {"logger": rec.get("logger", "")}}
            )
        elif kind == "metrics":
            # Counters AND gauges become counter tracks: the per-device
            # memory high-water (device.*.peak_bytes_in_use gauges, polled
            # by the scheduler loop) graphs over the run this way.
            for source in ("counters", "gauges"):
                for name, value in (rec.get(source) or {}).items():
                    if isinstance(value, (int, float)):
                        trace.append(
                            {"ph": "C", "name": name, "pid": pid, "tid": 0,
                             "ts": us(ts), "args": {"value": value}}
                        )
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


#: type -> keys every event of that type must carry (the schema contract
#: ``check`` enforces; README "Observability" documents it).
REQUIRED_KEYS = {
    "meta": ("ts", "pid"),
    "span": ("ts", "dur", "name", "pid", "tid", "id", "depth"),
    "event": ("ts", "name", "pid"),
    "log": ("ts", "pid", "level", "msg"),
    "metrics": ("ts", "pid", "counters", "gauges", "histograms"),
}


def check(events, files, bad):
    """Validate the trace against the event schema; returns problem strings."""
    problems = []
    if not files:
        problems.append("no events-*.jsonl files found")
    first_by_file = {}
    for rec in events:
        f = rec["_file"]
        head = first_by_file.get(f)
        if head is None or rec.get("_line", 0) < head.get("_line", 0):
            first_by_file[f] = rec
        kind = rec.get("type")
        if kind not in REQUIRED_KEYS:
            problems.append(f"{f}: unknown event type {kind!r}")
            continue
        missing = [k for k in REQUIRED_KEYS[kind] if k not in rec]
        if missing:
            problems.append(f"{f}: {kind} event missing keys {missing}")
        if kind == "span" and not (
            isinstance(rec.get("dur"), (int, float)) and rec["dur"] >= 0
        ):
            problems.append(f"{f}: span {rec.get('name')!r} has bad dur")
    for path in files:
        name = os.path.basename(path)
        head = first_by_file.get(name)
        if head is not None and head.get("type") != "meta":
            problems.append(f"{name}: first event is not the meta stamp")
    return problems


def _newest_bench_record(cwd: str):
    """The newest ``BENCH_r*.json`` in ``cwd`` (by round number), or None."""
    names = sorted(
        n
        for n in os.listdir(cwd)
        if n.startswith("BENCH_r") and n.endswith(".json")
    )
    return os.path.join(cwd, names[-1]) if names else None


def _regress(args) -> int:
    """``obs regress`` entry: resolve operands, compare, print, exit code."""
    from simple_tip_tpu_torch.obs import regress as regress_mod

    targets = list(args.targets)
    baseline_path = args.against
    if baseline_path is None:
        if len(targets) < 2:
            print(
                "obs regress: need BASELINE and CURRENT (or --against BASELINE)",
                file=sys.stderr,
            )
            return 2
        baseline_path = targets.pop(0)
    if targets:
        current_path = targets.pop(0)
    else:
        # `obs regress --against BENCH_r04.json`: current defaults to the
        # newest bench round record in the working directory.
        current_path = _newest_bench_record(os.getcwd())
        if current_path is None or os.path.abspath(current_path) == os.path.abspath(
            baseline_path
        ):
            print(
                "obs regress: no CURRENT operand and no newer BENCH_r*.json "
                "in the working directory (exit 3: nothing comparable, "
                "not a regression)",
                file=sys.stderr,
            )
            return 3
    if targets:
        print(f"obs regress: unexpected extra operands {targets}", file=sys.stderr)
        return 2
    try:
        baseline = regress_mod.load_snapshot(baseline_path)
        current = regress_mod.load_snapshot(current_path)
    except ValueError as e:
        print(f"obs regress: {e}", file=sys.stderr)
        return 2
    kwargs = {}
    if args.max_growth is not None:
        kwargs["max_growth"] = args.max_growth
    result = regress_mod.compare(baseline, current, **kwargs)
    if args.json:
        print(
            json.dumps(
                {
                    "baseline": baseline["source"],
                    "current": current["source"],
                    "ok": result["ok"],
                    "rows": result["rows"],
                },
                indent=2,
                sort_keys=True,
            )
        )
    else:
        print(regress_mod.render(result, baseline, current))
    return 0 if result["ok"] else 1


def _runs(args) -> int:
    """``obs runs`` entry: refresh the feature-store index, print it."""
    from simple_tip_tpu_torch.obs import store

    index_dir = args.index or store.default_index_dir()
    if not args.no_refresh:
        report = store.refresh(args.roots or [os.getcwd()], index_dir)
        print(
            f"index: {report['index']}  sources: {report['sources']} "
            f"({len(report['indexed'])} indexed, {report['skipped']} "
            f"unchanged)  rows: +{report['rows_appended']} -> "
            f"{report['rows_total']}",
            file=sys.stderr,
        )
    rows = store.load_rows(index_dir)
    if args.json:
        print(json.dumps(rows, indent=2, sort_keys=True))
    else:
        print(store.render_rows(rows, limit=args.limit))
    return 0


def _predict(args) -> int:
    """``obs predict`` entry: fit over the index, estimate study wall-clock."""
    from simple_tip_tpu_torch.obs import costmodel, store

    # Shared cached corpus load: the planner (simple_tip_tpu_torch.plan) and
    # this CLI score against the identical parsed rows, one walk per
    # index stat instead of one per call.
    rows = store.load_corpus(args.index or store.default_index_dir())
    if not rows:
        if args.json:
            # The --json contract: stdout ALWAYS carries one valid JSON
            # document, even on the exit-3 path — diagnostics stay on
            # stderr so piped consumers never parse an empty/corrupt body.
            print(
                json.dumps(
                    {"ok": False, "error": "insufficient_corpus",
                     "phases": {}, "total_s": None},
                    indent=2, sort_keys=True,
                )
            )
        print(
            "obs predict: the feature-store index is empty — run "
            "`obs runs <roots>` first (exit 3: insufficient corpus)",
            file=sys.stderr,
        )
        return 3
    phases = [p.strip() for p in args.phases.split(",") if p.strip()]
    if not phases:
        print("obs predict: --phases must name at least one phase", file=sys.stderr)
        return 2
    model = costmodel.fit(rows)
    result = costmodel.predict_study(
        model,
        phases,
        runs=args.runs,
        case_studies=args.case_studies,
        platform=args.platform,
        workers=args.workers,
        batch=args.batch,
        group=args.group,
    )
    if args.json:
        print(json.dumps(result, indent=2, sort_keys=True))
    else:
        print(costmodel.render_prediction(result))
    if not result["ok"]:
        print(
            "obs predict: INSUFFICIENT CORPUS — no requested phase has any "
            "estimate (exit 3)",
            file=sys.stderr,
        )
        return 3
    return 0


def _merged_metrics_snapshot(events) -> dict:
    """Final metrics flush per pid, gauges/quantiles merged across
    processes (last flush wins per name) — the live-registry view
    ``obs roofline`` reads out of a run directory."""
    last_by_pid = {}
    for rec in events:
        if rec.get("type") == "metrics" and rec.get("pid") is not None:
            last_by_pid[rec["pid"]] = rec
    gauges, quantiles = {}, {}
    for pid in sorted(last_by_pid):
        rec = last_by_pid[pid]
        for name, v in (rec.get("gauges") or {}).items():
            if isinstance(v, (int, float)):
                gauges[name] = v
        for name, v in (rec.get("quantiles") or {}).items():
            if isinstance(v, dict):
                quantiles[name] = v
    return {"gauges": gauges, "quantiles": quantiles}


def _roofline(args) -> int:
    """``obs roofline`` entry: per-program MFU/bandwidth table with a
    compute-bound vs HBM-bound verdict per program. Targets are
    ``MFU_BREAKDOWN.json`` captures (devicemeter documents) and/or obs
    run dirs / ``events-*.jsonl`` streams (live gauges + dispatch
    quantiles). Exit 0 with rows, 3 with nothing to render, 2 bad input."""
    from simple_tip_tpu_torch.obs import devicemeter

    sections = []
    for target in args.targets:
        if os.path.isdir(target) or str(target).endswith(".jsonl"):
            events, files, _bad = load_events(target)
            if not files:
                print(
                    f"obs roofline: {target}: no events-*.jsonl streams found",
                    file=sys.stderr,
                )
                return 2
            rows = devicemeter.rows_from_metrics(
                _merged_metrics_snapshot(events)
            )
            sections.append({"target": str(target), "rows": rows})
            continue
        try:
            with open(target, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            print(
                f"obs roofline: {target}: not a readable JSON document ({e})",
                file=sys.stderr,
            )
            return 2
        if not isinstance(doc, dict) or doc.get("kind") != devicemeter.KIND:
            print(
                f"obs roofline: {target}: not an MFU_BREAKDOWN document "
                f"(kind != {devicemeter.KIND!r})",
                file=sys.stderr,
            )
            return 2
        rows = devicemeter.rows_from_breakdown(doc)
        label = (
            f"{target}  [{doc.get('platform', '?')}/"
            f"{doc.get('device_kind', '?')}"
            f"{', DEGRADED' if doc.get('degraded') else ''}]"
        )
        sections.append({"target": label, "rows": rows})
    if not any(s["rows"] for s in sections):
        print(
            "obs roofline: no graded programs found (exit 3: nothing to "
            "render, not a failure)",
            file=sys.stderr,
        )
        return 3
    if args.json:
        print(json.dumps(sections, indent=2, sort_keys=True))
        return 0
    blocks = []
    for s in sections:
        if not s["rows"]:
            blocks.append(f"{s['target']}\n  (no graded programs)")
            continue
        blocks.append(devicemeter.render_roofline(s["rows"], header=s["target"]))
    print("\n\n".join(blocks))
    return 0


def _trend(args) -> int:
    """``obs trend`` entry: N-run trend gate; exit 0/1/2/3."""
    from simple_tip_tpu_torch.obs import regress as regress_mod

    try:
        snapshots = [regress_mod.load_snapshot(t) for t in args.targets]
    except ValueError as e:
        print(f"obs trend: {e}", file=sys.stderr)
        return 2
    kwargs = {}
    if args.window is not None:
        kwargs["window"] = args.window
    if args.band is not None:
        kwargs["band"] = args.band
    if args.min_baseline is not None:
        kwargs["min_baseline"] = args.min_baseline
    result = regress_mod.trend(snapshots, **kwargs)
    if args.json:
        print(json.dumps(result, indent=2, sort_keys=True))
    else:
        print(regress_mod.render_trend(result))
    if result["verdict"] == "no_comparable_baseline":
        return 3
    return 0 if result["ok"] else 1


def main(argv=None) -> int:
    """CLI entry point; returns the process exit code."""
    ap = argparse.ArgumentParser(
        prog="python -m simple_tip_tpu_torch.obs",
        description="Inspect a TIP_OBS_DIR run: summary table, Perfetto "
        "export (optionally with spliced profiler timelines), schema "
        "self-check, or cross-run regression detection.",
    )
    sub = ap.add_subparsers(dest="command", required=True)
    for name, doc in (
        ("summary", "per-process / per-phase / per-run summary table"),
        ("export", "write Chrome/Perfetto trace_event JSON"),
        ("check", "validate a trace against the event schema (CI)"),
    ):
        p = sub.add_parser(name, help=doc)
        p.add_argument("target", nargs="+", help="run directory or .jsonl files")
        if name == "summary":
            p.add_argument("--json", action="store_true", help="machine-readable output")
            p.add_argument(
                "--phase",
                default=None,
                metavar="NAME",
                help="only spans/events of this phase (span name or "
                "attrs.phase match)",
            )
        if name == "export":
            p.add_argument("-o", "--out", default="trace.json", help="output path")
            p.add_argument(
                "--splice-xla",
                action="store_true",
                help="splice the profiler traces (each span's xla_trace_dir) "
                "into the same file, time-shifted onto the span clock",
            )
    rp = sub.add_parser(
        "regress",
        help="diff two runs/bench records; exit nonzero on regressions",
    )
    rp.add_argument(
        "targets",
        nargs="*",
        help="BASELINE CURRENT (run dirs, summary --json files, or bench "
        "records); with --against, just CURRENT",
    )
    rp.add_argument(
        "--against",
        default=None,
        metavar="BASELINE",
        help="baseline snapshot (e.g. a previous BENCH_r0*.json)",
    )
    rp.add_argument(
        "--max-growth",
        type=float,
        default=None,
        metavar="FRAC",
        help="phase-duration growth (and bench value drop) threshold as a "
        "fraction (default 0.25)",
    )
    rp.add_argument("--json", action="store_true", help="machine-readable output")

    runp = sub.add_parser(
        "runs",
        help="build/refresh the feature-store index and print the row table",
    )
    runp.add_argument(
        "roots",
        nargs="*",
        help="directories/files to index (obs run dirs, BENCH_r*.json, "
        "HOST_PHASE.json, MULTICHIP_r*.json); default: the working dir",
    )
    runp.add_argument(
        "--index",
        default=None,
        metavar="DIR",
        help="index directory (default: $TIP_OBS_INDEX or $TIP_ASSETS/obs/index)",
    )
    runp.add_argument(
        "--no-refresh",
        action="store_true",
        help="query the existing index without re-walking the sources",
    )
    runp.add_argument(
        "--limit",
        type=int,
        default=None,
        metavar="N",
        help="only print the newest N rows",
    )
    runp.add_argument("--json", action="store_true", help="machine-readable output")

    pp = sub.add_parser(
        "predict",
        help="estimate study wall-clock from the cost model over the index",
    )
    pp.add_argument(
        "--phases",
        required=True,
        metavar="A,B,...",
        help="comma-separated phase names the study will run",
    )
    pp.add_argument(
        "--runs", type=int, default=100, metavar="N",
        help="runs per case study (default 100, the paper's study size)",
    )
    pp.add_argument(
        "--case-studies", type=int, default=1, metavar="N",
        help="number of case studies (default 1)",
    )
    pp.add_argument(
        "--workers", type=int, default=1, metavar="N",
        help="parallel workers (ideal packing; default 1)",
    )
    pp.add_argument(
        "--platform", default=None, metavar="NAME",
        help="target backend feature (cpu, or default for the card)",
    )
    pp.add_argument(
        "--batch", type=float, default=None, metavar="N",
        help="batch-size feature for the fit",
    )
    pp.add_argument(
        "--group", type=int, default=None, metavar="G",
        help="cross-run dispatch-fusion group size feature "
        "(TIP_CHAIN_GROUP; default 1 = ungrouped)",
    )
    pp.add_argument(
        "--index", default=None, metavar="DIR",
        help="index directory (default: $TIP_OBS_INDEX or $TIP_ASSETS/obs/index)",
    )
    pp.add_argument("--json", action="store_true", help="machine-readable output")

    tp = sub.add_parser(
        "trend",
        help="gate the last snapshot against median/MAD trend bands "
        "(exit 0 ok / 1 regression / 2 bad input / 3 no baseline)",
    )
    tp.add_argument(
        "targets",
        nargs="+",
        help="chronological snapshots, oldest first; the LAST is gated "
        "(run dirs, bench records, BENCH_r*.json, summary --json files)",
    )
    tp.add_argument(
        "--window", type=int, default=None, metavar="K",
        help="non-degraded predecessors forming the baseline (default 5)",
    )
    tp.add_argument(
        "--band", type=float, default=None, metavar="SIGMA",
        help="band half-width in robust sigmas (default 3.0)",
    )
    tp.add_argument(
        "--min-baseline", type=int, default=None, metavar="N",
        help="fewer comparable predecessors than this exits 3 (default 3)",
    )
    tp.add_argument("--json", action="store_true", help="machine-readable output")

    rfp = sub.add_parser(
        "roofline",
        help="per-program MFU / bandwidth table with compute-bound vs "
        "HBM-bound verdicts (devicemeter; exit 3 when nothing is graded)",
    )
    rfp.add_argument(
        "targets",
        nargs="+",
        help="MFU_BREAKDOWN.json captures and/or obs run dirs / "
        "events-*.jsonl streams",
    )
    rfp.add_argument("--json", action="store_true", help="machine-readable output")

    tailp = sub.add_parser(
        "tail",
        help="merged live tail of a run's event streams (obs v4)",
    )
    tailp.add_argument("target", nargs="+", help="run directory or .jsonl files")
    tailp.add_argument(
        "-f", "--follow", action="store_true",
        help="keep polling for appended events (live mode)",
    )
    tailp.add_argument(
        "--poll", type=float, default=0.5, metavar="S",
        help="follow-mode poll interval in seconds (default 0.5)",
    )
    tailp.add_argument(
        "--duration", type=float, default=None, metavar="S",
        help="stop following after S seconds (default: a day)",
    )
    tailp.add_argument(
        "--max-events", type=int, default=None, metavar="N",
        help="stop after printing N events",
    )

    topp = sub.add_parser(
        "top",
        help="refreshing phase-progress / queue-depth / badge-fill table",
    )
    topp.add_argument("target", nargs="+", help="run directory or .jsonl files")
    topp.add_argument(
        "--refresh", type=float, default=2.0, metavar="S",
        help="refresh interval in seconds (default 2)",
    )
    topp.add_argument(
        "--iterations", type=int, default=None, metavar="N",
        help="render N refreshes then exit (default: until Ctrl-C)",
    )
    topp.add_argument(
        "--once", action="store_true", help="one-shot render (CI/tests)"
    )

    alp = sub.add_parser(
        "alerts",
        help="per-rule alert states + burn rates from the evaluator's "
        "state file (exit 0 quiet / 1 firing / 2 corrupt / 3 no state)",
    )
    alp.add_argument(
        "--state", default=None, metavar="DIR",
        help="alert-state directory (default: $TIP_ALERT_STATE or "
        "$TIP_ASSETS/obs/alerts)",
    )
    alp.add_argument("--json", action="store_true", help="machine-readable output")

    inp = sub.add_parser(
        "incidents",
        help="the incident timeline: open + closed incident records "
        "(exit 0 closed-only / 1 open / 2 corrupt / 3 none)",
    )
    inp.add_argument(
        "--state", default=None, metavar="DIR",
        help="alert-state directory (default: $TIP_ALERT_STATE or "
        "$TIP_ASSETS/obs/alerts)",
    )
    inp.add_argument(
        "--limit", type=int, default=None, metavar="N",
        help="only the newest N closed incidents",
    )
    inp.add_argument("--json", action="store_true", help="machine-readable output")

    audp = sub.add_parser(
        "audit",
        help="grade predicted_s vs actual_s across a run's phase spans; "
        "emit per-phase error rows (exit 3 when nothing carries a pair)",
    )
    audp.add_argument(
        "targets", nargs="+", help="run directories or .jsonl files"
    )
    audp.add_argument(
        "--index", default=None, metavar="DIR",
        help="also refresh these targets into the feature-store index "
        "(emits the audit.* error rows)",
    )
    audp.add_argument(
        "--json", action="store_true",
        help="emit the trend-gateable audit snapshot document",
    )

    args = ap.parse_args(argv)

    if args.command in ("alerts", "incidents"):
        from simple_tip_tpu_torch.obs import alerts as alerts_mod

        if args.command == "alerts":
            return alerts_mod.cli_alerts(args.state, as_json=args.json)
        return alerts_mod.cli_incidents(
            args.state, as_json=args.json, limit=args.limit
        )

    if args.command in ("tail", "top", "audit"):
        from simple_tip_tpu_torch.obs import live as live_mod

        if args.command == "tail":
            return live_mod.tail(
                args.target, follow=args.follow, poll_s=args.poll,
                duration_s=args.duration, max_events=args.max_events,
            )
        if args.command == "top":
            iterations = 1 if args.once else args.iterations
            return live_mod.top(
                args.target, refresh_s=args.refresh, iterations=iterations
            )
        return live_mod.audit(
            args.targets, index=args.index, as_json=args.json
        )

    if args.command == "regress":
        return _regress(args)
    if args.command == "runs":
        return _runs(args)
    if args.command == "predict":
        return _predict(args)
    if args.command == "trend":
        return _trend(args)
    if args.command == "roofline":
        return _roofline(args)

    events, files, bad = load_events(args.target)
    if args.command == "summary":
        if args.phase:
            events = filter_phase(events, args.phase)
        if args.json:
            print(
                json.dumps(
                    {
                        "files": [os.path.basename(f) for f in files],
                        "bad_lines": bad,
                        "spans": {
                            n: {"count": c, "total_s": t, "max_s": m}
                            for n, (c, t, m) in sorted(_span_table(events).items())
                        },
                        "counters": _summed_counters(events),
                    },
                    indent=2,
                    sort_keys=True,
                )
            )
        else:
            print(summarize(events, files, bad))
        return 0
    if args.command == "export":
        doc = to_chrome_trace(events)
        if args.splice_xla:
            from simple_tip_tpu_torch.obs import splice as splice_mod

            tss = [
                r["ts"] for r in events if isinstance(r.get("ts"), (int, float))
            ]
            spliced, report = splice_mod.splice(events, min(tss) if tss else 0.0)
            doc["traceEvents"].extend(spliced)
            for line in report:
                print(f"splice: {line}", file=sys.stderr)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        print(
            f"wrote {args.out}: {len(doc['traceEvents'])} trace events from "
            f"{len(files)} files ({bad} bad lines skipped); open in "
            "https://ui.perfetto.dev or chrome://tracing"
        )
        return 0
    problems = check(events, files, bad)
    if problems:
        for p in problems:
            print(f"obs check: {p}", file=sys.stderr)
        return 1
    print(
        f"obs check OK: {len(files)} files, {len(events)} events, "
        f"{bad} torn lines skipped"
    )
    return 0
