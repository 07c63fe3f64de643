"""Telemetry feature store: every run's cost features in one queryable index.

Counterpart of the JAX package's ``obs/store.py``, with its row schema and
index layout, so that one index holds both packages' rows. The event
streams carry per-phase durations, device-memory high-water, health
counters and degraded/breaker state; each study's trace sits in its own
``$TIP_ASSETS/obs/<run_ts>`` directory. This module walks those sources
(and bench records, when handed one), normalizes each into **one
schema-versioned feature row per (run, phase)**, and persists the rows as
an append-only JSONL index under ``$TIP_ASSETS/obs/index/`` (override with
``TIP_OBS_INDEX``) with incremental refresh — a source whose (mtime, size)
already matches its manifest entry is skipped, so re-indexing after a study
only pays for the new run.

Row schema (``schema`` is the version stamp; every obs JSONL writer
carries one):

- identity: ``schema``, ``kind`` (``obs_run`` | ``bench`` | ``host_phase``
  | ``multichip`` | ``mfu_breakdown``), ``source`` (path), ``seq``
  (append batch, newest wins),
  ``run`` (model id / round / capture label; None for aggregates),
  ``phase`` (span name / bench metric);
- target: ``seconds`` (what the cost model fits) or ``value`` (bench
  throughput, higher-is-better);
- features: ``count``, ``platform`` (what the stream's meta record
  stamps: ``TIP_OBS_PLATFORM``, ``default`` or ``cpu`` for the port's
  scheduler workers), ``degraded``, ``batch``, ``workers``,
  ``group`` (cross-run dispatch-fusion group size; None on ungrouped
  sources — ``costmodel._features`` treats it as 1),
  ``compiles`` (the JAX package's ``jax.compiles`` counter; the port
  compiles no XLA, so its rows hold None, as a JAX stream without the
  counter does), ``device_peak_bytes``, ``health`` (summed health counters),
  ``case_study``, ``captured`` (epoch seconds when the source states one),
  ``plan`` (the ExecutionPlan id the run executed under, ``"unplanned"``
  when a record says so explicitly, None for sources predating the stamp).

Consumers: ``obs runs`` (the table/JSON reporter in ``obs/cli.py``),
``obs/costmodel.py`` (features → phase seconds), and ``obs trend`` when
gating from the index. Stdlib only: the index is built and queried on
hosts with no card and no torch.
"""

import json
import os
import time

from simple_tip_tpu_torch.obs import regress as _regress

#: Feature-row schema version. Bump when a row's field semantics change;
#: readers skip rows whose stamp they do not understand.
SCHEMA = 1

#: Env var overriding the index directory (default ``$TIP_ASSETS/obs/index``).
INDEX_ENV = "TIP_OBS_INDEX"

#: Span names that are per-run work units: their ``attrs.phase`` is the
#: phase identity and ``attrs.model_id`` the run identity.
_RUN_SPAN = "run"

#: Repo-root record files swept by source discovery, by prefix.
_RECORD_PREFIXES = (
    ("BENCH_r", "bench"),
    ("MULTICHIP_r", "multichip"),
    ("MFU_BREAKDOWN", "mfu_breakdown"),
)


def default_index_dir() -> str:
    """The index directory: ``TIP_OBS_INDEX`` or ``$TIP_ASSETS/obs/index``."""
    raw = os.environ.get(INDEX_ENV, "").strip()
    if raw:
        return os.path.abspath(raw)
    assets = os.environ.get("TIP_ASSETS", os.path.join(os.getcwd(), "assets"))
    return os.path.join(os.path.abspath(assets), "obs", "index")


def _is_obs_run_dir(path: str) -> bool:
    """Whether ``path`` holds at least one ``events-*.jsonl`` stream."""
    try:
        return any(
            n.startswith("events-") and n.endswith(".jsonl")
            for n in os.listdir(path)
        )
    except OSError:
        return False


def _classify_file(path: str):
    """Source kind of a ``.json``/``.jsonl`` file path, or None."""
    name = os.path.basename(path)
    if name.startswith("events-") and name.endswith(".jsonl"):
        return "obs_run"  # a bare stream file: treat its parent as the run
    if not name.endswith(".json"):
        return None
    for prefix, kind in _RECORD_PREFIXES:
        if name.startswith(prefix):
            return kind
    if name == "HOST_PHASE.json":
        return "host_phase"
    # Unprefixed fixture/bench records (tests/fixtures/obs_trend/t01.json,
    # a bare bench line saved to disk) classify by content.
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if isinstance(doc, dict):
        if isinstance(doc.get("parsed"), dict):
            doc = doc["parsed"]
        if doc.get("kind") == "mfu_breakdown":
            return "mfu_breakdown"
        if "metric" in doc and "value" in doc:
            return "bench"
        # Renamed HOST_PHASE captures (trend fixtures, archived
        # trajectories) classify by the same keys regress.load_snapshot
        # dispatches on.
        if "test_prio_s" in doc or "sa_setup" in doc:
            return "host_phase"
    return None


def discover_sources(roots) -> list:
    """``roots`` (dirs/files) -> sorted [(kind, abspath)] of indexable sources.

    A directory is scanned one level deep: obs run dirs (any subdirectory
    holding ``events-*.jsonl``, including the root itself), plus
    ``BENCH_r*.json`` / ``HOST_PHASE.json`` / ``MULTICHIP_r*.json`` /
    ``MFU_BREAKDOWN*.json`` / recognizable bench-record files directly
    inside it. The index directory
    itself is never a source (the store must not eat its own output).
    """
    found = {}
    index_dir = os.path.abspath(default_index_dir())
    for root in roots:
        root = os.path.abspath(root)
        if not os.path.exists(root):
            continue
        if os.path.isfile(root):
            kind = _classify_file(root)
            if kind == "obs_run":
                found[os.path.dirname(root)] = "obs_run"
            elif kind:
                found[root] = kind
            continue
        if _is_obs_run_dir(root):
            found[root] = "obs_run"
        try:
            entries = sorted(os.listdir(root))
        except OSError:
            continue
        for name in entries:
            path = os.path.join(root, name)
            if path == index_dir:
                continue
            if os.path.isdir(path):
                if _is_obs_run_dir(path):
                    found[path] = "obs_run"
                continue
            kind = _classify_file(path)
            if kind and kind != "obs_run":
                found[path] = kind
    return sorted((kind, path) for path, kind in found.items())


def _blank_row(kind: str, source: str, seq: int) -> dict:
    """A feature-row skeleton with every schema field present."""
    return {
        "schema": SCHEMA,
        "kind": kind,
        "source": source,
        "seq": seq,
        "run": None,
        "phase": None,
        "seconds": None,
        "value": None,
        "count": 1,
        "platform": None,
        "degraded": None,
        "batch": None,
        "workers": None,
        "group": None,
        "compiles": None,
        "device_peak_bytes": None,
        "health": None,
        "case_study": None,
        "captured": None,
        "plan": None,
    }


def _health_sum(counters: dict) -> float:
    """Summed health-counter value of a counters dict (regress's list)."""
    return float(
        sum(
            v
            for k, v in (counters or {}).items()
            if isinstance(v, (int, float)) and _regress._is_health_counter(k)
        )
    )


def _rows_from_obs_run(path: str, seq: int) -> list:
    """Feature rows of one obs run directory (span streams)."""
    from simple_tip_tpu_torch.obs.cli import _summed_counters, load_events

    events, files, _bad = load_events(path)
    if not files:
        return []
    counters = _summed_counters(events)
    compiles = counters.get("jax.compiles")
    health = _health_sum(counters)
    degraded = bool(counters.get("breaker.degraded", 0))
    platform_by_pid = {}
    peak = None
    for rec in events:
        if rec.get("type") == "meta" and rec.get("platform"):
            platform_by_pid[rec.get("pid")] = str(rec["platform"])
        if rec.get("type") == "metrics":
            for name, v in (rec.get("gauges") or {}).items():
                if name.endswith(".peak_bytes_in_use") and isinstance(
                    v, (int, float)
                ):
                    peak = max(peak or 0, int(v))

    def stamp(row, ts=None):
        row["compiles"] = compiles
        row["health"] = health
        row["device_peak_bytes"] = peak
        row["captured"] = ts
        if row["degraded"] is None:
            row["degraded"] = degraded
        return row

    rows = []
    agg = {}  # span name -> [count, total] for non-run, non-phase spans
    for rec in events:
        if rec.get("type") != "span":
            continue
        name = str(rec.get("name", "?"))
        dur = float(rec.get("dur", 0) or 0)
        attrs = rec.get("attrs") or {}
        if name == _RUN_SPAN and attrs.get("phase"):
            row = _blank_row("obs_run", path, seq)
            row["run"] = attrs.get("model_id")
            row["phase"] = str(attrs["phase"])
            row["seconds"] = round(dur, 6)
            row["platform"] = platform_by_pid.get(rec.get("pid"))
            row["case_study"] = attrs.get("case_study")
            rows.append(stamp(row, rec.get("ts")))
        elif name == "scheduler.phase" and attrs.get("phase"):
            row = _blank_row("obs_run", path, seq)
            row["phase"] = f"scheduler.{attrs['phase']}"
            row["seconds"] = round(dur, 6)
            row["count"] = attrs.get("runs", 1)
            row["workers"] = attrs.get("workers")
            row["case_study"] = attrs.get("case_study")
            row["plan"] = attrs.get("plan")
            rows.append(stamp(row, rec.get("ts")))
            # Plan-vs-actual audit row (obs v4): when the scheduler stamped
            # a cost-model prediction next to the measured duration, the
            # grading error becomes its own feature — ``seconds`` is the
            # absolute error, ``value`` the signed relative error — so
            # `obs audit`/`obs trend` can gate cost-model drift from the
            # same index that feeds the model.
            pred = attrs.get("predicted_s")
            act = attrs.get("actual_s")
            if isinstance(pred, (int, float)) and isinstance(act, (int, float)):
                arow = _blank_row("obs_run", path, seq)
                arow["phase"] = f"audit.{attrs['phase']}"
                arow["seconds"] = round(abs(float(act) - float(pred)), 6)
                arow["value"] = (
                    round((float(act) - float(pred)) / float(pred), 6)
                    if pred
                    else None
                )
                arow["count"] = attrs.get("runs", 1)
                arow["workers"] = attrs.get("workers")
                arow["case_study"] = attrs.get("case_study")
                rows.append(stamp(arow, rec.get("ts")))
        else:
            # Prio-scoring spans carry a variant attr: split them into
            # per-variant features (sa_score.pc-mlsa, ...) so `obs predict`
            # learns the post-device-pipeline test_prio cost per variant
            # instead of one blended aggregate. Everything else aggregates
            # by bare span name as before.
            if name in ("sa_fit", "sa_score", "sa_cam") and attrs.get("variant"):
                name = f"{name}.{attrs['variant']}"
            cnt, tot = agg.get(name, (0, 0.0))
            agg[name] = (cnt + 1, tot + dur)
    for name, (cnt, tot) in sorted(agg.items()):
        row = _blank_row("obs_run", path, seq)
        row["phase"] = name
        row["seconds"] = round(tot, 6)
        row["count"] = cnt
        rows.append(stamp(row))
    return rows


def _rows_from_bench(path: str, seq: int) -> list:
    """Feature rows of one bench record / ``BENCH_r*.json`` wrapper."""
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return []
    if not isinstance(doc, dict):
        return []
    if isinstance(doc.get("parsed"), dict):
        doc = doc["parsed"]
    if not isinstance(doc, dict) or "value" not in doc:
        return []
    run = os.path.splitext(os.path.basename(path))[0]
    counters = (doc.get("obs_metrics") or {}).get("counters") or {}

    # Device-memory high-water: a bench calls record_device_memory()
    # before snapshotting metrics, so the gauges carry the same
    # ``.peak_bytes_in_use`` series obs run dirs do — parsed here so
    # committed bench records can train the planner's memory model.
    peak = None
    for name, v in ((doc.get("obs_metrics") or {}).get("gauges") or {}).items():
        if name.endswith(".peak_bytes_in_use") and isinstance(v, (int, float)):
            peak = max(peak or 0, int(v))

    def base():
        row = _blank_row("bench", path, seq)
        row["run"] = run
        row["platform"] = doc.get("platform")
        row["degraded"] = bool(doc.get("degraded", False))
        row["batch"] = doc.get("batch")
        row["compiles"] = counters.get("jax.compiles")
        row["health"] = _health_sum(counters)
        row["captured"] = doc.get("captured_unix")
        row["device_peak_bytes"] = peak
        row["plan"] = doc.get("plan")
        return row

    rows = []
    row = base()
    row["phase"] = str(doc.get("metric", "bench.value"))
    try:
        row["value"] = float(doc.get("value") or 0)
    except (TypeError, ValueError):
        row["value"] = 0.0
    rows.append(row)
    sa = doc.get("sa_fit_seconds") or {}
    if isinstance(sa.get("total"), (int, float)):
        row = base()
        row["phase"] = "sa_fit.total"
        row["seconds"] = float(sa["total"])
        rows.append(row)
    for variant, secs in sorted((sa.get("by_variant") or {}).items()):
        if isinstance(secs, (int, float)):
            row = base()
            row["phase"] = f"sa_fit.{variant}"
            row["seconds"] = float(secs)
            rows.append(row)
    if isinstance(doc.get("obs_overhead_seconds"), (int, float)):
        row = base()
        row["phase"] = "obs.overhead_per_1k_spans"
        row["seconds"] = float(doc["obs_overhead_seconds"])
        rows.append(row)
    # Grouped-chain companion: the G sweep becomes group-featured rows —
    # the walk seconds train the cost model's log(group) coefficient
    # (count = G x inputs, so seconds/count is per MODEL-input and the
    # planner's coordinate descent can rank G), and the analytic host
    # bytes/input rides as a value row the trend gate watches (the
    # 68 B/input claim for the 12-metric chain).
    grouped = doc.get("grouped_chain") or {}
    if isinstance(grouped, dict) and "error" not in grouped:
        if isinstance(grouped.get("host_bytes_per_input"), (int, float)):
            row = base()
            row["phase"] = "grouped_chain.host_bytes_per_input"
            row["value"] = float(grouped["host_bytes_per_input"])
            rows.append(row)
        n_inputs = grouped.get("n_inputs")
        for g_label, entry in sorted((grouped.get("sweep") or {}).items()):
            if not isinstance(entry, dict):
                continue
            try:
                g = int(g_label)
            except ValueError:
                continue
            if isinstance(entry.get("walk_seconds"), (int, float)) and \
                    isinstance(n_inputs, (int, float)) and n_inputs > 0:
                row = base()
                row["phase"] = "grouped_chain.walk"
                row["seconds"] = float(entry["walk_seconds"])
                row["count"] = int(g * n_inputs)
                row["group"] = g
                row["batch"] = grouped.get("badge_size") or row["batch"]
                rows.append(row)
            for field in ("inputs_per_sec", "dispatches_per_badge"):
                if isinstance(entry.get(field), (int, float)):
                    row = base()
                    row["phase"] = f"grouped_chain.{field}"
                    row["value"] = float(entry[field])
                    row["group"] = g
                    rows.append(row)
    # Devicemeter companion: the record's headline MFU plus any per-program
    # grades ride as ``mfu.*`` value rows — the cost-analysis features the
    # costmodel corpus can learn utilization terms from.
    if isinstance(doc.get("mfu"), (int, float)) and doc["mfu"] > 0:
        row = base()
        row["phase"] = "mfu"
        row["value"] = float(doc["mfu"])
        rows.append(row)
    for section in ("fused_chain", "grouped_chain"):
        programs = (doc.get(section) or {}).get("device_cost") or {}
        if not isinstance(programs, dict):
            continue
        for prog, graded in sorted(programs.items()):
            if isinstance(graded, dict) and isinstance(
                graded.get("mfu"), (int, float)
            ):
                row = base()
                row["phase"] = f"mfu.{prog}"
                row["value"] = float(graded["mfu"])
                rows.append(row)
    # Serving companion (schema 1): per-arrival-rate SLO features so the
    # learned cost model and the trend gate see the online path.
    serving = doc.get("serving") or {}
    for label, rate in sorted((serving.get("rates") or {}).items()):
        if not isinstance(rate, dict):
            continue
        for field, phase, as_seconds in (
            ("p99_ms", "p99", True),  # ms -> seconds, like every phase row
            ("sustained_inputs_per_s", "sustained_inputs_per_s", False),
            ("badge_fill", "badge_fill", False),
        ):
            v = rate.get(field)
            if not isinstance(v, (int, float)):
                continue
            row = base()
            row["phase"] = f"serving.{phase}.{label}"
            if as_seconds:
                row["seconds"] = float(v) / 1000.0
            else:
                row["value"] = float(v)
            rows.append(row)
    return rows


def _rows_from_host_phase(path: str, seq: int) -> list:
    """Feature rows of a ``HOST_PHASE.json`` capture (plus its history)."""
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return []
    if not isinstance(doc, dict):
        return []
    rows = []

    def add(run, phase, seconds):
        if not isinstance(seconds, (int, float)):
            return
        row = _blank_row("host_phase", path, seq)
        row["run"] = run
        row["phase"] = phase
        row["seconds"] = float(seconds)
        row["platform"] = doc.get("platform")
        rows.append(row)

    add("current", "test_prio", doc.get("test_prio_s"))
    add("current", "train_1epoch", doc.get("train_1epoch_s"))
    for label, hist in sorted((doc.get("history") or {}).items()):
        if not isinstance(hist, dict):
            continue
        tp = hist.get("test_prio_s")
        if isinstance(tp, dict):  # oldest capture nests per-backend numbers
            tp = tp.get("auto_backend_sklearn_on_cpu")
        add(label, "test_prio", tp)
        add(label, "train_1epoch", hist.get("train_1epoch_s"))
    return rows


def _multichip_stamp(doc: dict) -> dict:
    """The ``MULTICHIP_STAMP`` payload the dryrun printed, if any.

    MULTICHIP records are composed by the external driver from the dryrun
    process's exit code and stdout tail, so the degradation/breaker state
    travels as a ``MULTICHIP_STAMP: {json}`` line inside ``tail`` (the
    same at-the-source stamping bench records get directly). ``tail`` may
    be one string or a list of lines; the last parseable stamp wins.
    """
    tail = doc.get("tail")
    lines = []
    if isinstance(tail, str):
        lines = tail.splitlines()
    elif isinstance(tail, (list, tuple)):
        lines = [line for line in tail if isinstance(line, str)]
    stamp = {}
    for line in lines:
        marker = line.find("MULTICHIP_STAMP:")
        if marker < 0:
            continue
        try:
            parsed = json.loads(line[marker + len("MULTICHIP_STAMP:"):])
        except ValueError:
            continue
        if isinstance(parsed, dict):
            stamp = parsed
    return stamp


def _rows_from_multichip(path: str, seq: int) -> list:
    """One summary row per ``MULTICHIP_r*.json`` capture."""
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return []
    if not isinstance(doc, dict):
        return []
    row = _blank_row("multichip", path, seq)
    row["run"] = os.path.splitext(os.path.basename(path))[0]
    row["phase"] = "multichip.capture"
    row["count"] = doc.get("n_devices", 1)
    # Degraded iff the capture failed OR the dryrun stamped a degradation
    # (CPU fallback, open breaker) — stamps ride ``tail`` (see above), but
    # explicit top-level keys from a newer driver win over the parse.
    stamp = _multichip_stamp(doc)
    reason = doc.get("degraded_reason", stamp.get("degraded_reason"))
    breaker = doc.get("breaker", stamp.get("breaker"))
    breaker_open = isinstance(breaker, dict) and breaker.get("state") == "open"
    row["degraded"] = (
        not bool(doc.get("ok", False))
        or bool(stamp.get("degraded"))
        or bool(reason)
        or breaker_open
    )
    return [row]


def _rows_from_mfu_breakdown(path: str, seq: int) -> list:
    """Feature rows of one ``MFU_BREAKDOWN.json`` device-cost capture:
    one ``mfu.<program>`` value row (the trend-gated floor feature) plus
    one ``dispatch.<program>`` seconds row per graded program. Grouped
    G-sweep entries carry their ``models_per_dispatch`` as ``group``."""
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return []
    if not isinstance(doc, dict) or doc.get("kind") != "mfu_breakdown":
        return []
    run = os.path.splitext(os.path.basename(path))[0]
    rows = []

    def base():
        row = _blank_row("mfu_breakdown", path, seq)
        row["run"] = run
        row["platform"] = doc.get("platform")
        row["degraded"] = bool(doc.get("degraded", False))
        row["captured"] = doc.get("captured_unix")
        return row

    for prog, entry in sorted((doc.get("programs") or {}).items()):
        if not isinstance(entry, dict):
            continue
        graded = entry.get("grade") or {}
        cost = entry.get("cost") or {}
        group = entry.get("models_per_dispatch")
        dispatch = entry.get("dispatch_s") or {}
        if isinstance(graded.get("mfu"), (int, float)):
            row = base()
            row["phase"] = f"mfu.{prog}"
            row["value"] = float(graded["mfu"])
            row["group"] = group
            if isinstance(cost.get("peak_memory_bytes"), (int, float)):
                row["device_peak_bytes"] = int(cost["peak_memory_bytes"])
            rows.append(row)
        p50 = dispatch.get("p50", dispatch.get("mean"))
        if isinstance(p50, (int, float)):
            row = base()
            row["phase"] = f"dispatch.{prog}"
            row["seconds"] = float(p50)
            row["count"] = dispatch.get("count", 1)
            row["group"] = group
            rows.append(row)
    return rows


_NORMALIZERS = {
    "obs_run": _rows_from_obs_run,
    "bench": _rows_from_bench,
    "host_phase": _rows_from_host_phase,
    "multichip": _rows_from_multichip,
    "mfu_breakdown": _rows_from_mfu_breakdown,
}


def _source_stat(kind: str, path: str):
    """Change-detection fingerprint of a source: (mtime, size).

    For run directories the newest stream's mtime and the summed stream
    size stand in, so an appended event re-triggers normalization.
    """
    try:
        if kind == "obs_run":
            mtime, size = 0.0, 0
            for n in os.listdir(path):
                if n.startswith("events-") and n.endswith(".jsonl"):
                    st = os.stat(os.path.join(path, n))
                    mtime = max(mtime, st.st_mtime)
                    size += st.st_size
            return round(mtime, 6), size
        st = os.stat(path)
        return round(st.st_mtime, 6), st.st_size
    except OSError:
        return None


def _index_paths(index_dir: str):
    """(rows JSONL path, manifest path) of ``index_dir``."""
    return (
        os.path.join(index_dir, "index.jsonl"),
        os.path.join(index_dir, "manifest.json"),
    )


def _load_manifest(manifest_path: str) -> dict:
    """The manifest document, or a fresh skeleton when absent/corrupt."""
    try:
        with open(manifest_path, encoding="utf-8") as f:
            doc = json.load(f)
        if isinstance(doc, dict) and isinstance(doc.get("sources"), dict):
            return doc
    except (OSError, ValueError):
        pass
    return {"schema": SCHEMA, "next_seq": 1, "sources": {}}


def refresh(roots, index_dir=None) -> dict:
    """Incrementally (re)index ``roots`` into ``index_dir``.

    Appends one batch of rows per new-or-changed source (the JSONL is
    append-only: a changed source gets fresh rows under a higher ``seq``
    and readers keep only the newest batch per source). Returns the
    refresh report: ``{index, sources, indexed, skipped, rows_appended,
    rows_total}``.
    """
    index_dir = os.path.abspath(index_dir or default_index_dir())
    rows_path, manifest_path = _index_paths(index_dir)
    os.makedirs(index_dir, exist_ok=True)
    manifest = _load_manifest(manifest_path)
    sources = discover_sources(roots)
    indexed, skipped, appended = [], 0, 0
    with open(rows_path, "a", encoding="utf-8") as f:
        for kind, path in sources:
            stat = _source_stat(kind, path)
            if stat is None:
                continue
            entry = manifest["sources"].get(path)
            if entry and entry.get("stat") == list(stat):
                skipped += 1
                continue
            seq = int(manifest.get("next_seq", 1))
            rows = _NORMALIZERS[kind](path, seq)
            for row in rows:
                f.write(json.dumps(row, sort_keys=True) + "\n")
            f.flush()
            appended += len(rows)
            manifest["next_seq"] = seq + 1
            manifest["sources"][path] = {
                "kind": kind,
                "stat": list(stat),
                "rows": len(rows),
                "seq": seq,
                "indexed_unix": round(time.time(), 1),
            }
            indexed.append(path)
    # pid-unique tmp + fsync before the replace: two indexers racing on a
    # shared ".tmp" would publish each other's torn manifest.
    tmp = f"{manifest_path}.{os.getpid()}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, manifest_path)
    return {
        "index": rows_path,
        "sources": len(sources),
        "indexed": indexed,
        "skipped": skipped,
        "rows_appended": appended,
        "rows_total": len(load_rows(index_dir)),
    }


def load_rows(index_dir=None) -> list:
    """The index's live feature rows (newest batch per source, seq-ordered).

    Torn tail lines (a kill mid-append) are skipped, never fatal; rows
    with an unknown ``schema`` stamp are skipped too.
    """
    index_dir = os.path.abspath(index_dir or default_index_dir())
    rows_path, _ = _index_paths(index_dir)
    rows = []
    try:
        with open(rows_path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except ValueError:
                    continue
                if isinstance(row, dict) and row.get("schema") == SCHEMA:
                    rows.append(row)
    except OSError:
        return []
    latest_seq = {}
    for row in rows:
        src = row.get("source")
        latest_seq[src] = max(latest_seq.get(src, 0), int(row.get("seq", 0)))
    live = [r for r in rows if int(r.get("seq", 0)) == latest_seq[r.get("source")]]
    live.sort(key=lambda r: (int(r.get("seq", 0)), str(r.get("phase")), str(r.get("run"))))
    return live


#: ``rows_path -> ((path, mtime_ns, size), rows)``: one cached corpus per
#: index file, invalidated by stat. The planner scores hundreds of
#: candidates and the obs CLI predicts in the same process — both read
#: through here instead of re-walking the JSONL per call.
_corpus_cache: dict = {}


def load_corpus(index_dir=None) -> list:
    """``load_rows`` with a stat-keyed cache (treat the result read-only).

    The planner (``plan/search.py``), ``obs predict`` and
    ``costmodel.quick_phase_estimate`` all share one parse of the index
    per (mtime, size); a ``refresh`` that appends rows changes the stat
    and invalidates naturally. Callers must not mutate the returned list.
    """
    index_dir = os.path.abspath(index_dir or default_index_dir())
    rows_path, _ = _index_paths(index_dir)
    try:
        st = os.stat(rows_path)
    except OSError:
        _corpus_cache.pop(rows_path, None)
        return []
    key = (rows_path, st.st_mtime_ns, st.st_size)
    cached = _corpus_cache.get(rows_path)
    if cached is not None and cached[0] == key:
        return cached[1]
    rows = load_rows(index_dir)
    _corpus_cache[rows_path] = (key, rows)
    return rows


def render_rows(rows, limit=None) -> str:
    """The index as a deterministic text table (the ``obs runs`` reporter)."""
    out = [
        f"  {'kind':<10} {'source':<34} {'run':<10} {'phase':<28} "
        f"{'seconds':>10} {'value':>12} {'platform':>8}  degraded"
    ]
    shown = rows if limit is None else rows[-limit:]
    for r in shown:
        src = os.path.basename(str(r.get("source", "")))[:34]
        secs = r.get("seconds")
        val = r.get("value")
        out.append(
            f"  {str(r.get('kind', '')):<10} {src:<34} "
            f"{str(r.get('run', '-'))[:10]:<10} "
            f"{str(r.get('phase', '-'))[:28]:<28} "
            f"{(f'{secs:.3f}' if isinstance(secs, (int, float)) else '-'):>10} "
            f"{(f'{val:.1f}' if isinstance(val, (int, float)) else '-'):>12} "
            f"{str(r.get('platform') or '-'):>8}  "
            f"{r.get('degraded')}"
        )
    if limit is not None and len(rows) > limit:
        out.append(f"  ... ({len(rows) - limit} earlier rows not shown)")
    out.append(f"  rows: {len(rows)}")
    return "\n".join(out)
