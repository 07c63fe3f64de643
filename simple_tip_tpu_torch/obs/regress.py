"""Cross-run regression detection over traces and bench records (obs v2).

Counterpart of the JAX package's ``obs/regress.py``, with its verdicts and
exit codes. A study emits per-phase wall-clock (obs spans) and health
counters (worker deaths, requeues, cache corruption); ``obs regress
BASELINE CURRENT`` diffs two snapshots per
phase/metric and exits nonzero when the current one regressed.

Accepted snapshot forms (auto-detected, mixable):

- an obs run directory (or ``events-*.jsonl`` files): phases are the span
  table's per-name totals, counters the summed metrics counters;
- a ``summary --json`` document (``{"spans": ..., "counters": ...}``);
- a bench record — a raw bench JSON line or a ``BENCH_r0*.json`` wrapper
  (the record under ``"parsed"``). The repo's ``BENCH_r*.json`` files are
  the JAX package's records of another chip: their format is read when
  one is handed over, and no number in them is the card's;
- an ``MFU_BREAKDOWN.json`` device-cost capture (obs/devicemeter):
  per-program MFUs gate as *floors* (drop-is-bad), per-program p50
  dispatch seconds as phases (growth-is-bad).

Regression rules (thresholds configurable from the CLI):

- a phase whose duration grew more than ``max_growth`` (default 25%) over
  a baseline of at least ``min_seconds`` (noise floor, default 0.05 s);
- a bench headline value that DROPPED more than ``max_growth`` (throughput
  metrics: higher is better);
- any ``degraded`` flip false -> true;
- any growth in a health counter (worker deaths, timeouts, requeues,
  watchdog failures, cache corruption).

obs v3 adds N-run **trend gating** (``trend`` + ``obs trend``): instead of
one noisy pairwise diff, the current snapshot is gated against robust
median/MAD bands computed over the last K comparable — non-degraded —
predecessors. Degraded snapshots never enter a baseline, but a current
degraded flip still regresses. The JAX module's benchmark hooks
(``bench_delta``, ``select_bench_baseline``) are not here: the port has no
benchmark to call them yet.

Stdlib only.
"""

import json
import os
import statistics

#: Counters whose INCREASE between runs is a health regression. Matched as
#: name prefixes so per-device / per-phase suffixes participate. The
#: breaker entries guarantee that an open circuit (the
#: loud form of the CPU degradation) fails regress against a healthy
#: baseline even if the headline value happens to survive.
HEALTH_COUNTERS = (
    "scheduler.worker_deaths",
    "scheduler.timeouts",
    "scheduler.requeues",
    "watchdog.probe_fail",
    "watchdog.probe_timeout",
    "sa_fit_cache.corrupt",
    "cov_stats_cache.corrupt",
    "breaker.opened",
    "breaker.short_circuit",
    "breaker.degraded",
    "retry.giveups",
)

#: Default growth threshold (fraction) past which a phase regressed.
DEFAULT_MAX_GROWTH = 0.25

#: Phases shorter than this (seconds) in the baseline are noise, not signal.
DEFAULT_MIN_SECONDS = 0.05

#: Trend gate: how many comparable predecessors form the baseline window.
DEFAULT_TREND_WINDOW = 5

#: Trend gate: band half-width in robust sigmas (MAD x 1.4826).
DEFAULT_TREND_BAND = 3.0

#: Trend gate: minimum band half-width as a fraction of the median, so a
#: perfectly-flat fixture history (MAD = 0) does not flag ppm-level jitter.
DEFAULT_TREND_REL_FLOOR = 0.10

#: Trend gate: fewer comparable predecessors than this is not a trend —
#: the verdict is ``no_comparable_baseline`` (exit 3), not a pass/fail.
DEFAULT_MIN_BASELINE = 3


def _is_health_counter(name: str) -> bool:
    """Whether counter ``name`` participates in the health comparison."""
    return any(name.startswith(p) for p in HEALTH_COUNTERS)


def _blank_snapshot(kind: str, source: str) -> dict:
    """A zeroed snapshot skeleton.

    ``phases`` gate growth-is-bad (durations, bytes); ``floors`` is the
    mirror for higher-is-better metrics (MFU, utilization fractions):
    a floor regresses when the current value DROPS below the band.
    """
    return {
        "kind": kind,
        "source": source,
        "phases": {},
        "floors": {},
        "counters": {},
        "degraded": None,
        "value": None,
        "plan": None,
    }


def _normalize_bench(doc: dict, source: str) -> dict:
    """A bench record (a raw bench JSON line) as a snapshot."""
    snap = _blank_snapshot("bench", source)
    try:
        snap["value"] = float(doc.get("value") or 0)
    except (TypeError, ValueError):
        snap["value"] = 0.0
    snap["degraded"] = bool(doc.get("degraded", False))
    # ExecutionPlan stamp (simple_tip_tpu_torch.plan): records predating the
    # stamp normalize to "unplanned" — the same value a bench writes when
    # no plan is active — so the trend gate's like-for-like filter keeps
    # the committed history comparable instead of orphaning it.
    snap["plan"] = str(doc.get("plan") or "unplanned")
    counters = (doc.get("obs_metrics") or {}).get("counters") or {}
    snap["counters"] = {
        k: v for k, v in counters.items() if isinstance(v, (int, float))
    }
    sa = doc.get("sa_fit_seconds") or {}
    for variant, secs in (sa.get("by_variant") or {}).items():
        if isinstance(secs, (int, float)):
            snap["phases"][f"sa_fit.{variant}"] = float(secs)
    if isinstance(sa.get("total"), (int, float)):
        snap["phases"]["sa_fit.total"] = float(sa["total"])
    # Fused/grouped-chain host-transfer claim: the analytic bytes/input
    # the chain drains to host (68 B for the 12-metric chain) becomes a
    # gated "phase" — growth past the band means someone widened the
    # device->host fan-out, which is exactly the regression the fused
    # chain exists to prevent. Units are bytes, not seconds; the growth
    # gate is unit-agnostic.
    fc = doc.get("fused_chain") or {}
    if isinstance(fc, dict) and isinstance(
        fc.get("host_transfer_bytes_per_input"), (int, float)
    ):
        snap["phases"]["fused_chain.host_bytes_per_input"] = float(
            fc["host_transfer_bytes_per_input"]
        )
    grouped = doc.get("grouped_chain") or {}
    if isinstance(grouped, dict) and isinstance(
        grouped.get("host_bytes_per_input"), (int, float)
    ):
        snap["phases"]["grouped_chain.host_bytes_per_input"] = float(
            grouped["host_bytes_per_input"]
        )
    # Serving companion: p99 per arrival rate becomes a gated phase so a
    # latency regression on the online path fails `obs trend` exactly like
    # a batch-phase slowdown.
    for label, rate in ((doc.get("serving") or {}).get("rates") or {}).items():
        if isinstance(rate, dict) and isinstance(rate.get("p99_ms"), (int, float)):
            snap["phases"][f"serving.p99.{label}"] = float(rate["p99_ms"]) / 1000.0
    # Device-cost observatory: the record's headline MFU (and any
    # per-program MFUs the devicemeter companion graded) gate as FLOORS —
    # a chip-utilization drop fails trend exactly like a p99 growth.
    if isinstance(doc.get("mfu"), (int, float)) and doc["mfu"] > 0:
        snap["floors"]["mfu"] = float(doc["mfu"])
    for section in ("fused_chain", "grouped_chain"):
        programs = (doc.get(section) or {}).get("device_cost") or {}
        if not isinstance(programs, dict):
            continue
        for prog, graded in programs.items():
            if isinstance(graded, dict) and isinstance(
                graded.get("mfu"), (int, float)
            ):
                snap["floors"][f"mfu.{prog}"] = float(graded["mfu"])
    return snap


def _normalize_mfu_breakdown(doc: dict, source: str) -> dict:
    """An ``MFU_BREAKDOWN.json`` capture (obs/devicemeter) as a snapshot:
    per-program MFUs become floors (drop-is-bad), per-program p50 dispatch
    seconds become phases (growth-is-bad), so one healthy-window capture
    series is trend-gated on both axes."""
    snap = _blank_snapshot("mfu_breakdown", source)
    snap["degraded"] = bool(doc.get("degraded", False))
    for name, entry in sorted((doc.get("programs") or {}).items()):
        if not isinstance(entry, dict):
            continue
        graded = entry.get("grade") or {}
        if isinstance(graded.get("mfu"), (int, float)):
            snap["floors"][f"mfu.{name}"] = float(graded["mfu"])
        dispatch = entry.get("dispatch_s") or {}
        p50 = dispatch.get("p50", dispatch.get("mean"))
        if isinstance(p50, (int, float)):
            snap["phases"][f"dispatch.{name}"] = float(p50)
    return snap


def _normalize_host_phase(doc: dict, source: str) -> dict:
    """A ``HOST_PHASE.json`` capture (the JAX package's host-phase record) as a
    snapshot: the headline host-phase durations become phases so `obs
    trend` can gate the test-prio trajectory the same way it gates bench
    fixtures."""
    snap = _blank_snapshot("host_phase", source)
    for key, phase in (
        ("test_prio_s", "test_prio"),
        ("train_1epoch_s", "train_1epoch"),
    ):
        if isinstance(doc.get(key), (int, float)):
            snap["phases"][phase] = float(doc[key])
    for label, stage in (doc.get("sa_setup") or {}).items():
        if isinstance(stage, dict) and isinstance(
            stage.get("setup_total_s"), (int, float)
        ):
            snap["phases"][f"sa_setup.{label}"] = float(stage["setup_total_s"])
    for label, stage in (doc.get("cov_stats") or {}).items():
        if isinstance(stage, dict) and isinstance(
            stage.get("debit_s"), (int, float)
        ):
            snap["phases"][f"cov_stats.{label}"] = float(stage["debit_s"])
    if "degraded" in doc:
        snap["degraded"] = bool(doc.get("degraded"))
    counters = (doc.get("obs_metrics") or {}).get("counters") or {}
    snap["counters"] = {
        k: v for k, v in counters.items() if isinstance(v, (int, float))
    }
    return snap


def load_snapshot(target) -> dict:
    """Normalize ``target`` into ``{kind, phases, counters, degraded, value}``.

    ``target`` is a path: an obs run dir / ``.jsonl`` file (trace mode), or
    a JSON document (bench record, ``BENCH_r0*.json`` wrapper,
    ``HOST_PHASE.json`` capture, or ``summary --json`` output). Raises
    ``ValueError`` on unrecognizable input — regress must fail loudly, not
    compare garbage.
    """
    snap = _blank_snapshot("trace", str(target))
    if os.path.isdir(target) or str(target).endswith(".jsonl"):
        from simple_tip_tpu_torch.obs.cli import (
            _span_table,
            _summed_counters,
            load_events,
        )

        events, files, _bad = load_events(target)
        if not files:
            raise ValueError(f"{target}: no events-*.jsonl streams found")
        snap["phases"] = {
            name: round(total, 6)
            for name, (_cnt, total, _mx) in _span_table(events).items()
        }
        snap["counters"] = _summed_counters(events)
        return snap

    try:
        with open(target, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        raise ValueError(f"{target}: not a readable JSON document ({e})")
    if not isinstance(doc, dict):
        raise ValueError(f"{target}: expected a JSON object")
    if isinstance(doc.get("parsed"), dict):  # BENCH_r0*.json driver wrapper
        doc = doc["parsed"]

    if doc.get("kind") == "audit" and isinstance(doc.get("phases"), dict):
        # `obs audit --json` document (obs v4): per-phase mean absolute
        # prediction error in seconds, pre-shaped for trend gating — a
        # chronological series of audits fails `obs trend` when the cost
        # model drifts out of its historical error band.
        snap = _blank_snapshot("audit", str(target))
        snap["phases"] = {
            str(k): float(v)
            for k, v in doc["phases"].items()
            if isinstance(v, (int, float))
        }
        counters = doc.get("counters") or {}
        snap["counters"] = {
            k: v for k, v in counters.items() if isinstance(v, (int, float))
        }
        if "degraded" in doc:
            snap["degraded"] = bool(doc.get("degraded"))
        return snap

    if doc.get("kind") == "mfu_breakdown":  # MFU_BREAKDOWN.json capture
        return _normalize_mfu_breakdown(doc, str(target))

    if "metric" in doc and "value" in doc:  # bench record
        return _normalize_bench(doc, str(target))

    if "test_prio_s" in doc or "sa_setup" in doc:  # HOST_PHASE.json capture
        return _normalize_host_phase(doc, str(target))

    if isinstance(doc.get("spans"), dict):  # summary --json document
        snap["phases"] = {
            name: float(info.get("total_s", 0) or 0)
            for name, info in doc["spans"].items()
            if isinstance(info, dict)
        }
        counters = doc.get("counters") or {}
        snap["counters"] = {
            k: v for k, v in counters.items() if isinstance(v, (int, float))
        }
        return snap

    raise ValueError(
        f"{target}: unrecognized snapshot (need an obs run dir, a bench "
        "record / BENCH_r0*.json, or `obs summary --json` output)"
    )


def compare(
    baseline: dict,
    current: dict,
    max_growth: float = DEFAULT_MAX_GROWTH,
    min_seconds: float = DEFAULT_MIN_SECONDS,
) -> dict:
    """Diff two snapshots; returns ``{rows, regressions, ok}``.

    ``rows`` is every compared (kind, name, base, cur, delta) tuple-dict —
    the printable table; ``regressions`` the failing subset.
    """
    rows = []

    def row(kind, name, base, cur, regressed, note=""):
        delta = None
        if isinstance(base, (int, float)) and isinstance(cur, (int, float)) and base:
            delta = (cur - base) / abs(base)
        rows.append(
            {
                "kind": kind,
                "name": name,
                "baseline": base,
                "current": cur,
                "delta": delta,
                "regressed": bool(regressed),
                "note": note,
            }
        )

    for name in sorted(set(baseline["phases"]) | set(current["phases"])):
        base = baseline["phases"].get(name)
        cur = current["phases"].get(name)
        if base is None or cur is None:
            row("phase", name, base, cur, False, "only in one snapshot")
            continue
        if base < min_seconds:
            row("phase", name, base, cur, False, "below noise floor")
            continue
        grew = cur > base * (1.0 + max_growth)
        row(
            "phase", name, base, cur, grew,
            f"> +{max_growth:.0%} growth" if grew else "",
        )

    if baseline["value"] is not None and current["value"] is not None:
        dropped = (
            baseline["value"] > 0
            and current["value"] < baseline["value"] * (1.0 - max_growth)
        )
        row(
            "bench", "value", baseline["value"], current["value"], dropped,
            f"> -{max_growth:.0%} drop" if dropped else "",
        )

    base_floors = baseline.get("floors") or {}
    cur_floors = current.get("floors") or {}
    for name in sorted(set(base_floors) | set(cur_floors)):
        base = base_floors.get(name)
        cur = cur_floors.get(name)
        if base is None or cur is None:
            row("floor", name, base, cur, False, "only in one snapshot")
            continue
        dropped = base > 0 and cur < base * (1.0 - max_growth)
        row(
            "floor", name, base, cur, dropped,
            f"> -{max_growth:.0%} drop" if dropped else "",
        )

    if baseline["degraded"] is not None or current["degraded"] is not None:
        flip = baseline["degraded"] is False and current["degraded"] is True
        row(
            "bench", "degraded", baseline["degraded"], current["degraded"],
            flip, "false -> true flip" if flip else "",
        )

    for name in sorted(set(baseline["counters"]) | set(current["counters"])):
        if not _is_health_counter(name):
            continue
        base = baseline["counters"].get(name, 0)
        cur = current["counters"].get(name, 0)
        row(
            "counter", name, base, cur, cur > base,
            "health counter grew" if cur > base else "",
        )

    regressions = [r for r in rows if r["regressed"]]
    return {"rows": rows, "regressions": regressions, "ok": not regressions}


def render(result: dict, baseline: dict, current: dict) -> str:
    """The comparison as a deterministic text table."""
    out = [
        f"baseline: {baseline['source']} ({baseline['kind']})",
        f"current:  {current['source']} ({current['kind']})",
        "",
        f"  {'kind':<8} {'name':<40} {'baseline':>12} {'current':>12} "
        f"{'delta':>8}  verdict",
    ]

    def fmt(v):
        if isinstance(v, bool) or v is None:
            return str(v)
        if isinstance(v, float):
            return f"{v:.3f}"
        return str(v)

    for r in result["rows"]:
        delta = f"{r['delta']:+.0%}" if r["delta"] is not None else "-"
        verdict = "REGRESSED" if r["regressed"] else "ok"
        if r["note"] and not r["regressed"]:
            verdict = f"ok ({r['note']})"
        elif r["note"]:
            verdict = f"REGRESSED ({r['note']})"
        out.append(
            f"  {r['kind']:<8} {r['name']:<40} {fmt(r['baseline']):>12} "
            f"{fmt(r['current']):>12} {delta:>8}  {verdict}"
        )
    out.append("")
    n = len(result["regressions"])
    out.append(
        "regress OK: no regressions"
        if not n
        else f"regress FAILED: {n} regression(s)"
    )
    return "\n".join(out)


def _band(values, band: float, rel_floor: float):
    """Robust ``(median, half_width)`` of a sample: MAD-sigma band.

    The half-width is ``max(band * 1.4826 * MAD, rel_floor * |median|)`` —
    the relative floor keeps a zero-variance history from flagging noise.
    """
    med = statistics.median(values)
    mad = statistics.median(abs(v - med) for v in values)
    return med, max(band * 1.4826 * mad, rel_floor * abs(med))


def trend(
    snapshots,
    window: int = DEFAULT_TREND_WINDOW,
    band: float = DEFAULT_TREND_BAND,
    rel_floor: float = DEFAULT_TREND_REL_FLOOR,
    min_seconds: float = DEFAULT_MIN_SECONDS,
    min_baseline: int = DEFAULT_MIN_BASELINE,
) -> dict:
    """Gate the LAST snapshot against a trend over its predecessors.

    ``snapshots`` is a chronological list (oldest first) of
    ``load_snapshot`` dicts; the last one is under test. The baseline is
    the last ``window`` NON-DEGRADED predecessors — degraded rows never
    enter a baseline, but a current ``degraded: true`` still regresses
    (flip gate). Per phase/metric the current value is compared against
    robust median/MAD bands (``_band``): durations regress above the upper
    band (if the median clears ``min_seconds``), the bench ``value``
    regresses below the lower band (throughput: higher is better), and a
    health counter regresses above the baseline window's max.

    Returns ``{verdict, ok, rows, regressions, n_baseline, current}`` with
    ``verdict`` one of ``ok`` / ``regression`` / ``no_comparable_baseline``
    (fewer than ``min_baseline`` comparable predecessors — CI exit 3, a
    skip, not a failure).
    """
    if not snapshots:
        return {
            "verdict": "no_comparable_baseline",
            "ok": False,
            "rows": [],
            "regressions": [],
            "n_baseline": 0,
            "current": None,
        }
    current = snapshots[-1]
    comparable = [s for s in snapshots[:-1] if s.get("degraded") is not True]
    # Like-for-like plans only: a record measured under ExecutionPlan A is
    # not a baseline for one measured under plan B (different knob
    # assignments measure different configurations, not drift). Snapshot
    # kinds without a plan stamp (host_phase, audit, obs runs) keep the
    # unfiltered window — their current["plan"] is None.
    if current.get("plan") is not None:
        comparable = [
            s for s in comparable
            if (s.get("plan") or "unplanned") == current["plan"]
        ]
    baseline = comparable[-window:]
    if len(baseline) < min_baseline:
        return {
            "verdict": "no_comparable_baseline",
            "ok": False,
            "rows": [],
            "regressions": [],
            "n_baseline": len(baseline),
            "current": current["source"],
        }

    rows = []

    def row(kind, name, med, half, cur, regressed, note=""):
        rows.append(
            {
                "kind": kind,
                "name": name,
                "median": med,
                "band": half,
                "current": cur,
                "regressed": bool(regressed),
                "note": note,
            }
        )

    for name in sorted(current["phases"]):
        cur = current["phases"][name]
        history = [
            s["phases"][name] for s in baseline if name in s["phases"]
        ]
        if len(history) < min_baseline:
            row("phase", name, None, None, cur, False, "not enough history")
            continue
        med, half = _band(history, band, rel_floor)
        if med < min_seconds:
            row("phase", name, med, half, cur, False, "below noise floor")
            continue
        grew = cur > med + half
        row(
            "phase", name, med, half, cur, grew,
            "above trend band" if grew else "",
        )

    if current["value"] is not None:
        history = [
            s["value"] for s in baseline if isinstance(s["value"], (int, float))
        ]
        if len(history) >= min_baseline:
            med, half = _band(history, band, rel_floor)
            dropped = current["value"] < med - half
            row(
                "bench", "value", med, half, current["value"], dropped,
                "below trend band" if dropped else "",
            )
        else:
            row(
                "bench", "value", None, None, current["value"], False,
                "not enough history",
            )

    # Floors (MFU and friends): drop-is-bad, the mirror of the bench value
    # gate — a utilization collapse on an otherwise-fast run still fails.
    for name in sorted(current.get("floors") or {}):
        cur = current["floors"][name]
        history = [
            (s.get("floors") or {}).get(name) for s in baseline
        ]
        history = [v for v in history if isinstance(v, (int, float))]
        if len(history) < min_baseline:
            row("floor", name, None, None, cur, False, "not enough history")
            continue
        med, half = _band(history, band, rel_floor)
        dropped = cur < med - half
        row(
            "floor", name, med, half, cur, dropped,
            "below trend band" if dropped else "",
        )

    if current["degraded"] is not None:
        flip = current["degraded"] is True
        row(
            "bench", "degraded", False, None, current["degraded"], flip,
            "degraded flip vs non-degraded baseline" if flip else "",
        )

    names = set(current["counters"])
    for s in baseline:
        names |= set(s["counters"])
    for name in sorted(names):
        if not _is_health_counter(name):
            continue
        cur = current["counters"].get(name, 0)
        peak = max((s["counters"].get(name, 0) for s in baseline), default=0)
        row(
            "counter", name, peak, None, cur, cur > peak,
            "above baseline-window max" if cur > peak else "",
        )

    regressions = [r for r in rows if r["regressed"]]
    return {
        "verdict": "regression" if regressions else "ok",
        "ok": not regressions,
        "rows": rows,
        "regressions": regressions,
        "n_baseline": len(baseline),
        "current": current["source"],
    }


def render_trend(result: dict) -> str:
    """A trend verdict as a deterministic text table."""
    if result["verdict"] == "no_comparable_baseline":
        return (
            f"trend SKIPPED: no comparable baseline "
            f"({result['n_baseline']} non-degraded predecessor(s), "
            f"need {DEFAULT_MIN_BASELINE})"
        )
    out = [
        f"current: {result['current']}  "
        f"(baseline: {result['n_baseline']} non-degraded run(s))",
        "",
        f"  {'kind':<8} {'name':<40} {'median':>12} {'band':>10} "
        f"{'current':>12}  verdict",
    ]

    def fmt(v):
        if isinstance(v, bool) or v is None:
            return str(v)
        if isinstance(v, float):
            return f"{v:.3f}"
        return str(v)

    for r in result["rows"]:
        verdict = "REGRESSED" if r["regressed"] else "ok"
        if r["note"]:
            verdict += f" ({r['note']})"
        out.append(
            f"  {r['kind']:<8} {r['name']:<40} {fmt(r['median']):>12} "
            f"{fmt(r['band']):>10} {fmt(r['current']):>12}  {verdict}"
        )
    out.append("")
    n = len(result["regressions"])
    out.append(
        "trend OK: inside the band"
        if not n
        else f"trend FAILED: {n} regression(s) vs trend"
    )
    return "\n".join(out)
