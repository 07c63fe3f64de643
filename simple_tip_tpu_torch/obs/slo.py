"""SLO rule documents + burn-rate math (obs v5's declarative half).

The telemetry plane records everything (spans, /metrics, trend gates, MFU
floors) but nothing *watches* it live — a serving p99 blowout or a fleet
losing members is only caught when a human runs ``obs trend`` after the
fact. This module is the declarative half of the alerting layer: a
schema-stamped rule document declaring objectives over the metric
families the last four obs PRs already emit, each with an error budget
and multi-window multi-burn-rate thresholds (Google SRE style: a
fast-burn page on a short window, a slow-burn warn on a long one). The
procedural half — the state machine, persistence, sinks and incidents —
lives in ``obs/alerts.py``.

Rule document resolution (``load_rules``):

- ``TIP_ALERT_RULES`` unset/empty: ``$TIP_ASSETS/obs/slo_rules.json`` if
  it exists, else alerting is OFF (the TIP_OBS_DIR no-op contract);
- ``TIP_ALERT_RULES=0|off``: explicitly OFF;
- ``TIP_ALERT_RULES=builtin``: the bundled :data:`DEFAULT_RULES` covering
  serving p99 / shed rate / fleet members-alive / breaker state /
  scheduler churn / MFU floors / cost-model drift;
- ``TIP_ALERT_RULES={...}`` inline JSON, or ``@/path`` / ``/path`` a file.

A document must carry ``"schema": 1`` (the stamp every obs JSONL writer
carries); individual rules that fail validation are dropped loudly, never
fatally — a typo'd rule must not take down the host it is watching.

Objective kinds (each states the GOOD condition; a tick's sample is
``bad`` when it fails):

- ``quantile``       a registry Quantile percentile vs a bound
                     (``serving.request_ms`` p99 <= 500 ms);
- ``gauge``          a registry gauge vs a bound (``breaker.open`` <= 0,
                     ``fleet.members_alive`` >= 1, ``mfu.*`` floors);
- ``ratio``          an error-rate between counter deltas (shed rate =
                     d(serving.shed) / d(serving.rows + serving.shed)) —
                     the sample's bad fraction IS the rate;
- ``counter_delta``  counters that must not move (scheduler.requeues +
                     scheduler.worker_deaths);
- ``index``          a cross-process feature-store aggregate (``audit.*``
                     prediction error, ``mfu.*`` rows) — the evaluator
                     feeds rows from ``obs/store.py``.

Burn rate (:func:`burn_rate`) = (mean bad fraction over a window) /
(error budget): burn 1.0 spends the budget exactly; the fast window pages
at a high multiple (default 14.4, the SRE 2%-of-monthly-budget-in-an-hour
rate), the slow window warns at a low one. The fast window doubles as the
Google short-window: recovery drains it quickly, so pages stop soon after
the condition clears.

Stdlib-only, like the rest of obs: it imports without torch or numpy,
on hosts with no card.
"""

import json
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

#: Stamp on every rule document (and on the alert-state/transition records
#: downstream): readers skip documents whose stamp they do not understand.
SCHEMA = 1

#: Env override for the rule document (see module docstring for grammar).
RULES_ENV = "TIP_ALERT_RULES"

OPS = ("<=", ">=", "<", ">")
KINDS = ("quantile", "gauge", "ratio", "counter_delta", "index")
SEVERITIES = ("page", "warn")

#: Default multi-window thresholds (Google SRE table 6-2 shape): the fast
#: pair pages, the slow pair warns.
_DEFAULT_WINDOWS = {
    "fast": {"window_s": 300.0, "burn": 14.4},
    "slow": {"window_s": 3600.0, "burn": 3.0},
}


def default_rules_path() -> str:
    """The standing rule document: ``$TIP_ASSETS/obs/slo_rules.json``."""
    assets = os.environ.get("TIP_ASSETS", os.path.join(os.getcwd(), "assets"))
    return os.path.join(os.path.abspath(assets), "obs", "slo_rules.json")


#: The bundled rule set (``TIP_ALERT_RULES=builtin``): one objective per
#: metric family the ROADMAP's SLO item names. Budgets/thresholds are
#: deliberately loose defaults — a deployment pins its own document.
DEFAULT_RULES = {
    "schema": SCHEMA,
    "rules": [
        {
            "name": "serving-p99-latency",
            "severity": "page",
            "objective": {
                "kind": "quantile", "metric": "serving.request_ms",
                "field": "p99", "op": "<=", "threshold": 500.0,
            },
            "budget": 0.02,
            "for_s": 60.0,
        },
        {
            "name": "serving-shed-rate",
            "severity": "page",
            "objective": {
                "kind": "ratio", "num": "serving.shed",
                "den": ["serving.rows", "serving.shed"],
            },
            "budget": 0.05,
            "for_s": 60.0,
        },
        {
            "name": "fleet-members-alive",
            "severity": "page",
            "objective": {
                "kind": "gauge", "metric": "fleet.members_alive",
                "op": ">=", "threshold": 1.0,
            },
            "budget": 0.05,
            "for_s": 30.0,
        },
        {
            "name": "breaker-open",
            "severity": "page",
            "objective": {
                "kind": "gauge", "metric": "breaker.open",
                "op": "<=", "threshold": 0.0,
            },
            "budget": 0.05,
            "for_s": 30.0,
        },
        {
            "name": "scheduler-churn",
            "severity": "warn",
            "objective": {
                "kind": "counter_delta",
                "metrics": ["scheduler.requeues", "scheduler.worker_deaths"],
                "threshold": 0.0,
            },
            "budget": 0.1,
        },
        {
            "name": "mfu-floor",
            "severity": "warn",
            "objective": {
                "kind": "index", "phase_prefix": "mfu.",
                "op": ">=", "threshold": 0.02, "agg": "mean",
            },
            "budget": 0.25,
        },
        {
            "name": "cost-model-drift",
            "severity": "warn",
            "objective": {
                "kind": "index", "phase_prefix": "audit.",
                "op": "<=", "threshold": 60.0, "agg": "mean",
            },
            "budget": 0.25,
        },
    ],
}


def rules_configured() -> bool:
    """Whether alerting is ON for this process (the no-op contract gate).

    True when ``TIP_ALERT_RULES`` names a source, or the standing
    ``$TIP_ASSETS/obs/slo_rules.json`` exists. One env read and at most
    one stat — cheap enough for every owner-loop tick.
    """
    raw = os.environ.get(RULES_ENV, "").strip()
    if raw.lower() in ("0", "off"):
        return False
    if raw:
        return True
    return os.path.isfile(default_rules_path())


def load_rules(raw: Optional[str] = None) -> Optional[dict]:
    """Resolve + validate the rule document; None when alerting is off.

    Failure-safe end to end: an unreadable file, corrupt JSON, a missing
    schema stamp, or a document with zero valid rules all log a warning
    and return None — a bad rule document must never crash the process
    it is supposed to watch.
    """
    if raw is None:
        raw = os.environ.get(RULES_ENV, "").strip()
    source = None
    if raw.lower() in ("0", "off"):
        return None
    if not raw:
        path = default_rules_path()
        if not os.path.isfile(path):
            return None
        raw, source = "@" + path, path
    if raw.lower() in ("builtin", "default"):
        doc, source = DEFAULT_RULES, "builtin"
    elif raw.lstrip().startswith("{"):
        source = "inline"
        try:
            doc = json.loads(raw)
        except ValueError as e:
            logger.warning("%s: inline rules are not JSON: %s", RULES_ENV, e)
            return None
    else:
        path = raw[1:] if raw.startswith("@") else raw
        source = source or path
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            logger.warning("%s: cannot read rules %s: %s", RULES_ENV, path, e)
            return None
    if not isinstance(doc, dict) or doc.get("schema") != SCHEMA:
        logger.warning(
            "%s (%s): rule document must carry \"schema\": %d",
            RULES_ENV, source, SCHEMA,
        )
        return None
    rules, problems = validate(doc.get("rules"))
    for p in problems:
        logger.warning("%s (%s): %s", RULES_ENV, source, p)
    if not rules:
        logger.warning("%s (%s): no valid rules; alerting off", RULES_ENV, source)
        return None
    return {"schema": SCHEMA, "source": str(source), "rules": rules}


def _num(v, default=None) -> Optional[float]:
    """``v`` as a float, or ``default`` (bools are not numbers here)."""
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return default
    return float(v)


def _norm_windows(spec) -> Optional[dict]:
    """Normalize a rule's window pair; None on an invalid spec."""
    spec = spec if isinstance(spec, dict) else {}
    out = {}
    for key in ("fast", "slow"):
        w = spec.get(key)
        w = w if isinstance(w, dict) else {}
        window_s = _num(w.get("window_s"), _DEFAULT_WINDOWS[key]["window_s"])
        burn = _num(w.get("burn"), _DEFAULT_WINDOWS[key]["burn"])
        if window_s is None or window_s <= 0 or burn is None or burn <= 0:
            return None
        out[key] = {"window_s": float(window_s), "burn": float(burn)}
    return out


def _norm_objective(obj) -> Tuple[Optional[dict], str]:
    """Normalize one objective dict; ``(None, reason)`` when invalid."""
    if not isinstance(obj, dict):
        return None, "objective must be a dict"
    kind = obj.get("kind")
    if kind not in KINDS:
        return None, f"unknown objective kind {kind!r} (known: {KINDS})"
    if kind in ("quantile", "gauge"):
        metric = obj.get("metric")
        threshold = _num(obj.get("threshold"))
        op = obj.get("op", "<=")
        if not metric or threshold is None or op not in OPS:
            return None, f"{kind} objective needs metric/op/threshold"
        out = {"kind": kind, "metric": str(metric), "op": op,
               "threshold": threshold}
        if kind == "quantile":
            field = obj.get("field", "p99")
            if field not in ("p50", "p95", "p99"):
                return None, f"quantile field must be p50/p95/p99, got {field!r}"
            out["field"] = field
        return out, ""
    if kind == "ratio":
        num = obj.get("num")
        den = obj.get("den") or ([num] if num else None)
        if not num or not isinstance(den, (list, tuple)) or not den:
            return None, "ratio objective needs num + den counter names"
        return {"kind": kind, "num": str(num),
                "den": [str(d) for d in den]}, ""
    if kind == "counter_delta":
        metrics = obj.get("metrics") or obj.get("metric")
        if isinstance(metrics, str):
            metrics = [metrics]
        if not isinstance(metrics, (list, tuple)) or not metrics:
            return None, "counter_delta objective needs metrics"
        return {"kind": kind, "metrics": [str(m) for m in metrics],
                "threshold": _num(obj.get("threshold"), 0.0)}, ""
    # index: a cross-process feature-store aggregate
    prefix = obj.get("phase_prefix")
    threshold = _num(obj.get("threshold"))
    op = obj.get("op", "<=")
    agg = obj.get("agg", "mean")
    if not prefix or threshold is None or op not in OPS:
        return None, "index objective needs phase_prefix/op/threshold"
    if agg not in ("mean", "max", "min", "last"):
        return None, f"index agg must be mean/max/min/last, got {agg!r}"
    return {"kind": kind, "phase_prefix": str(prefix), "op": op,
            "threshold": threshold, "agg": agg}, ""


def validate(rules) -> Tuple[List[dict], List[str]]:
    """Normalize a rule list; ``(valid_rules, problem_strings)``.

    Bad rules are dropped and described, valid siblings survive — the
    partial-tolerance contract every obs reader follows.
    """
    out: List[dict] = []
    problems: List[str] = []
    seen = set()
    for i, rule in enumerate(rules if isinstance(rules, list) else []):
        label = f"rule[{i}]"
        if not isinstance(rule, dict):
            problems.append(f"{label}: not a dict")
            continue
        name = rule.get("name")
        if not name or not isinstance(name, str):
            problems.append(f"{label}: missing name")
            continue
        label = f"rule {name!r}"
        if name in seen:
            problems.append(f"{label}: duplicate name")
            continue
        obj, reason = _norm_objective(rule.get("objective"))
        if obj is None:
            problems.append(f"{label}: {reason}")
            continue
        budget = _num(rule.get("budget"))
        if budget is None or not 0.0 < budget <= 1.0:
            problems.append(f"{label}: budget must be in (0, 1]")
            continue
        windows = _norm_windows(rule.get("windows"))
        if windows is None:
            problems.append(f"{label}: windows need positive window_s + burn")
            continue
        severity = rule.get("severity", "page")
        if severity not in SEVERITIES:
            problems.append(f"{label}: severity must be page|warn")
            continue
        for_s = _num(rule.get("for_s"), 0.0)
        seen.add(name)
        out.append(
            {
                "name": name,
                "severity": severity,
                "objective": obj,
                "budget": budget,
                "windows": windows,
                "for_s": max(0.0, for_s),
            }
        )
    return out, problems


# -- sampling + burn math --------------------------------------------------


def _good(value: float, op: str, threshold: float) -> bool:
    """Whether ``value`` satisfies the objective's good condition."""
    if op == "<=":
        return value <= threshold
    if op == ">=":
        return value >= threshold
    if op == "<":
        return value < threshold
    return value > threshold


def sample_rule(
    rule: dict,
    snap: dict,
    prev_counters: Optional[dict] = None,
    index_rows: Optional[Sequence[dict]] = None,
) -> Optional[dict]:
    """One evaluation tick of ``rule`` against a metrics snapshot.

    Returns ``{"value": float, "bad": 0.0..1.0}`` — ``bad`` is the tick's
    error fraction (a hard breach is 1.0; a ``ratio`` objective's bad IS
    the observed rate) — or None when the rule has no data this tick (a
    quantile never observed, a counter pair that didn't move, an empty
    index): no sample, no budget spent, no alert.
    """
    obj = rule["objective"]
    kind = obj["kind"]
    if kind == "quantile":
        fam = (snap.get("quantiles") or {}).get(obj["metric"])
        v = _num(fam.get(obj["field"])) if isinstance(fam, dict) else None
        if v is None:
            return None
        return {"value": v,
                "bad": 0.0 if _good(v, obj["op"], obj["threshold"]) else 1.0}
    if kind == "gauge":
        v = _num((snap.get("gauges") or {}).get(obj["metric"]))
        if v is None:
            return None
        return {"value": v,
                "bad": 0.0 if _good(v, obj["op"], obj["threshold"]) else 1.0}
    cur = snap.get("counters") or {}
    if kind == "ratio":
        if prev_counters is None:
            return None  # first tick: no delta window yet
        num_d = max(0.0, _num(cur.get(obj["num"]), 0.0)
                    - _num(prev_counters.get(obj["num"]), 0.0))
        den_d = sum(
            max(0.0, _num(cur.get(d), 0.0) - _num(prev_counters.get(d), 0.0))
            for d in obj["den"]
        )
        if den_d <= 0:
            return None  # no traffic between ticks: nothing to grade
        frac = max(0.0, min(1.0, num_d / den_d))
        return {"value": frac, "bad": frac}
    if kind == "counter_delta":
        if prev_counters is None:
            return None
        delta = sum(
            max(0.0, _num(cur.get(m), 0.0) - _num(prev_counters.get(m), 0.0))
            for m in obj["metrics"]
        )
        return {"value": delta,
                "bad": 0.0 if delta <= obj["threshold"] else 1.0}
    # index: newest cross-process rows under the phase prefix
    vals = []
    for row in index_rows or []:
        phase = str(row.get("phase") or "")
        if not phase.startswith(obj["phase_prefix"]):
            continue
        v = _num(row.get("value"))
        if v is None:
            v = _num(row.get("seconds"))
        if v is not None:
            vals.append(v)
    if not vals:
        return None
    if obj["agg"] == "mean":
        v = sum(vals) / len(vals)
    elif obj["agg"] == "max":
        v = max(vals)
    elif obj["agg"] == "min":
        v = min(vals)
    else:
        v = vals[-1]
    return {"value": v,
            "bad": 0.0 if _good(v, obj["op"], obj["threshold"]) else 1.0}


def burn_rate(
    samples: Sequence[Sequence[float]],
    now: float,
    window_s: float,
    budget: float,
) -> Optional[float]:
    """Budget burn over the trailing window: mean(bad) / budget.

    ``samples`` is the rule's ``[ts, bad]`` ring (ts-ascending). None when
    the window holds no samples — an idle rule burns nothing. Burn 1.0
    spends the error budget exactly as fast as it accrues; the thresholds
    in the rule's window pair are multiples of that.
    """
    lo = now - window_s
    window = [s[1] for s in samples if s[0] > lo and s[0] <= now]
    if not window:
        return None
    return (sum(window) / len(window)) / budget


def prune_samples(
    samples: List, now: float, keep_s: float, cap: int = 2048
) -> List:
    """Drop samples older than ``keep_s`` (and hard-cap the ring size)."""
    lo = now - keep_s
    out = [s for s in samples if s[0] > lo]
    return out[-cap:]


def write_default_rules(path: Optional[str] = None) -> str:
    """Materialize :data:`DEFAULT_RULES` at ``path`` (atomic); the path.

    The operator bootstrap (RUNBOOK §11): write the bundled document to
    ``$TIP_ASSETS/obs/slo_rules.json``, edit budgets/thresholds in place.
    """
    path = path or default_rules_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(DEFAULT_RULES, f, indent=2, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path
