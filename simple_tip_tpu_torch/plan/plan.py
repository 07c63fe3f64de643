"""The versioned ExecutionPlan artifact and its consumer-side readers.

A plan is a schema-stamped JSON document: the chosen knob assignment, the
per-phase predicted seconds the search scored it with, the memory
constraint it was checked against, and a content fingerprint (``plan_id``)
computed over all of that. Two invariants make it a control input rather
than a report:

- **deterministic bytes**: ``to_json`` is canonical (sorted keys, fixed
  indent, no timestamps — the fingerprint covers content only), so the
  same corpus and arguments produce a byte-identical file and CI can
  assert determinism with ``cmp``;
- **failure-safe consumption**: every consumer hook (``active_plan``,
  ``phase_estimate``, ``active_plan_id``) returns None/``"unplanned"`` on
  ANY problem — a missing or corrupt plan file must never block a launch,
  exactly like the advisory cost model it wraps.

Consumers: ``run_scheduler`` (per-phase predicted_s + plan stamp on the
``scheduler.phase`` span), ``full_study.py`` (assignment applied, plan
stamped into the study root span so ``obs audit`` grades plan-vs-actual),
``serving/admission.py`` (cold-start prior), ``parallel/fleet.py``
(straggler speculation) and the alert evaluator (incident stamp).
"""

import hashlib
import json
import os

from simple_tip_tpu_torch.plan import knobs as knobs_mod

#: Plan-document schema version. Bump when field semantics change;
#: ``validate`` rejects stamps it does not understand.
SCHEMA = 1

#: Env var naming the active plan file consumers read.
PLAN_FILE_ENV = "TIP_PLAN_FILE"

#: The plan stamp consumers use when no plan is active.
UNPLANNED = "unplanned"


class PlanError(ValueError):
    """A plan document that fails schema/registry validation."""


def _canonical(doc: dict) -> str:
    """The canonical JSON bytes of ``doc`` (fingerprint + file format)."""
    return json.dumps(doc, indent=1, sort_keys=True) + "\n"


def fingerprint(body: dict) -> str:
    """``ep-<12 hex>`` content fingerprint over a plan body (no plan_id)."""
    digest = hashlib.sha256(
        json.dumps(body, sort_keys=True).encode("utf-8")
    ).hexdigest()
    return f"ep-{digest[:12]}"


def build(assignment: dict, predicted: dict, request: dict,
          memory: dict, search: dict) -> dict:
    """Assemble a validated plan document and stamp its ``plan_id``.

    ``predicted`` is the ``costmodel.predict_study`` result for the chosen
    assignment; ``request`` records what was asked (phases/runs/
    case_studies/platform); ``memory`` the capacity constraint outcome;
    ``search`` the per-knob scores ``plan explain`` renders.
    """
    body = {
        "schema": SCHEMA,
        "assignment": knobs_mod.validate_assignment(assignment),
        "request": dict(request),
        "predicted": dict(predicted),
        "memory": dict(memory),
        "search": dict(search),
    }
    body["plan_id"] = fingerprint(
        {k: v for k, v in body.items() if k != "plan_id"}
    )
    return validate(body)


def validate(doc) -> dict:
    """Schema + knob-registry validation; returns ``doc`` or raises
    :class:`PlanError` naming the offense."""
    if not isinstance(doc, dict):
        raise PlanError("plan document is not a JSON object")
    if doc.get("schema") != SCHEMA:
        raise PlanError(
            f"plan schema {doc.get('schema')!r} not understood "
            f"(this reader speaks schema {SCHEMA})"
        )
    for field in ("plan_id", "assignment", "request", "predicted",
                  "memory", "search"):
        if field not in doc:
            raise PlanError(f"plan missing required field {field!r}")
    try:
        knobs_mod.validate_assignment(doc["assignment"])
    except (KeyError, ValueError) as e:
        raise PlanError(f"plan assignment rejected: {e}") from None
    expected = fingerprint({k: v for k, v in doc.items() if k != "plan_id"})
    if doc["plan_id"] != expected:
        raise PlanError(
            f"plan_id {doc['plan_id']!r} does not match content "
            f"fingerprint {expected!r} (edited by hand? re-run suggest)"
        )
    return doc


def to_json(doc: dict) -> str:
    """The plan as canonical JSON text (deterministic bytes)."""
    return _canonical(doc)


def save(doc: dict, path: str) -> str:
    """Validate and atomically write ``doc`` to ``path``; returns ``path``."""
    validate(doc)
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(to_json(doc))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def load(path: str) -> dict:
    """Read and validate the plan at ``path`` (raises :class:`PlanError`)."""
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except OSError as e:
        raise PlanError(f"cannot read plan {path}: {e}") from None
    except ValueError as e:
        raise PlanError(f"plan {path} is not valid JSON: {e}") from None
    return validate(doc)


# -- consumer-side readers (failure-safe by contract) -----------------------

#: ``(abspath, mtime, size) -> doc`` cache: consumers call these per
#: phase/request; the plan file must not be re-read and re-validated
#: every time.
_active_cache: dict = {}


def active_plan():
    """The validated plan named by ``TIP_PLAN_FILE``, or None.

    Failure-safe: unset/missing/corrupt/stale-schema all return None —
    plans are advisory control inputs, never launch blockers.
    """
    raw = os.environ.get(PLAN_FILE_ENV, "").strip()
    if not raw:
        return None
    path = os.path.abspath(raw)
    try:
        st = os.stat(path)
        key = (path, st.st_mtime_ns, st.st_size)
        if key not in _active_cache:
            _active_cache.clear()  # one live plan at a time; no unbounded growth
            _active_cache[key] = load(path)
        return _active_cache[key]
    except (OSError, PlanError):
        return None


def active_plan_id() -> str:
    """The active plan's id, or ``"unplanned"``.

    Stamped into bench records, scheduler phase spans, and (obs v5) every
    incident the alert evaluator opens — a page under a fresh plan points
    at the plan first.
    """
    doc = active_plan()
    return doc["plan_id"] if doc else UNPLANNED


def phase_estimate(phase: str, n_runs: int = 1, workers: int = 1):
    """The active plan's estimate for ``phase`` scaled to this launch.

    Scales the plan's stored per-run seconds to ``n_runs`` across
    ``workers`` (same ideal-packing arithmetic as
    ``costmodel.predict_study``). Returns ``{predicted_s, error_s, basis:
    "plan", plan_id, corpus_rows}`` or None when no plan is active, the
    phase is not in the plan, or the plan has no usable number — callers
    fall back to the live cost model.
    """
    doc = active_plan()
    if doc is None:
        return None
    info = (doc.get("predicted") or {}).get("by_phase", {}).get(phase)
    if not isinstance(info, dict):
        return None
    per_run = info.get("per_run_s")
    if not isinstance(per_run, (int, float)):
        return None
    scale = max(int(n_runs), 1) / max(int(workers), 1)
    per_err = info.get("error_s")
    planned_runs = max(int((doc.get("predicted") or {}).get("runs") or 1), 1)
    planned_workers = max(int((doc.get("predicted") or {}).get("workers") or 1), 1)
    # error_s in the plan is study-total; recover the per-run error before
    # rescaling so a 1-run phase does not inherit a 400-run error bar.
    per_run_err = (
        float(per_err) * planned_workers / planned_runs
        if isinstance(per_err, (int, float)) else 0.0
    )
    return {
        "predicted_s": round(float(per_run) * scale, 4),
        "error_s": round(per_run_err * scale, 4),
        "basis": "plan",
        "plan_id": doc["plan_id"],
        "corpus_rows": info.get("corpus_rows"),
    }
