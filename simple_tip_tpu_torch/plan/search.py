"""Knob-space search against the learned cost model (the planner core).

"A Learned Performance Model for TPUs" (arxiv 2008.01040) uses its model
the way this module does: score candidate configurations against
*predicted* cost and pick, instead of burning device hours per candidate.
The search is deterministic coordinate descent over the typed knob space
(``plan/knobs.py``), scoring every candidate with the SAME
``costmodel.fit`` + ``predict_study`` arithmetic ``obs predict`` quotes —
a plan's stored per-phase seconds are exactly what the CLI would print
for that configuration, by construction.

Two honesty rules, both load-bearing:

- **memory is a constraint, not a cost term**: a memory-capacity bound
  (``capacity_bytes``) is checked against a peak-bytes model fit from the
  feature store's ``device_peak_bytes`` rows; a candidate predicted over
  capacity is REJECTED outright — an OOM is not "slow", it is a dead
  study, so no predicted speedup may buy it back. The port's space has no
  ``batch`` knob, so a candidate's peak is the model's at ``batch=None``:
  the largest observed peak plus the group term;
- **insufficient corpus fails LOUDLY**: an empty corpus, a corpus where
  no requested phase has any estimate, or a capacity bound without enough
  ``device_peak_bytes`` rows to fit the peak model all raise
  :class:`InsufficientCorpus` — the CLI maps it to the established exit-3
  contract. The planner never silently guesses.

Stdlib only.
"""

from simple_tip_tpu_torch.obs import costmodel
from simple_tip_tpu_torch.plan import knobs as knobs_mod

#: Coordinate-descent pass bound: the space is small and scores are
#: deterministic, so a fixed point lands in 2-3 passes; this is a fuse.
MAX_PASSES = 4


class InsufficientCorpus(RuntimeError):
    """The corpus cannot support the requested plan (CLI exit 3)."""


class InfeasiblePlan(RuntimeError):
    """Every candidate violates the memory capacity bound (CLI exit 2)."""


def fit_memory_model(rows, min_rows: int = costmodel.DEFAULT_MIN_ROWS):
    """Peak-bytes model (``peak ~ a + b*batch + c*(group-1)``) from rows.

    Trains on non-degraded rows carrying both ``device_peak_bytes`` and
    ``batch``; a row's ``group`` (cross-run dispatch-fusion group size,
    absent on pre-group corpora) enters as ``group - 1`` so the ungrouped
    baseline contributes zero and a corpus with no grouped rows fits the
    exact pre-group model (the ridge pins the dead column to ~0). The
    ``c`` coefficient is the *measured* stacked-weights residency per
    extra group member — learned from telemetry, not computed from param
    counts, so it prices whatever the runtime actually holds resident.
    Returns ``{coef, n, max_peak_bytes}`` or None when fewer than
    ``min_rows`` rows qualify — the caller decides whether None is fatal
    (it is, whenever a capacity bound was requested).
    """
    obs = []
    for row in rows:
        peak = row.get("device_peak_bytes")
        batch = row.get("batch")
        if row.get("degraded") is True:
            continue
        if isinstance(peak, (int, float)) and isinstance(batch, (int, float)):
            group = row.get("group")
            g = float(group) if isinstance(group, (int, float)) else 1.0
            obs.append((float(batch), max(g, 1.0), float(peak)))
    if len(obs) < min_rows:
        return None
    try:
        coef = costmodel._least_squares(
            [[1.0, b, g - 1.0] for b, g, _p in obs],
            [p for _b, _g, p in obs],
        )
    except ValueError:
        return None
    return {
        "coef": [round(c, 6) for c in coef],
        "n": len(obs),
        "max_peak_bytes": int(max(p for _b, _g, p in obs)),
    }


def predict_peak_bytes(mem_model: dict, batch, group=1) -> int:
    """Predicted device peak bytes at ``(batch, group)`` under the model.

    A non-increasing batch fit (noise, constant-batch corpus) falls back
    to the max observed peak — constant but conservative, never
    extrapolating a negative slope into "bigger batches are free". The
    group term is additive ON TOP of that base and only applied when its
    learned coefficient is positive: a noisy negative ``c`` must never
    let a bigger G *discount* the predicted peak below the ungrouped
    baseline, because an over-capacity G is a dead study, not a slow one.
    """
    coef = mem_model["coef"]
    a, b = coef[0], coef[1]
    c = coef[2] if len(coef) > 2 else 0.0
    if b <= 0 or batch is None:
        base = float(mem_model["max_peak_bytes"])
    else:
        base = max(a + b * float(batch), 0.0)
    extra = 0.0
    if c > 0:
        extra = c * (max(float(group or 1), 1.0) - 1.0)
    return int(base + extra)


def search(rows, phases, runs: int, case_studies: int = 1, platform=None,
           capacity_bytes=None, pinned=None,
           min_rows: int = costmodel.DEFAULT_MIN_ROWS) -> dict:
    """Pick the knob assignment minimizing predicted study wall-clock.

    Returns the material ``plan.build`` needs: ``{assignment, predicted,
    memory, search}``. Raises :class:`InsufficientCorpus` (exit 3) or
    :class:`InfeasiblePlan` (exit 2) instead of guessing.
    """
    pinned = knobs_mod.validate_assignment(pinned or {})
    phases = list(phases)
    model = costmodel.fit(rows, min_rows)
    mem_model = None
    if capacity_bytes is not None:
        mem_model = fit_memory_model(rows, min_rows)
        if mem_model is None:
            raise InsufficientCorpus(
                f"memory capacity bound given, but the corpus has fewer "
                f"than {min_rows} non-degraded rows carrying both "
                f"device_peak_bytes and batch — cannot fit the peak-bytes "
                f"model, refusing to guess (grow the index with "
                f"`python -m simple_tip_tpu_torch.obs runs`)"
            )

    def score(assignment):
        """``(predict_study result, peak_bytes, rejected)`` of a candidate."""
        params = knobs_mod.prediction_params(assignment, platform)
        pred = costmodel.predict_study(
            model, phases, runs, case_studies,
            platform=params["platform"], workers=params["workers"],
            batch=params["batch"], group=params.get("group"),
        )
        peak = None
        rejected = False
        if mem_model is not None:
            peak = predict_peak_bytes(
                mem_model, params["batch"], params.get("group") or 1
            )
            rejected = peak > capacity_bytes
        return pred, peak, rejected

    assignment = knobs_mod.default_assignment()
    assignment.update(pinned)
    base_pred, _peak, _rej = score(assignment)
    if not base_pred["ok"]:
        raise InsufficientCorpus(
            "no requested phase has any corpus estimate "
            f"(phases: {', '.join(phases)}; corpus rows used: "
            f"{model['rows_used']}) — refusing to plan from nothing"
        )

    evaluated = rejected_memory = passes = 0
    for _ in range(MAX_PASSES):
        passes += 1
        changed = False
        for k in knobs_mod.all_knobs():
            if k.name in pinned:
                continue
            # Seed with the CURRENT value (if feasible): a value only
            # replaces it when strictly better, so ties keep the knob's
            # default and knobs the model cannot distinguish never move —
            # the walk stays deterministic and `explain` says so honestly.
            cur_pred, _peak, cur_rej = score(assignment)
            best_value, best_total = (
                (None, None) if cur_rej
                else (assignment[k.name], cur_pred["total_s"])
            )
            for value in k.values:
                if value == assignment[k.name]:
                    continue
                candidate = dict(assignment, **{k.name: value})
                pred, _peak, rej = score(candidate)
                evaluated += 1
                if rej:
                    rejected_memory += 1
                    continue
                total = pred["total_s"]
                if best_total is None or total < best_total:
                    best_value, best_total = value, total
            if best_value is not None and best_value != assignment[k.name]:
                assignment[k.name] = best_value
                changed = True
        if not changed:
            break

    final_pred, final_peak, final_rej = score(assignment)
    if final_rej:
        raise InfeasiblePlan(
            f"every candidate assignment is predicted over the "
            f"{capacity_bytes}-byte device memory capacity "
            f"(smallest predicted peak "
            f"{predict_peak_bytes(mem_model, None)} "
            f"bytes) — raise the capacity or shrink the workload"
        )

    # Explain sweep: score every value of every knob against the FINAL
    # assignment, so `plan explain` renders real alternatives, including
    # the memory-rejected ones.
    knob_report = {}
    for k in knobs_mod.all_knobs():
        values = {}
        for value in k.values:
            pred, peak, rej = score(dict(assignment, **{k.name: value}))
            values[str(value)] = {
                "total_s": None if rej else pred["total_s"],
                **({"predicted_peak_bytes": peak} if peak is not None else {}),
                **({"rejected": "memory"} if rej else {}),
            }
        knob_report[k.name] = {
            "chosen": assignment[k.name],
            "env": k.env,
            "features": list(k.features),
            "pinned": k.name in pinned,
            "values": values,
        }

    return {
        "assignment": assignment,
        "predicted": final_pred,
        "memory": {
            "constraint": "enforced" if mem_model is not None else "off",
            "capacity_bytes": capacity_bytes,
            "predicted_peak_bytes": final_peak,
            "model": mem_model,
        },
        "search": {
            "algorithm": "coordinate-descent",
            "passes": passes,
            "evaluated": evaluated,
            "rejected_memory": rejected_memory,
            "corpus_rows_used": model["rows_used"],
            "knobs": knob_report,
        },
    }
