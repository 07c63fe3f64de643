"""Learned per-phase cost model over the telemetry feature store (obs v3).

"A Learned Performance Model for TPUs" (arxiv 2008.01040) shows that a
small set of per-phase cost features predicts runtime well; the feature
store (``obs/store.py``) already persists exactly those features for every
run this repo has executed. This module closes the loop: a stdlib-only
least-squares fit per phase (features -> seconds-per-run), and a study
predictor that turns a proposed config (case studies x runs x phases x
backend x workers) into a wall-clock estimate with a stated error — the
admission-control number ``obs predict``, ``run_scheduler`` and
``full_study.py`` quote before launching anything.

Honesty rules:

- a phase with fewer than ``min_rows`` corpus rows is **insufficient**: it
  falls back to the phase median (or nothing at all) and is named loudly
  in the prediction's ``insufficient`` list — silent extrapolation from a
  2-row corpus is how wall-clock estimates become fiction;
- degraded rows never train the model (a CPU-fallback run teaches the
  wrong coefficients for every healthy launch);
- the stated error is the fit's mean absolute error scaled to the study
  size — optimistic for extrapolation, but it is *stated*, so the reader
  can judge.

- rows whose ``platform`` is ``tpu`` never train the model either: they
  are another chip's seconds (the JAX package's runs). ``fit`` counts the
  rows it left out under ``left_out`` and says why; on a corpus without
  such rows the fit is the JAX package's, number for number.

The solver is normal equations + Gaussian elimination with a small ridge
term. Stdlib only.
"""

import math

from simple_tip_tpu_torch.obs import store

#: Minimum corpus rows per phase before the least-squares fit is trusted.
DEFAULT_MIN_ROWS = 3

#: Row platforms that never train the port's model: another chip's seconds.
FOREIGN_PLATFORMS = ("tpu",)

#: Why ``fit`` leaves those rows out (its ``left_out`` report says so).
FOREIGN_WHY = "platform tpu: another chip's seconds, not the card's"

#: Ridge regularizer added to the normal equations' diagonal: keeps the
#: solve stable when a feature column is constant (e.g. all-CPU corpus).
RIDGE = 1e-6


def _features(platform, count, batch, group=None) -> list:
    """The feature vector of one observation:
    ``[1, cpu?, ln(1+n), ln(1+batch), ln(group)]``.

    ``group`` is the cross-run dispatch-fusion group size (models per chain
    dispatch, ``TIP_CHAIN_GROUP``); ``ln(group)`` is 0 at the ungrouped
    baseline (group=1 or absent), so corpora without grouped rows fit the
    exact pre-group model (the ridge pins the dead column's coefficient to
    ~0) and grouped rows teach the G-vs-throughput slope the planner ranks.
    """
    cpu = 1.0 if str(platform or "").lower() == "cpu" else 0.0
    return [
        1.0,
        cpu,
        math.log1p(max(float(count or 1), 1.0)),
        math.log1p(max(float(batch or 0), 0.0)),
        math.log(max(float(group or 1), 1.0)),
    ]


def _solve(matrix, rhs) -> list:
    """Gaussian elimination with partial pivoting: ``matrix @ x = rhs``."""
    n = len(rhs)
    a = [row[:] + [rhs[i]] for i, row in enumerate(matrix)]
    for col in range(n):
        pivot = max(range(col, n), key=lambda r: abs(a[r][col]))
        a[col], a[pivot] = a[pivot], a[col]
        if abs(a[col][col]) < 1e-12:
            raise ValueError("singular system")
        inv = 1.0 / a[col][col]
        for r in range(n):
            if r == col:
                continue
            factor = a[r][col] * inv
            for c in range(col, n + 1):
                a[r][c] -= factor * a[col][c]
    return [a[i][n] / a[i][i] for i in range(n)]


def _least_squares(xs, ys) -> list:
    """Ridge-regularized least-squares coefficients of ``xs @ c ~ ys``."""
    k = len(xs[0])
    xtx = [[RIDGE if i == j else 0.0 for j in range(k)] for i in range(k)]
    xty = [0.0] * k
    for x, y in zip(xs, ys):
        for i in range(k):
            xty[i] += x[i] * y
            for j in range(k):
                xtx[i][j] += x[i] * x[j]
    return _solve(xtx, xty)


def _median(values) -> float:
    """The sample median (stdlib-free of statistics for a hot loop)."""
    vals = sorted(values)
    mid = len(vals) // 2
    if len(vals) % 2:
        return float(vals[mid])
    return (vals[mid - 1] + vals[mid]) / 2.0


def fit(rows, min_rows: int = DEFAULT_MIN_ROWS) -> dict:
    """Fit the per-phase cost model over feature-store ``rows``.

    Only non-degraded rows with a ``seconds`` target train; the target is
    seconds-per-unit (``seconds / count``) so scheduler aggregates and
    single runs land on the same scale. Returns ``{phases: {name: {coef,
    n, mae_s, median_s, sufficient}}, rows_used}`` — an insufficient phase
    has ``coef: None`` and only its median as a fallback estimate. Rows of
    a ``FOREIGN_PLATFORMS`` platform are left out; when there are any, the
    result also has ``left_out: {rows, why}``.
    """
    by_phase = {}
    used = 0
    foreign = 0
    for row in rows:
        secs = row.get("seconds")
        if not isinstance(secs, (int, float)) or secs < 0:
            continue
        if row.get("degraded") is True:
            continue
        if str(row.get("platform") or "").lower() in FOREIGN_PLATFORMS:
            foreign += 1
            continue
        count = max(float(row.get("count") or 1), 1.0)
        by_phase.setdefault(str(row.get("phase")), []).append(
            (
                _features(
                    row.get("platform"), count, row.get("batch"),
                    row.get("group"),
                ),
                float(secs) / count,
            )
        )
        used += 1
    phases = {}
    for name, obs in sorted(by_phase.items()):
        ys = [y for _x, y in obs]
        entry = {
            "coef": None,
            "n": len(obs),
            "mae_s": None,
            "median_s": round(_median(ys), 6),
            "sufficient": len(obs) >= min_rows,
        }
        if entry["sufficient"]:
            try:
                coef = _least_squares([x for x, _y in obs], ys)
                mae = _median(  # median abs error: robust to one outlier run
                    abs(sum(c * f for c, f in zip(coef, x)) - y)
                    for x, y in obs
                )
                entry["coef"] = [round(c, 8) for c in coef]
                entry["mae_s"] = round(mae, 6)
            except ValueError:
                entry["sufficient"] = False
        phases[name] = entry
    model = {"phases": phases, "rows_used": used}
    if foreign:
        model["left_out"] = {"rows": foreign, "why": FOREIGN_WHY}
    return model


def phase_estimate(model: dict, phase: str, platform=None, batch=None,
                   group=None):
    """``(seconds_per_run, error_s, basis)`` for one phase, or Nones.

    ``basis`` is ``model`` (trusted fit), ``median`` (insufficient corpus
    fallback) or ``missing`` (phase absent from the corpus entirely).
    """
    entry = (model.get("phases") or {}).get(phase)
    if entry is None:
        return None, None, "missing"
    if entry["sufficient"] and entry["coef"]:
        x = _features(platform, 1, batch, group)
        est = sum(c * f for c, f in zip(entry["coef"], x))
        return max(est, 0.0), entry["mae_s"] or 0.0, "model"
    return entry["median_s"], entry["median_s"], "median"


def predict_study(
    model: dict,
    phases,
    runs: int,
    case_studies: int = 1,
    platform=None,
    workers: int = 1,
    batch=None,
    group=None,
) -> dict:
    """Wall-clock estimate of ``case_studies x runs`` over ``phases``.

    Per phase: seconds-per-run from ``phase_estimate`` x total runs,
    divided by ``workers`` (ideal packing — real schedules straggle, and
    the stated error does not cover that). Returns ``{total_s, error_s,
    by_phase, insufficient, ok}``; ``ok`` is False when NO requested phase
    had a trusted or fallback estimate — the loud "insufficient corpus"
    case callers must surface, not bury.
    """
    workers = max(int(workers), 1)
    total_runs = max(int(runs), 0) * max(int(case_studies), 1)
    by_phase = {}
    insufficient = []
    total = err = 0.0
    any_estimate = False
    for phase in phases:
        per_run, per_err, basis = phase_estimate(
            model, phase, platform, batch, group
        )
        if basis != "model":
            insufficient.append(phase)
        if per_run is None:
            by_phase[phase] = {
                "per_run_s": None,
                "total_s": None,
                "basis": basis,
            }
            continue
        any_estimate = True
        phase_total = per_run * total_runs / workers
        phase_err = (per_err or 0.0) * total_runs / workers
        by_phase[phase] = {
            "per_run_s": round(per_run, 4),
            "total_s": round(phase_total, 2),
            "error_s": round(phase_err, 2),
            "basis": basis,
            "corpus_rows": model["phases"][phase]["n"],
        }
        total += phase_total
        err += phase_err
    result = {
        "total_s": round(total, 2),
        "error_s": round(err, 2),
        "runs": total_runs,
        "workers": workers,
        "by_phase": by_phase,
        "insufficient": insufficient,
        "ok": any_estimate,
    }
    if model.get("left_out"):
        result["left_out"] = dict(model["left_out"])
    return result


def quick_phase_estimate(
    phase: str,
    n_runs: int,
    platform=None,
    workers: int = 1,
    index_dir=None,
):
    """Failure-safe pre-launch estimate for one scheduler phase, or None.

    Loads the index, fits, predicts — and returns None on ANY problem
    (no index, empty corpus, unknown phase): admission control is
    advisory; a missing estimate must never block a launch.
    """
    try:
        rows = store.load_corpus(index_dir)
        if not rows:
            return None
        prediction = predict_study(
            fit(rows), [phase], n_runs, platform=platform, workers=workers
        )
        info = prediction["by_phase"].get(phase) or {}
        if info.get("total_s") is None:
            return None
        return {
            "predicted_s": info["total_s"],
            "error_s": info.get("error_s"),
            "basis": info.get("basis"),
            "corpus_rows": info.get("corpus_rows"),
        }
    except Exception:  # noqa: BLE001 — advisory, never load-bearing
        return None


def render_prediction(result: dict) -> str:
    """A study prediction as a deterministic text table."""
    out = [
        f"predicted wall-clock: {result['total_s']:.1f} s "
        f"(+/- {result['error_s']:.1f} s) for {result['runs']} run(s) "
        f"across {result['workers']} worker(s)",
        "",
        f"  {'phase':<32} {'per-run s':>10} {'total s':>10} "
        f"{'+/- s':>8} {'rows':>5}  basis",
    ]
    for phase, info in sorted(result["by_phase"].items()):
        per_run = info.get("per_run_s")
        total_s = info.get("total_s")
        error_s = info.get("error_s", 0)
        out.append(
            f"  {phase:<32} "
            f"{(f'{per_run:.3f}' if per_run is not None else '-'):>10} "
            f"{(f'{total_s:.1f}' if total_s is not None else '-'):>10} "
            f"{(f'{error_s:.1f}' if total_s is not None else '-'):>8} "
            f"{str(info.get('corpus_rows', '-')):>5}  {info['basis']}"
        )
    if result["insufficient"]:
        out.append("")
        out.append(
            "INSUFFICIENT CORPUS for: "
            + ", ".join(result["insufficient"])
            + " (median fallback or no estimate — grow the index by "
            "running studies with TIP_OBS_DIR=auto)"
        )
    left_out = result.get("left_out")
    if left_out:
        out.append("")
        out.append(
            f"left out of the fit: {left_out['rows']} row(s) "
            f"({left_out['why']})"
        )
    return "\n".join(out)
