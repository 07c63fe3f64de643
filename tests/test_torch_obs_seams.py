"""Where the port's cost model, plans and alert evaluator plug in, held to
the JAX package's answers on the CPU.

On a seeded feature-store index (``TIP_OBS_INDEX``, card rows only) and
an execution plan written by the port's planner:

- admission's cold-start prior for a badge (``cold_badge_estimate_s``):
  the plan's ``serving.badge`` estimate first, else the cost model's;
  equal to the JAX package's in each case, and None on an empty index;
- the run scheduler quotes ``predicted_s`` (and the plan id) on its
  ``scheduler.phase`` span beside ``actual_s``, the numbers
  ``quick_phase_estimate`` / ``plan.phase_estimate`` give, and ticks the
  alert evaluator on its health cadence;
- the fleet's straggler timeout is sized from the same estimate as the
  JAX fleet's.
"""

import json

import pytest

from simple_tip_tpu.obs import costmodel as jax_costmodel
from simple_tip_tpu.parallel.fleet import FleetContext as JaxFleetContext
from simple_tip_tpu.plan import plan as jax_plan
from simple_tip_tpu.serving import admission as jax_admission
from simple_tip_tpu.serving.knobs import ServingKnobs as JaxKnobs
from simple_tip_tpu_torch import obs
from simple_tip_tpu_torch.obs import alerts
from simple_tip_tpu_torch.obs.cli import load_events
from simple_tip_tpu_torch.parallel.fleet import FleetContext
from simple_tip_tpu_torch.parallel.run_scheduler import run_phase_parallel
from simple_tip_tpu_torch.plan import plan
from simple_tip_tpu_torch.serving import admission
from simple_tip_tpu_torch.serving.knobs import ServingKnobs
from test_torch_obs_store import seeded_rows
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _rows():
    rows = seeded_rows(9, n=60, platforms=("default",))
    for i, row in enumerate(rows):
        row["phase"] = ("serving.badge", "_test_sleep", "ph")[i % 3]
    return rows


@pytest.fixture()
def index(tmp_path, monkeypatch):
    idx = tmp_path / "idx"
    idx.mkdir()
    with open(idx / "index.jsonl", "w") as f:
        for row in _rows():
            f.write(json.dumps(row, sort_keys=True) + "\n")
    monkeypatch.setenv("TIP_OBS_INDEX", str(idx))
    monkeypatch.setenv("TIP_ASSETS", str(tmp_path / "assets"))
    for var in ("TIP_PLAN_FILE", "TIP_FLEET_STRAGGLER_S", "TIP_ALERT_RULES", "TIP_OBS_DIR",
                "TIP_JOURNAL", "TIP_FAULT_PLAN", "TIP_BREAKER_STATE"):
        monkeypatch.delenv(var, raising=False)
    obs.reset_all()
    yield str(idx)
    obs.reset_all()


def _plan_file(tmp_path, per_run: dict) -> dict:
    predicted = {"runs": 4, "workers": 2, "total_s": 1.0, "error_s": 0.4,
                 "by_phase": {p: {"per_run_s": s, "total_s": s * 2, "error_s": 0.4,
                                  "basis": "model", "corpus_rows": 7}
                              for p, s in per_run.items()}}
    doc = plan.build({"workers": 2}, predicted, {"phases": sorted(per_run), "runs": 4},
                     {"constraint": "off"}, {"knobs": {}})
    plan.save(doc, str(tmp_path / "plan.json"))
    return doc


def test_admission_prior_is_the_plan_then_the_cost_model(index, tmp_path, monkeypatch):
    def priors():
        return (admission.AdmissionController(ServingKnobs(), breaker=None).cold_badge_estimate_s(),
                jax_admission.AdmissionController(JaxKnobs(), breaker=None)
                .cold_badge_estimate_s())

    got, want = priors()
    assert got == want == jax_costmodel.quick_phase_estimate("serving.badge", 1)["predicted_s"]
    assert got > 0
    _plan_file(tmp_path, {"serving.badge": 0.125})
    monkeypatch.setenv("TIP_PLAN_FILE", str(tmp_path / "plan.json"))
    assert priors() == (0.125, 0.125)  # the plan's per-run seconds, one run on one worker
    monkeypatch.setenv("TIP_OBS_INDEX", str(tmp_path / "empty"))
    monkeypatch.delenv("TIP_PLAN_FILE")
    assert priors() == (None, None)


def _phase_span(obs_dir: str) -> dict:
    events, _files, _bad = load_events(obs_dir)
    return next(r for r in events if r.get("type") == "span" and r["name"] == "scheduler.phase")


def test_scheduler_quotes_and_ticks(index, tmp_path, monkeypatch):
    rules = {"schema": 1, "rules": [{
        "name": "churn", "severity": "warn", "budget": 0.1,
        "objective": {"kind": "counter_delta", "metrics": ["scheduler.requeues"]}}]}
    monkeypatch.setenv("TIP_ALERT_RULES", json.dumps(rules))
    monkeypatch.setenv("TIP_ALERT_STATE", str(tmp_path / "alerts"))
    monkeypatch.setenv("TIP_ALERT_EVAL_S", "0")
    monkeypatch.setenv("TIP_ALERT_SINKS", "off")
    monkeypatch.setenv("TIP_OBS_DIR", str(tmp_path / "run1"))
    obs.reset_all()
    run_phase_parallel("mnist", "_test_sleep", model_ids=[0, 1, 2], num_workers=1,
                       phase_kwargs={"seconds": 0.01})
    attrs = _phase_span(str(tmp_path / "run1"))["attrs"]
    want = jax_costmodel.quick_phase_estimate("_test_sleep", 3, workers=1)
    assert attrs["predicted_s"] == want["predicted_s"] > 0 and attrs["actual_s"] > 0
    assert "plan" not in attrs
    assert alerts.load_state(str(tmp_path / "alerts"))["rules"]["churn"]["state"] == "inactive"

    _plan_file(tmp_path, {"_test_sleep": 2.5})
    monkeypatch.setenv("TIP_PLAN_FILE", str(tmp_path / "plan.json"))
    monkeypatch.setenv("TIP_OBS_DIR", str(tmp_path / "run2"))
    obs.reset_all()
    run_phase_parallel("mnist", "_test_sleep", model_ids=[3, 4, 5], num_workers=1,
                       phase_kwargs={"seconds": 0.01})
    attrs = _phase_span(str(tmp_path / "run2"))["attrs"]
    planned = jax_plan.phase_estimate("_test_sleep", 3, workers=1)
    assert attrs["predicted_s"] == planned["predicted_s"] == 7.5
    assert attrs["plan"] == plan.active_plan_id() == planned["plan_id"]


def test_straggler_timeout_is_sized_as_jax(index, tmp_path, monkeypatch):
    monkeypatch.setenv("TIP_JOURNAL", str(tmp_path / "runs.jsonl"))
    monkeypatch.setenv("TIP_FLEET_STRAGGLER_SLACK", "3")
    got = FleetContext(str(tmp_path / "fleet"), "h0", "cs", "ph")._straggler_timeout()
    want = JaxFleetContext(str(tmp_path / "jax_fleet"), "h0", "cs", "ph")._straggler_timeout()
    est = jax_costmodel.quick_phase_estimate("ph", 1)
    assert got == want == max(3 * (est["predicted_s"] + 2 * est["error_s"]), 1.0)
    _plan_file(tmp_path, {"ph": 40.0})
    monkeypatch.setenv("TIP_PLAN_FILE", str(tmp_path / "plan.json"))
    got = FleetContext(str(tmp_path / "fleet"), "h1", "cs", "ph")._straggler_timeout()
    want = JaxFleetContext(str(tmp_path / "jax_fleet"), "h1", "cs", "ph")._straggler_timeout()
    assert got == want > 100.0
