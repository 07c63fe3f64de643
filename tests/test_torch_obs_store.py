"""The port's feature store and cost model (``simple_tip_tpu_torch/obs/
store.py``, ``costmodel.py``) against the JAX package's.

Inputs: seeded event streams written as the port's scheduler and study
driver write them (meta records stamping ``TIP_OBS_PLATFORM``, per-run
spans, ``scheduler.phase`` spans with ``predicted_s`` / ``actual_s``, SA
variant spans, metrics flushes), the repo's obs fixtures (bench records,
host-phase captures, audit runs, the plan corpus) and seeded feature rows.

- store rows are JSON-equal between the packages (the same source paths
  go in, so nothing is left to mask); the port's streams carry no
  ``jax.compiles`` counter, so their rows hold ``compiles: null``;
- the cost model's coefficients, estimates and renderings are equal,
  exactly: both are the same pure-Python arithmetic in the same order;
- the deliberate difference: rows of platform ``tpu`` never train the
  port's model. Its fit over a corpus with such rows equals the JAX fit
  over the corpus without them, and reports how many it left out and why.
"""

import json
import os

import numpy as np
import pytest

from simple_tip_tpu.obs import costmodel as jax_costmodel
from simple_tip_tpu.obs import store as jax_store
from simple_tip_tpu_torch.obs import costmodel, store
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
PHASES = ("test_prio", "active_learning", "sa_fit", "serving.badge")


def write_stream(run_dir: str, seed: int, pid: int, platform: str, runs=(0, 1, 2)) -> None:
    """One process's seeded event stream, as the port's workers write it."""
    rng = np.random.default_rng(seed)
    os.makedirs(run_dir, exist_ok=True)
    t = 1.7e9 + seed * 1000.0
    recs = [{"type": "meta", "schema": 1, "ts": t, "pid": pid, "argv": ["worker"],
             "worker": str(seed % 3), "platform": platform}]
    for i, run in enumerate(runs):
        for phase in PHASES[:2]:
            dur = float(rng.uniform(1.0, 9.0))
            recs.append({"type": "span", "name": "run", "ts": t + i, "dur": round(dur, 6),
                         "pid": pid, "tid": 1, "id": f"{pid}:{i}", "depth": 0,
                         "attrs": {"phase": phase, "model_id": run, "case_study": "mnist"}})
        for variant in ("dsa", "pc-lsa"):
            recs.append({"type": "span", "name": "sa_fit", "ts": t + i, "pid": pid, "tid": 1,
                         "dur": float(rng.uniform(0.1, 2.0)), "id": f"{pid}:f{i}{variant}",
                         "depth": 1, "attrs": {"variant": variant}})
        recs.append({"type": "span", "name": "serving.badge", "ts": t + i, "pid": pid,
                     "tid": 2, "dur": float(rng.uniform(1e-3, 5e-3)), "id": f"{pid}:b{i}",
                     "depth": 0, "attrs": {"rows": 512}})
    pred = float(rng.uniform(10, 20))
    recs.append({"type": "span", "name": "scheduler.phase", "ts": t, "pid": pid, "tid": 1,
                 "dur": pred * 1.1, "id": f"{pid}:p", "depth": 0,
                 "attrs": {"phase": "test_prio", "case_study": "mnist", "runs": len(runs),
                           "workers": 2, "predicted_s": round(pred, 3),
                           "actual_s": round(pred * 1.1, 3), "plan": "unplanned"}})
    recs.append({"type": "metrics", "ts": t + 50, "pid": pid,
                 "counters": {"scheduler.requeues": int(rng.integers(0, 3)),
                              "sa_fit_cache.hit": 4},
                 "gauges": {"cuda.0.peak_bytes_in_use": int(rng.integers(1e8, 9e8)),
                            "kernel.fused_mnist_forward.launches": 5},
                 "histograms": {}})
    with open(os.path.join(run_dir, f"events-{pid}-{seed:08x}.jsonl"), "w") as f:
        for rec in recs:
            f.write(json.dumps(rec) + "\n")


def seeded_runs(root: str, n: int = 3) -> list:
    """``n`` obs run directories of two processes each (a card worker and
    a CPU worker), seeded."""
    dirs = []
    for k in range(n):
        d = os.path.join(root, f"run{k}")
        write_stream(d, 10 * k + 1, 4000 + 2 * k, "default")
        write_stream(d, 10 * k + 2, 4001 + 2 * k, "cpu", runs=(3, 4))
        dirs.append(d)
    return dirs


def seeded_rows(seed: int, n: int = 60, platforms=("default", "cpu")) -> list:
    """Feature rows over a few phases, platforms, batches and groups."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        platform = platforms[i % len(platforms)]
        batch = int(rng.choice([2048, 4096, 8192, 16384]))
        group = int(rng.choice([1, 2, 4]))
        count = int(rng.integers(1, 6))
        base = {"default": 1.0, "cpu": 4.0, "tpu": 0.3}.get(platform, 1.0)
        secs = count * base * (1.0 + 0.2 * np.log1p(batch) / np.log(2.0) / 14) / group ** 0.3
        rows.append({
            "schema": 1, "kind": "obs_run", "source": f"seeded-{seed}", "seq": 1,
            "run": i, "phase": ("test_prio", "sa_fit.total", "active_learning")[i % 3],
            "seconds": round(float(secs * rng.uniform(0.9, 1.1)), 6), "value": None,
            "count": count, "platform": platform, "degraded": bool(i % 17 == 5),
            "batch": batch, "workers": 2, "group": group, "compiles": None,
            "device_peak_bytes": int(batch * 1e4 + group * 5e5), "health": 0.0,
            "case_study": "mnist", "captured": None, "plan": None,
        })
    return rows


def test_store_rows_from_seeded_streams_equal_jax(tmp_path):
    roots = seeded_runs(str(tmp_path / "runs"))
    report = store.refresh(roots, str(tmp_path / "idx"))
    want = jax_store.refresh(roots, str(tmp_path / "jax_idx"))
    assert report["rows_appended"] == want["rows_appended"] > 0
    assert report["indexed"] == want["indexed"]
    rows = store.load_rows(str(tmp_path / "idx"))
    assert json.dumps(rows, sort_keys=True) == \
        json.dumps(jax_store.load_rows(str(tmp_path / "jax_idx")), sort_keys=True)
    # the port's rows: its platforms, no compile count, the audit row
    run_rows = [r for r in rows if r["phase"] in PHASES[:2] and r["run"] is not None]
    assert {r["platform"] for r in run_rows} == {"default", "cpu"}
    assert all(r["compiles"] is None for r in rows)
    assert any(r["phase"] == "audit.test_prio" for r in rows)
    assert {"sa_fit.dsa", "sa_fit.pc-lsa"} <= {r["phase"] for r in rows}
    assert all(r["device_peak_bytes"] for r in run_rows)
    # a second refresh finds nothing new, in both
    assert store.refresh(roots, str(tmp_path / "idx"))["rows_appended"] == 0


@pytest.mark.parametrize("fixture", ["obs_trend", "host_phase_trend", "mfu_trend", "obs_audit",
                                     "obs_trace", "obs_regress"])
def test_store_rows_from_repo_fixtures_equal_jax(fixture, tmp_path):
    roots = [os.path.join(FIXTURES, fixture)]
    roots += [os.path.join(roots[0], d) for d in sorted(os.listdir(roots[0]))
              if os.path.isdir(os.path.join(roots[0], d))]
    store.refresh(roots, str(tmp_path / "idx"))
    jax_store.refresh(roots, str(tmp_path / "jax_idx"))
    rows = store.load_rows(str(tmp_path / "idx"))
    assert rows
    assert json.dumps(rows, sort_keys=True) == \
        json.dumps(jax_store.load_rows(str(tmp_path / "jax_idx")), sort_keys=True)
    assert store.render_rows(rows, limit=20) == jax_store.render_rows(rows, limit=20)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cost_model_fit_and_estimates_equal_jax(seed):
    rows = seeded_rows(seed)
    model = costmodel.fit(rows)
    assert model == jax_costmodel.fit(rows)
    assert "left_out" not in model
    for min_rows in (1, 30, 100):
        assert costmodel.fit(rows, min_rows) == jax_costmodel.fit(rows, min_rows)
    phases = ["test_prio", "sa_fit.total", "active_learning", "missing"]
    for kw in ({}, {"platform": "cpu", "workers": 4, "batch": 8192, "group": 2},
               {"platform": "default", "case_studies": 3, "batch": 2048}):
        got = costmodel.predict_study(model, phases, 100, **kw)
        assert got == jax_costmodel.predict_study(model, phases, 100, **kw)
        assert costmodel.render_prediction(got) == jax_costmodel.render_prediction(got)
    for phase in phases:
        assert costmodel.phase_estimate(model, phase, "cpu", 4096, 2) == \
            jax_costmodel.phase_estimate(model, phase, "cpu", 4096, 2)


def test_quick_phase_estimate_equals_jax(tmp_path):
    idx = str(tmp_path / "idx")
    os.makedirs(idx)
    with open(os.path.join(idx, "index.jsonl"), "w") as f:
        for row in seeded_rows(7):
            f.write(json.dumps(row, sort_keys=True) + "\n")
    for phase, runs, workers in (("test_prio", 10, 2), ("sa_fit.total", 1, 1), ("nope", 3, 1)):
        got = costmodel.quick_phase_estimate(phase, runs, workers=workers, index_dir=idx)
        want = jax_costmodel.quick_phase_estimate(phase, runs, workers=workers, index_dir=idx)
        assert got == want
    assert costmodel.quick_phase_estimate("test_prio", 1, index_dir=str(tmp_path / "none")) \
        is None


def test_tpu_rows_are_left_out_of_the_fit():
    """Deliberate difference: a TPU row is another chip's seconds. The
    port's fit over a mixed corpus equals the JAX fit over its non-TPU
    rows, and its report counts what it left out and why."""
    mixed = seeded_rows(11, n=90, platforms=("default", "tpu", "cpu"))
    tpu = [r for r in mixed if r["platform"] == "tpu" and not r["degraded"]]
    kept = [r for r in mixed if r["platform"] != "tpu"]
    model = costmodel.fit(mixed)
    left_out = model.pop("left_out")
    assert left_out == {"rows": len(tpu), "why": costmodel.FOREIGN_WHY} and tpu
    assert "tpu" in left_out["why"]
    assert model == jax_costmodel.fit(kept)
    assert model != jax_costmodel.fit(mixed)
    result = costmodel.predict_study(costmodel.fit(mixed), ["test_prio"], 10)
    assert result["left_out"]["rows"] == len(tpu)
    assert f"left out of the fit: {len(tpu)} row(s)" in costmodel.render_prediction(result)
    # the plan corpus's TPU rows: none trains the port's model
    with open(os.path.join(FIXTURES, "plan_corpus", "index.jsonl")) as f:
        corpus = [json.loads(line) for line in f]
    fitted = costmodel.fit(corpus)
    n_tpu = sum(1 for r in corpus if r["platform"] == "tpu" and not r.get("degraded"))
    assert fitted["left_out"]["rows"] == n_tpu > 0
    assert fitted["rows_used"] == jax_costmodel.fit(corpus)["rows_used"] - n_tpu
