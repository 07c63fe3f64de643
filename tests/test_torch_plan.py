"""The port's execution planner (``simple_tip_tpu_torch/plan/``) against the
JAX package's ``plan/``.

The port's knob space is the knobs its modules read (``fused_chain``,
``group_size``, ``max_badge``, ``worker_platforms``, ``workers``), each
with the JAX package's env var, legal values, default and cost-model
effect. On a seeded corpus of card rows without a batch (as the port's
own rows are: no CPU or TPU rows and no batch, so the JAX package's five
extra knobs move no feature the model fits) the search chooses the same
value for every shared knob and predicts the same seconds;
``plan.to_json`` gives the same bytes for the same assignment and
predictions; the plan readers scale a plan alike; ``suggest`` twice writes
byte-identical files. The deliberate difference: a plan or a ``--set``
naming ``batch``, ``cluster_backend``, ``sa_fanout``, ``sa_mem_frac`` or
``sa_pool`` is refused (exit 2) with a message naming the knob as not
ported, and the memory bound prices each candidate at ``batch=None``.
"""

import json
import os

import pytest

from simple_tip_tpu.obs import costmodel as jax_costmodel
from simple_tip_tpu.plan import cli as jax_plan_cli
from simple_tip_tpu.plan import knobs as jax_knobs
from simple_tip_tpu.plan import plan as jax_plan
from simple_tip_tpu.plan import search as jax_search
from simple_tip_tpu_torch.plan import cli as plan_cli
from simple_tip_tpu_torch.plan import knobs, plan, search
from test_torch_obs_store import seeded_rows
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SHARED = ("fused_chain", "group_size", "max_badge", "worker_platforms", "workers")
UNPORTED = ("batch", "cluster_backend", "sa_fanout", "sa_mem_frac", "sa_pool")
PHASES = ["test_prio", "sa_fit.total", "active_learning"]


@pytest.fixture(autouse=True)
def _no_active_plan(monkeypatch):
    monkeypatch.delenv("TIP_PLAN_FILE", raising=False)
    monkeypatch.delenv("TIP_PLAN_MEM_BYTES", raising=False)


def _corpus(seed: int = 0):
    return seeded_rows(seed, n=90, platforms=("default",))


def _batchless_corpus(seed: int):
    """``_corpus`` as the port's own streams give it: no row carries a batch."""
    return [dict(row, batch=None) for row in _corpus(seed)]


def _index(tmp_path, rows) -> str:
    idx = tmp_path / "idx"
    idx.mkdir()
    with open(idx / "index.jsonl", "w") as f:
        for row in rows:
            f.write(json.dumps(row, sort_keys=True) + "\n")
    return str(idx)


def test_knob_space_is_the_ports_with_jaxs_values():
    assert tuple(k.name for k in knobs.all_knobs()) == SHARED
    assert {k.name for k in jax_knobs.all_knobs()} == set(SHARED) | set(UNPORTED)
    for k in knobs.all_knobs():
        j = jax_knobs.knob(k.name)
        assert (k.env, k.values, k.default, k.features, k.param, k.effects) == \
            (j.env, j.values, j.default, j.features, j.param, j.effects)
    assert set(knobs.NOT_PORTED) == set(UNPORTED)
    assert {knobs.NOT_PORTED[n][0] for n in UNPORTED} == {jax_knobs.knob(n).env for n in UNPORTED}
    assert knobs.planned_env_vars() == frozenset(jax_knobs.knob(n).env for n in SHARED)
    for value in ("4", " 8 "):
        assert knobs.knob("workers").coerce(value) == jax_knobs.knob("workers").coerce(value)
    with pytest.raises(ValueError, match="not legal"):
        knobs.knob("workers").coerce("3")
    assignment = {"workers": 4, "worker_platforms": "cpu", "group_size": 2}
    assert knobs.prediction_params(assignment, "default") == \
        jax_knobs.prediction_params(assignment, "default")
    assert knobs.assignment_env(assignment) == jax_knobs.assignment_env(assignment)


@pytest.mark.parametrize("name", UNPORTED)
def test_unported_knobs_are_refused(name, tmp_path, capsys, monkeypatch):
    with pytest.raises(KeyError, match="not ported"):
        knobs.knob(name)
    value = jax_knobs.knob(name).values[-1]
    with pytest.raises(KeyError, match=f"'{name}'.*not ported"):
        knobs.validate_assignment({name: value})
    # a JAX plan naming the knob: explain and apply exit 2, saying so
    doc = jax_plan.build({name: value, "workers": 2}, {"by_phase": {}}, {"phases": ["x"]}, {}, {})
    path = jax_plan.save(doc, str(tmp_path / "jax_plan.json"))
    with pytest.raises(plan.PlanError, match="not ported"):
        plan.load(path)
    capsys.readouterr()
    for argv in (["explain", path], ["apply", path]):
        assert plan_cli.main(argv) == 2
        assert f"'{name}'" in capsys.readouterr().err
    idx = _index(tmp_path, _corpus())
    argv = ["suggest", "--phases", "test_prio", "--runs", "10", "--index", idx,
            "--set", f"{name}={value}"]
    assert plan_cli.main(argv) == 2
    assert "not ported" in capsys.readouterr().err
    monkeypatch.setenv("TIP_PLAN_FILE", path)
    assert plan.active_plan() is None and plan.active_plan_id() == "unplanned"


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_search_chooses_as_jax_on_the_shared_knobs(seed):
    rows = _batchless_corpus(seed)
    assert costmodel_fit_equal(rows)
    kwargs = dict(runs=100, case_studies=2, platform="default")
    got = search.search(rows, PHASES, **kwargs)
    want = jax_search.search(rows, PHASES, **kwargs)
    assert got["assignment"] == {k: want["assignment"][k] for k in SHARED}
    assert {want["assignment"][k] for k in UNPORTED} == \
        {jax_knobs.knob(k).default for k in UNPORTED}
    assert got["predicted"] == want["predicted"]
    assert got["memory"] == want["memory"]
    for name in SHARED:
        assert got["search"]["knobs"][name] == want["search"]["knobs"][name]
    assert set(got["search"]["knobs"]) == set(SHARED)
    # a capacity bound needs rows with a batch, in both packages
    for module in (search, jax_search):
        with pytest.raises(module.InsufficientCorpus, match="device_peak_bytes and batch"):
            module.search(rows, PHASES, capacity_bytes=9e7, **kwargs)


@pytest.mark.parametrize("seed, groups_kept", [(2, 1), (3, 2)])
def test_memory_bound_prices_candidates_without_a_batch(seed, groups_kept):
    """On rows that carry a batch (a JAX benchmark's), the port's memory
    bound prices each candidate at ``batch=None`` through JAX's own peak
    model: the largest observed peak plus the group term."""
    rows = _corpus(seed)
    model = jax_search.fit_memory_model(rows)
    assert search.fit_memory_model(rows) == model and model["coef"][2] > 0
    groups = knobs.knob("group_size").values
    capacity = jax_search.predict_peak_bytes(model, None, groups[groups_kept - 1])
    got = search.search(rows, PHASES, runs=100, platform="default", capacity_bytes=capacity)
    assert got["memory"]["constraint"] == "enforced"
    assert got["memory"]["predicted_peak_bytes"] == \
        jax_search.predict_peak_bytes(model, None, got["assignment"]["group_size"])
    for value, entry in got["search"]["knobs"]["group_size"]["values"].items():
        over = jax_search.predict_peak_bytes(model, None, int(value)) > capacity
        assert (entry.get("rejected") == "memory") == over
    assert got["assignment"]["group_size"] in groups[:groups_kept]


def costmodel_fit_equal(rows) -> bool:
    from simple_tip_tpu_torch.obs import costmodel

    return costmodel.fit(rows) == jax_costmodel.fit(rows)


def test_memory_infeasible_and_insufficient_corpus_as_jax():
    rows = _corpus(4)
    model = jax_search.fit_memory_model(rows)
    for exc, jax_exc, kwargs in (
        (search.InfeasiblePlan, jax_search.InfeasiblePlan, {"capacity_bytes": 1.0}),
        (search.InsufficientCorpus, jax_search.InsufficientCorpus, {"phases": ["nope"]}),
    ):
        call = dict({"phases": PHASES, "runs": 10}, **kwargs)
        with pytest.raises(exc) as got:
            search.search(rows, **call)
        with pytest.raises(jax_exc) as want:
            jax_search.search(rows, **call)
        # the smallest peak: JAX's at its smallest batch, the port's at none
        smallest = (str(jax_search.predict_peak_bytes(model, 2048)),
                    str(jax_search.predict_peak_bytes(model, None)))
        assert str(got.value).replace("simple_tip_tpu_torch", "simple_tip_tpu") == \
            str(want.value).replace(*smallest)


def test_plan_documents_are_the_same_bytes():
    rows = _corpus(5)
    result = search.search(rows, PHASES, runs=50, platform="default")
    request = {"phases": PHASES, "runs": 50, "case_studies": 1, "platform": "default"}
    args = (result["assignment"], result["predicted"], request, result["memory"],
            result["search"])
    doc, jax_doc = plan.build(*args), jax_plan.build(*args)
    assert plan.to_json(doc) == jax_plan.to_json(jax_doc)
    assert doc["plan_id"] == jax_plan.fingerprint({k: v for k, v in doc.items() if k != "plan_id"})
    tampered = dict(doc, request=dict(doc["request"], runs=51))
    with pytest.raises(plan.PlanError, match="does not match"):
        plan.validate(tampered)


def test_plan_readers_scale_a_plan_as_jax(tmp_path, monkeypatch):
    rows = _corpus(6)
    result = search.search(rows, PHASES, runs=40, platform="default")
    doc = plan.build(result["assignment"], result["predicted"],
                     {"phases": PHASES, "runs": 40}, result["memory"], result["search"])
    path = plan.save(doc, str(tmp_path / "plan.json"))
    monkeypatch.setenv("TIP_PLAN_FILE", path)
    assert plan.active_plan() == jax_plan.active_plan()
    assert plan.active_plan_id() == jax_plan.active_plan_id() == doc["plan_id"]
    for phase, runs, workers in (("test_prio", 10, 2), ("sa_fit.total", 1, 1), ("nope", 1, 1)):
        assert plan.phase_estimate(phase, runs, workers) == \
            jax_plan.phase_estimate(phase, runs, workers)
    monkeypatch.setenv("TIP_PLAN_FILE", str(tmp_path / "missing.json"))
    assert plan.active_plan() is None and plan.phase_estimate("test_prio") is None


def test_cli_suggest_twice_is_byte_identical_and_renders_as_jax(tmp_path, capsys):
    idx = _index(tmp_path, _corpus(7))
    argv = ["suggest", "--phases", "test_prio,sa_fit.total", "--runs", "100",
            "--case-studies", "4", "--platform", "default", "--index", idx]
    paths = []
    for name in ("a", "b"):
        paths.append(str(tmp_path / f"{name}.json"))
        assert plan_cli.main(argv + ["-o", paths[-1]]) == 0
    with open(paths[0], "rb") as f, open(paths[1], "rb") as g:
        assert f.read() == g.read()
    capsys.readouterr()
    assert plan_cli.main(["explain", paths[0]]) == 0
    explained = capsys.readouterr().out
    assert "chosen" in explained and "sa_pool" not in explained
    assert plan_cli.main(["apply", paths[0]]) == 0
    exports = capsys.readouterr().out.splitlines()
    assert f"export TIP_PLAN_FILE={os.path.abspath(paths[0])}" in exports
    assert len(exports) == len(SHARED) + 1
    # the JAX renderer prints the port's document the same way
    doc = plan.load(paths[0])
    assert plan_cli.render_plan(doc) == jax_plan_cli.render_plan(doc)
    assert plan_cli.render_explain(doc) == jax_plan_cli.render_explain(doc)


def test_cli_exit_codes_as_jax(tmp_path, capsys):
    empty = str(tmp_path / "empty")
    idx = _index(tmp_path, _corpus(8))
    for argv in (["suggest", "--phases", "test_prio", "--runs", "10", "--index", empty, "--json"],
                 ["suggest", "--phases", "nope", "--runs", "10", "--index", idx],
                 ["suggest", "--phases", "test_prio", "--runs", "10", "--index", idx,
                  "--set", "workers=3"],
                 ["suggest", "--phases", "test_prio", "--runs", "10", "--index", idx,
                  "--mem-bytes", "1k"],
                 ["suggest", "--phases", " ", "--runs", "10", "--index", idx],
                 ["explain", str(tmp_path / "missing.json")]):
        capsys.readouterr()
        rc = plan_cli.main(argv)
        out = capsys.readouterr().out.replace("simple_tip_tpu_torch", "simple_tip_tpu")
        assert (rc, out) == (jax_plan_cli.main(argv), capsys.readouterr().out)
        assert rc in (2, 3)
