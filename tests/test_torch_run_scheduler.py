"""The port's run scheduler (``parallel/run_scheduler.py``) on the CPU,
mirroring ``tests/test_run_scheduler.py``:

- two workers run at once (a rendezvous barrier and overlapping intervals)
  and failures are per id; ``default_worker_platforms`` equals the JAX
  package's over a grid of worker counts, card counts and overrides;
- a wedged worker is reaped past ``run_timeout_s`` and its id requeued onto
  a CPU worker (counted, evented with the new platform), a dead worker
  likewise, and a retry that wedges again fails the id; an env fault plan
  kills a worker at the ``worker.run`` seam and the requeue completes;
- group units run on one worker, a resumed phase replays only the
  unjournaled members, and an unknown phase is refused;
- a real ``test_prio`` over two spawned CPU workers
  (``CaseStudy.run_prio_eval([0, 1], num_workers=2, device="cpu")`` on the
  ``sched-mnist`` provider study, DSA as its SA variant) writes artifacts
  byte-equal to the in-process walk's, its workers import neither jax nor
  anything of ``simple_tip_tpu``, and its DSA and uncertainty artifacts
  agree with the JAX ``CaseStudy.run_prio_eval`` on the same checkpoints to
  ``tests/test_torch_slice.py``'s standard (uncertainties within atol 1e-5,
  DSA within rtol 1e-4, the rest byte-equal, but DSA's SC-CAM order, held
  as the port's ``_sc_cam_order`` of each side's DSA scores: SC-CAM buckets
  the scores, and a score within 1e-4 of a bucket edge may move a row);
- the command line's ``--workers 2 --device cpu`` dispatches through the
  scheduler with two CPU workers, and a card phase puts every worker on
  the card whatever the card count (the CPU only where
  ``TIP_WORKER_PLATFORMS`` names it), or exits 2 when no card answers;
- a real phase whose card worker dies is requeued onto a fresh card
  worker, never onto the CPU: with no card here the retry fails and the
  scheduler reports the ids.

Torch runs on one thread in the workers too (``OMP_NUM_THREADS=1``), as in
the test process, so that CPU reductions are the same in both.
"""

import glob
import json
import os
import shutil

import numpy as np
import pytest

from simple_tip_tpu import obs as jax_obs
from simple_tip_tpu.parallel import run_scheduler as jax_scheduler
from simple_tip_tpu_torch import cli, obs
from simple_tip_tpu_torch.device import backend_flags
from simple_tip_tpu_torch.engine.surprise_handler import _sc_cam_order
from simple_tip_tpu_torch.parallel import run_scheduler
from simple_tip_tpu_torch.parallel.run_scheduler import (
    default_worker_platforms,
    run_phase_parallel,
)
from simple_tip_tpu_torch.resilience.journal import RunJournal
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))


def _read_marker(marker_dir, i):
    with open(os.path.join(marker_dir, f"run_{i}.txt")) as f:
        start, end, pid = f.read().split()
    return float(start), float(end), int(pid)


@pytest.fixture()
def markers(tmp_path, monkeypatch):
    monkeypatch.delenv("TIP_ASSETS", raising=False)
    monkeypatch.delenv("TIP_JOURNAL", raising=False)
    monkeypatch.delenv("TIP_FAULT_PLAN", raising=False)
    monkeypatch.delenv("TIP_OBS_DIR", raising=False)
    folder = tmp_path / "markers"
    folder.mkdir()
    obs.reset_all()
    yield str(folder)
    obs.reset_all()


def test_workers_run_concurrently_and_failures_are_per_id(markers):
    with pytest.raises(RuntimeError) as exc_info:
        run_phase_parallel(
            "mnist", "_test_sleep", model_ids=[0, 1, 2, 3], num_workers=2,
            phase_kwargs={"seconds": 1.0, "marker_dir": markers, "fail_ids": (1,),
                          "barrier_n": 2},
        )
    msg = str(exc_info.value)
    assert "run 1" in msg and "synthetic failure" in msg and "1/4" in msg
    intervals = {i: _read_marker(markers, i) for i in (0, 2, 3)}
    pids = {pid for _, _, pid in intervals.values()}
    assert len(pids) == 2, f"expected two distinct worker pids, got {pids}"
    assert any(
        a0 < b1 and b0 < a1 and pa != pb
        for a0, a1, pa in intervals.values() for b0, b1, pb in intervals.values()
    ), f"no cross-worker interval overlap: {intervals}"


@pytest.mark.parametrize("override", ["", "default", "cpu", "default,cpu", "cpu, default,default",
                                      "default,default"])
def test_worker_platform_policy_equals_jax(monkeypatch, override):
    monkeypatch.setenv("TIP_WORKER_PLATFORMS", override)
    for workers in range(1, 6):
        for chips in range(0, 5):
            assert default_worker_platforms(workers, chips) == \
                jax_scheduler.default_worker_platforms(workers, chips), (workers, chips)
    assert sorted(run_scheduler.PHASES) == sorted(jax_scheduler.PHASES)


def test_wedged_worker_is_reaped_and_id_requeued_onto_the_cpu(markers, tmp_path, monkeypatch):
    monkeypatch.setenv("TIP_OBS_DIR", str(tmp_path / "obs"))
    obs.reset_all()
    run_phase_parallel(
        "mnist", "_test_wedge", model_ids=[0, 1, 2], num_workers=2,
        phase_kwargs={"marker_dir": markers, "wedge_ids": (0,)}, run_timeout_s=3.0,
    )
    for i in (0, 1, 2):
        assert os.path.exists(os.path.join(markers, f"run_{i}.txt")), f"run {i} never completed"
    with open(os.path.join(markers, "attempt_0")) as f:
        assert len(f.read().split()) == 2  # the wedge and the retry
    counters = obs.metrics_snapshot()["counters"]
    assert counters["scheduler.timeouts"] == 1 and counters["scheduler.requeues"] == 1
    events = [json.loads(line) for path in glob.glob(str(tmp_path / "obs" / "*.jsonl"))
              for line in open(path)]
    requeues = [e for e in events if e.get("name") == "scheduler.requeue"]
    assert [(e["attrs"]["model_id"], e["attrs"]["platform"]) for e in requeues] == [(0, "cpu")]
    platforms = {e["pid"]: e.get("platform") for e in events if e.get("type") == "meta"}
    retry_pid = _read_marker(markers, 0)[2]
    assert platforms[retry_pid] == "cpu"


def test_wedged_retry_also_failing_reports_id(markers):
    with pytest.raises(RuntimeError) as exc_info:
        run_phase_parallel(
            "mnist", "_test_wedge", model_ids=[0, 1], num_workers=2,
            phase_kwargs={"marker_dir": markers, "wedge_ids": (0,), "always_wedge": True},
            run_timeout_s=3.0,
        )
    msg = str(exc_info.value)
    assert "run 0" in msg and "requeued once" in msg and "1/2" in msg
    assert os.path.exists(os.path.join(markers, "run_1.txt"))


def test_dead_worker_is_requeued(markers):
    run_phase_parallel(
        "mnist", "_test_die", model_ids=[0, 1, 2], num_workers=2,
        phase_kwargs={"marker_dir": markers, "die_ids": (1,)},
    )
    assert all(os.path.exists(os.path.join(markers, f"run_{i}.txt")) for i in (0, 1, 2))
    assert obs.metrics_snapshot()["counters"]["scheduler.worker_deaths"] == 1


def test_env_fault_plan_kills_a_worker_and_the_requeue_completes(markers, tmp_path, monkeypatch):
    plan = {"faults": [{"site": "worker.run", "kind": "die", "match": {"model_id": [2]},
                        "times": 1, "delay_s": 0.5}]}
    monkeypatch.setenv("TIP_FAULT_PLAN", json.dumps(plan))
    monkeypatch.setenv("TIP_FAULT_STATE", str(tmp_path / "fault_state"))
    run_phase_parallel("mnist", "_test_fault", model_ids=[0, 1, 2, 3], num_workers=2,
                       phase_kwargs={"marker_dir": markers})
    assert all(os.path.exists(os.path.join(markers, f"run_{i}.txt")) for i in range(4))
    with open(os.path.join(markers, "attempt_2")) as f:
        assert len(f.read().split()) == 1  # the kill fires before the phase body
    assert os.listdir(tmp_path / "fault_state") == ["fault0_model_id=2_0.claimed"]
    assert obs.metrics_snapshot()["counters"]["scheduler.requeues"] == 1


def test_group_unit_runs_members_on_one_worker(markers):
    run_phase_parallel("mnist", "_test_sleep", model_ids=[0, 1, 2, 3], num_workers=2,
                       group_size=4, phase_kwargs={"seconds": 0.05, "marker_dir": markers})
    assert len({_read_marker(markers, i)[2] for i in range(4)}) == 1


def test_mid_group_resume_replays_only_unjournaled_members(markers, tmp_path, monkeypatch):
    journal_path = str(tmp_path / "journal" / "runs.jsonl")
    monkeypatch.setenv("TIP_JOURNAL", journal_path)
    pre = RunJournal(journal_path, "mnist", "_test_sleep")
    pre.mark_done(0)
    pre.mark_done(2)
    run_phase_parallel("mnist", "_test_sleep", model_ids=[0, 1, 2, 3, 4], num_workers=1,
                       group_size=2, phase_kwargs={"seconds": 0.01, "marker_dir": markers})
    ran = sorted(int(f[len("run_"):-len(".txt")]) for f in os.listdir(markers)
                 if f.startswith("run_"))
    assert ran == [1, 3, 4]
    assert RunJournal(journal_path, "mnist", "_test_sleep").completed() == {0, 1, 2, 3, 4}
    assert obs.metrics_snapshot()["counters"]["scheduler.journal_skips"] == 2


def test_unknown_phase_rejected():
    with pytest.raises(ValueError, match="unknown phase"):
        run_phase_parallel("mnist", "no_such_phase", [0], num_workers=1)


def test_cli_workers_dispatch_through_the_scheduler(tmp_path, monkeypatch, capsys):
    calls = []

    def record(*args, **kwargs):
        calls.append((args, kwargs))

    monkeypatch.setenv("TIP_ASSETS", str(tmp_path / "assets"))
    monkeypatch.setattr(run_scheduler, "run_phase_parallel", record)
    assert cli.main(["--phase", "test_prio", "--case-study", "mnist", "--runs", "0-2",
                     "--workers", "2", "--device", "cpu"]) == 0
    assert "Done." in capsys.readouterr().out
    [(args, kwargs)] = calls
    assert args == ("mnist", "test_prio", [0, 1, 2], 2)
    assert kwargs["worker_platforms"] == ["cpu", "cpu"] and kwargs["group_size"] == 1
    assert kwargs["backend_flags"] == backend_flags()


@pytest.mark.parametrize("override, chips, want", [
    ("", 1, ["default"] * 3),
    ("", 4, ["default"] * 3),
    ("default,cpu", 1, ["default", "cpu", "default"]),
    ("", 0, None),
])
def test_card_phase_workers_reach_the_cpu_only_by_name(tmp_path, monkeypatch, capsys,
                                                      override, chips, want):
    import torch

    from simple_tip_tpu_torch.utils import device_watchdog

    calls = []
    monkeypatch.setenv("TIP_ASSETS", str(tmp_path / "assets"))
    monkeypatch.setenv("TIP_WORKER_PLATFORMS", override)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(device_watchdog, "ensure_responsive_backend", lambda: "cuda")
    monkeypatch.setattr(device_watchdog, "probe_local_chips", lambda: chips)
    monkeypatch.setattr(run_scheduler, "run_phase_parallel",
                        lambda *args, **kwargs: calls.append(kwargs["worker_platforms"]))
    rc = cli.main(["--phase", "test_prio", "--case-study", "mnist", "--runs", "0-2",
                   "--workers", "3"])
    if want is None:
        assert rc == 2 and calls == []
        assert "no CUDA card answered" in capsys.readouterr().err
    else:
        assert rc == 0 and calls == [want]


def test_real_phase_card_worker_death_is_not_requeued_onto_the_cpu(tmp_path, monkeypatch):
    """A card worker of ``test_prio`` dies at the ``worker.run`` seam: its
    run and the rest of the queue go to fresh ``default`` workers. There is
    no card here, so those attempts fail and the phase raises naming both
    runs, where a CPU fallback would have scored them."""
    plan = {"faults": [{"site": "worker.run", "kind": "die", "match": {"model_id": [0]},
                        "times": 1, "delay_s": 0.5}]}
    assets = tmp_path / "assets"
    monkeypatch.setenv("TIP_ASSETS", str(assets))
    monkeypatch.setenv("TIP_CASE_STUDY_PROVIDER", "test_torch_sched_provider:provide")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [TESTS_DIR, os.path.dirname(TESTS_DIR), os.environ.get("PYTHONPATH", "")]))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("TIP_FAULT_PLAN", json.dumps(plan))
    monkeypatch.setenv("TIP_FAULT_STATE", str(tmp_path / "fault_state"))
    monkeypatch.setenv("TIP_OBS_DIR", str(tmp_path / "obs"))
    for var in ("TIP_JOURNAL", "TIP_WORKER_PLATFORMS"):
        monkeypatch.delenv(var, raising=False)
    obs.reset_all()
    try:
        with pytest.raises(RuntimeError) as exc_info:
            run_phase_parallel("sched-mnist", "test_prio", model_ids=[0, 1], num_workers=1,
                               worker_platforms=["default"])
        msg = str(exc_info.value)
        assert "2/2 runs" in msg and "no CUDA device is visible" in msg
        counters = obs.metrics_snapshot()["counters"]
        assert counters["scheduler.worker_deaths"] == 1 and counters["scheduler.requeues"] == 1
        events = [json.loads(line) for path in glob.glob(str(tmp_path / "obs" / "*.jsonl"))
                  for line in open(path)]
    finally:
        obs.reset_all()
    requeues = [e for e in events if e.get("name") == "scheduler.requeue"]
    assert [(e["attrs"]["model_id"], e["attrs"]["platform"]) for e in requeues] == [(0, "default")]
    metas = [e for e in events if e.get("type") == "meta" and e.get("platform")]
    assert len(metas) == 3 and {e["platform"] for e in metas} == {"default"}
    records = [json.load(open(p)) for p in glob.glob(str(assets / "worker_modules" / "*.json"))]
    assert sorted(i for r in records for i in r["ids"]) == [0, 1]
    assert {r["platform"] for r in records} == {"default"}


# -- a real phase over spawned CPU workers ----------------------------------------


def _priorities(assets):
    folder = os.path.join(assets, "priorities")
    return {name: np.load(os.path.join(folder, name)) for name in sorted(os.listdir(folder))}


@pytest.fixture(scope="module")
def sched_runs(tmp_path_factory):
    """Two trained ``sched-mnist`` runs scored over two CPU workers and in
    process, each into its own ``TIP_ASSETS`` (caches off)."""
    from test_torch_sched_provider import provide

    root = tmp_path_factory.mktemp("sched")
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("TIP_CASE_STUDY_PROVIDER", "test_torch_sched_provider:provide")
        mp.setenv("PYTHONPATH", os.pathsep.join(
            [TESTS_DIR, os.path.dirname(TESTS_DIR), os.environ.get("PYTHONPATH", "")]))
        mp.setenv("OMP_NUM_THREADS", "1")
        for var in ("TIP_SA_CACHE_DIR", "TIP_COV_STATS_CACHE_DIR"):
            mp.setenv(var, "off")
        for var in ("TIP_FUSED_CHAIN", "TIP_CHAIN_GROUP", "TIP_JOURNAL", "TIP_FAULT_PLAN",
                    "TIP_WORKER_PLATFORMS", "TIP_OBS_DIR"):
            mp.delenv(var, raising=False)
        dirs = {}
        for name in ("workers", "inproc"):
            dirs[name] = str(root / name)
            mp.setenv("TIP_ASSETS", dirs[name])
            cs = provide("sched-mnist")
            if name == "workers":
                cs.train([0, 1], device="cpu")
                models = os.path.join(dirs[name], "models")
                result = cs.run_prio_eval([0, 1], device="cpu", num_workers=2)
                assert result is None
            else:
                shutil.copytree(models, os.path.join(dirs[name], "models"))
                cs.run_prio_eval([0, 1], device="cpu")
        yield dirs
    finally:
        mp.undo()


def test_prio_over_two_cpu_workers_equals_the_in_process_walk(sched_runs):
    got, want = _priorities(sched_runs["workers"]), _priorities(sched_runs["inproc"])
    assert sorted(got) == sorted(want) and len(got) == 2 * 2 * (1 + 5 + 2 * 13)
    for name in want:
        assert got[name].dtype == want[name].dtype and got[name].tobytes() == \
            want[name].tobytes(), name
    times = sorted(os.listdir(os.path.join(sched_runs["workers"], "times")))
    assert times == sorted(os.listdir(os.path.join(sched_runs["inproc"], "times")))


def test_workers_ran_on_the_cpu_without_jax(sched_runs):
    records = [json.load(open(p)) for p in
               glob.glob(os.path.join(sched_runs["workers"], "worker_modules", "*.json"))]
    assert sorted(i for r in records for i in r["ids"]) == [0, 1]
    assert all(r["platform"] == "cpu" for r in records)
    assert [r["forbidden"] for r in records] == [[]] * len(records)


def test_workers_match_the_jax_case_study(sched_runs, tmp_path, monkeypatch):
    from simple_tip_tpu.casestudies import base as jax_base
    from simple_tip_tpu.engine import surprise_handler as jax_surprise
    from simple_tip_tpu.models import MnistConvNet as JaxMnist
    from test_torch_sched_provider import SPEC

    for var, value in (("TIP_SA_POOL", "1"), ("TIP_SA_CACHE_DIR", "off"),
                       ("TIP_COV_STATS_CACHE_DIR", "off"), ("TIP_CAM_BACKEND", "auto")):
        monkeypatch.setenv(var, value)
    for var in ("TIP_FUSED_CHAIN", "TIP_COMPUTE_DTYPE", "TIP_CHAIN_GROUP"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(jax_surprise, "SA_VARIANTS", {"dsa": jax_surprise.SA_VARIANTS["dsa"]})
    jax_assets = tmp_path / "jax_assets"
    shutil.copytree(os.path.join(sched_runs["workers"], "models"), jax_assets / "models")
    monkeypatch.setenv("TIP_ASSETS", str(jax_assets))
    arrays = SPEC.loader()
    spec = jax_base.CaseStudySpec(
        name=SPEC.name, model_factory=JaxMnist, loader=lambda: arrays,
        train_cfg=None, nc_activation_layers=SPEC.nc_activation_layers,
        sa_activation_layers=SPEC.sa_activation_layers,
        prediction_badge_size=SPEC.prediction_badge_size, num_classes=SPEC.num_classes,
    )
    jax_base.CaseStudy(spec).run_prio_eval([0, 1])
    jax_obs.reset_all()

    got = _priorities(sched_runs["workers"])
    want = _priorities(str(jax_assets))
    assert set(got) <= set(want)
    for name, a in got.items():
        b = want[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        kind = name.split("_", 3)[3][: -len(".npy")]
        if kind == "uncertainty_VR":
            assert a.min() >= 0 and a.max() <= 0.9, name
        elif kind.startswith("uncertainty_"):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=name)
        elif kind == "dsa_scores":
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=0, err_msg=name)
        elif kind == "dsa_cam_order":
            # SC-CAM buckets the scores, so a score within rtol 1e-4 of a
            # bucket edge may move its row: the order is held as the port's
            # function of each side's scores (JAX's scores give JAX's order).
            scores = name.replace("_cam_order", "_scores")
            assert a.tobytes() == _sc_cam_order(got[scores]).tobytes(), name
            assert b.tobytes() == _sc_cam_order(want[scores]).tobytes(), name
        else:
            assert a.tobytes() == b.tobytes(), name
