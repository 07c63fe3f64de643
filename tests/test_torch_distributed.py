"""The port's multi-host control plane and full-study command on the CPU.

- ``host_local_model_ids`` equals the JAX package's split for every
  (runs, processes, rank) of a grid.
- ``barrier`` is a rendezvous: two gloo ranks (a ``FileStore`` under
  ``tmp_path``) meet twice at one name, and a rank alone at a barrier
  raises ``TimeoutError`` naming it.
- ``python -m simple_tip_tpu_torch.full_study`` as two hosts over a
  localhost coordinator (``--device cpu``, a 24-image MNIST, phases
  training and evaluation, runs 0-2), as ``tests/test_distributed_multiprocess.py``
  runs the JAX script: host 0 takes 2 of 3 runs and host 1 one, every
  checkpoint lands, only host 0 aggregates and only after both hosts left
  their training (the event streams); ``--plan`` and ``TIP_PLAN_FILE``
  apply a valid plan (its knobs in the environment before the parser reads
  them, its id to the study) and exit 2 on an invalid one or one naming a
  knob the port does not read.
"""

import importlib.util
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import torch_rank_cases
from simple_tip_tpu.parallel import distributed as jax_distributed
from simple_tip_tpu_torch import full_study
from simple_tip_tpu_torch.data import synthetic
from simple_tip_tpu_torch.parallel import distributed
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n_runs", [0, 1, 3, 7, 100])
@pytest.mark.parametrize("n_proc", [1, 2, 3, 5, 8])
def test_host_local_model_ids_equal_jax(monkeypatch, n_runs, n_proc):
    ids = list(range(10, 10 + n_runs))
    for rank in range(n_proc):
        monkeypatch.setattr(jax_distributed.jax, "process_count", lambda: n_proc)
        monkeypatch.setattr(jax_distributed.jax, "process_index", lambda: rank)
        monkeypatch.setattr(distributed, "process_count", lambda: n_proc)
        monkeypatch.setattr(distributed, "process_index", lambda: rank)
        assert distributed.host_local_model_ids(ids) == jax_distributed.host_local_model_ids(ids)


def test_single_process_helpers_need_no_group():
    assert distributed.process_count() == 1 and distributed.process_index() == 0
    assert distributed.host_local_model_ids(range(7)) == list(range(7))
    distributed.barrier("alone", timeout_s=0.01)  # no-op
    distributed.initialize(None)  # no-op


def test_barrier_rendezvous_and_timeout(tmp_path):
    got = distributed.run_ranks(torch_rank_cases.barrier_cases, 2, f"file://{tmp_path}/store",
                                args=(0.5,), timeout_s=120)
    assert got[1] == "skipped"
    assert got[0].startswith("barrier 'alone': 1/2 processes arrived within 0.5 s"), got[0]


def test_a_failing_rank_raises_with_its_traceback(tmp_path):
    with pytest.raises(RuntimeError, match="rank 0 of 2 failed") as e:
        distributed.run_ranks(torch_rank_cases.barrier_cases, 2, f"file://{tmp_path}/store",
                              args=("not a number",), timeout_s=120)
    assert "TypeError" in str(e.value)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _streams(obs_root) -> list:
    records = []
    for dirpath, _, names in os.walk(obs_root):
        for name in names:
            if name.startswith("events-"):
                with open(os.path.join(dirpath, name)) as f:
                    records += [json.loads(line) for line in f]
    return records


def test_full_study_two_hosts_shard_and_barrier(tmp_path):
    data_dir, assets = tmp_path / "datasets", tmp_path / "assets"
    data_dir.mkdir()
    (xtr, ytr), (xte, yte) = synthetic.image_classification(3, 24, 10, (28, 28, 1))
    np.savez(data_dir / "mnist.npz", x_train=np.round(xtr[..., 0] * 255).astype(np.uint8),
             y_train=ytr, x_test=np.round(xte[..., 0] * 255).astype(np.uint8), y_test=yte)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith("TIP_")}
    env.update(TIP_DATA_DIR=str(data_dir), TIP_ASSETS=str(assets), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "simple_tip_tpu_torch.full_study", "--case-studies", "mnist",
         "--runs", "0-2", "--phases", "training,evaluation", "--device", "cpu",
         "--coordinator", f"localhost:{port}", "--num-processes", "2", "--process-id", str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"host {i} failed:\n{out[-3000:]}"
    assert "host 0/2: 2/3 runs" in outs[0]
    assert "host 1/2: 1/3 runs" in outs[1]
    for run in range(3):
        assert (assets / "models" / "mnist" / f"{run}.msgpack").exists()
    assert "[evaluation:test_prio]" in outs[0]
    assert "[evaluation:" not in outs[1]
    assert (assets / "results" / "apfds.csv").exists()
    records = _streams(assets / "obs")
    trained = [r["ts"] + r["dur"] for r in records
               if r.get("type") == "span" and r["name"] == "training"]
    evaluated = [r["ts"] for r in records if r.get("type") == "span" and r["name"] == "evaluation"]
    barriers = sorted((r["attrs"]["rank"], r["attrs"]["barrier"]) for r in records
                      if r.get("name") == "barrier")
    assert len(trained) == 2 and len(evaluated) == 4 and min(evaluated) >= max(trained)
    assert barriers == [(rank, f"full_study_{when}_evaluation")
                        for rank in (0, 1) for when in ("post", "pre")]
    roots = [r for r in records if r.get("type") == "span" and r["name"] == "full_study"]
    assert sorted(r["attrs"]["host"] for r in roots) == [0, 1]


def test_plans_are_refused(monkeypatch, capsys, tmp_path):
    """Invalid plans are refused with exit 2 before anything runs; a valid
    one is applied: its assignment is in the environment before the parser
    reads ``TIP_NUM_WORKERS``, and its id reaches the study."""
    from simple_tip_tpu.plan import plan as jax_plan
    from simple_tip_tpu_torch.plan import plan as plan_mod

    monkeypatch.setenv("TIP_ASSETS", str(tmp_path / "assets"))
    for var in (full_study.PLAN_FILE_ENV, "TIP_NUM_WORKERS", "TIP_CHAIN_GROUP"):
        # set, then unset: the plan writes these into os.environ, and the
        # monkeypatch restores each to unset after the test
        monkeypatch.setenv(var, "")
        monkeypatch.delenv(var)
    studies = []
    monkeypatch.setattr(full_study, "run_study", lambda *a, **kw: studies.append((a, kw)))
    assert full_study.main(["--plan", str(tmp_path / "plan.json"), "--device", "cpu"]) == 2
    assert "not a valid plan" in capsys.readouterr().err
    unported = jax_plan.save(
        jax_plan.build({"sa_pool": "2"}, {"by_phase": {}}, {"phases": ["x"]}, {}, {}),
        str(tmp_path / "jax_plan.json"))
    monkeypatch.setenv(full_study.PLAN_FILE_ENV, unported)
    assert full_study.main(["--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "'sa_pool'" in err and "not ported" in err
    assert not (tmp_path / "assets").exists() and not studies

    doc = plan_mod.build({"workers": 4, "group_size": 2}, {"by_phase": {}}, {"phases": ["x"]},
                         {}, {})
    path = plan_mod.save(doc, str(tmp_path / "plan.json"))
    monkeypatch.delenv(full_study.PLAN_FILE_ENV)
    assert full_study.main(["--plan", path, "--device", "cpu", "--phases", "training",
                            "--case-studies", "mnist", "--runs", "0"]) == 0
    assert f"plan {doc['plan_id']}: applied group_size=2,workers=4" in capsys.readouterr().out
    (phases, case_studies, runs, device, workers), kw = studies[0]
    assert workers == 4 and kw == {"plan_id": doc["plan_id"]}
    assert os.environ["TIP_CHAIN_GROUP"] == "2" and os.environ["TIP_NUM_WORKERS"] == "4"
    assert os.environ[full_study.PLAN_FILE_ENV] == path


def test_partial_multi_host_flags_are_refused(capsys):
    with pytest.raises(SystemExit) as e:
        full_study.main(["--device", "cpu", "--num-processes", "2"])
    assert e.value.code == 2
    assert "all three" in capsys.readouterr().err


def test_phases_and_defaults_equal_the_jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_full_study", os.path.join(ROOT, "scripts", "full_study.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    assert full_study.ALL_PHASES == module.ALL_PHASES
    assert full_study.DEFAULT_PHASES == module.DEFAULT_PHASES


def _study_records(module, folder, monkeypatch):
    monkeypatch.setenv("TIP_OBS_DIR", str(folder))
    monkeypatch.delenv("TIP_OBS_ROOT", raising=False)
    module.reset()
    with module.study_root("full_study", host=0, runs=2) as root:
        pinned = os.environ.get("TIP_OBS_ROOT")
        with module.span("test_prio", cs="imdb"):
            pass
        root.set(actual_s=1.5)
    assert "TIP_OBS_ROOT" not in os.environ
    module.reset()
    records = []
    for name in sorted(os.listdir(folder)):
        with open(os.path.join(folder, name)) as f:
            records += [json.loads(line) for line in f]
    return pinned, [r for r in records if r["type"] == "span"]


def test_study_root_matches_the_jax_tracer(monkeypatch, tmp_path):
    """The port's ``obs.study_root`` writes the JAX package's records: the
    root span (``kind: study_root``) pins its id into ``TIP_OBS_ROOT`` while
    open, and a span opened inside is its child."""
    from simple_tip_tpu.obs import tracer as jax_tracer
    from simple_tip_tpu_torch.obs import tracer

    got = {label: _study_records(module, tmp_path / label, monkeypatch)
           for label, module in (("port", tracer), ("jax", jax_tracer))}
    for pinned, (child, root) in got.values():
        assert pinned == root["id"] and child["parent"] == root["id"]

    def shape(rec):
        return (rec["name"], rec["depth"], sorted(rec), rec.get("attrs"))

    assert [shape(r) for r in got["port"][1]] == [shape(r) for r in got["jax"][1]]
    tracer.reset()
    monkeypatch.delenv("TIP_OBS_DIR")
    assert tracer.study_root("x") is tracer._NOOP
