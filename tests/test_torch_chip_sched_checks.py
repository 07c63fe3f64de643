"""``chip_smoke.py``'s phase 7d checks fail when they should, on the CPU.

- ``artifact_faults``: a scheduled run's artifacts against the in-process
  walk's; one changed byte, a missing file and an extra one are each found,
  while differing seconds in the time records are not a fault.
- ``sched_faults``: on worker records as ``worker_records`` reads them from
  the event streams, a clean pair of card workers passes; a worker on the
  CPU, zero B1 launches in one worker, a run on no worker or on two, a
  failed run and two workers that never ran at once are each found.
- ``resume_faults``: a resume that re-ran a journaled run, or skipped a
  missing one, is found.
- ``worker_records`` reads platforms, runs and the last flushed launches
  from stream records (the parent's stream, which has no worker index, is
  left out).
"""

import copy
import json
import os
import pickle

import numpy as np
import pytest

import chip_smoke
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

KERNELS = ("fused_mnist_forward", "dsa_nearest")


def _bus(root, run, seconds=1.0):
    os.makedirs(os.path.join(root, "priorities"), exist_ok=True)
    os.makedirs(os.path.join(root, "times"), exist_ok=True)
    rng = np.random.default_rng(run)
    for ds in ("nominal", "ood"):
        np.save(os.path.join(root, "priorities", f"mnist_{ds}_{run}_dsa_scores.npy"),
                rng.random(8))
        np.save(os.path.join(root, "priorities", f"mnist_{ds}_{run}_is_misclassified.npy"),
                rng.random(8) > 0.5)
        with open(os.path.join(root, "times", f"mnist_{ds}_{run}_dsa"), "wb") as f:
            pickle.dump([seconds, seconds, 0.0, 0.0], f)


@pytest.fixture()
def buses(tmp_path):
    got, want0, want1 = (str(tmp_path / n) for n in ("sched", "phase7", "inproc"))
    for root, runs, seconds in ((got, (0, 1), 2.0), (want0, (0,), 1.0), (want1, (1,), 1.0)):
        for run in runs:
            _bus(root, run, seconds)
    return got, {0: want0, 1: want1}


def test_equal_artifacts_pass_whatever_their_seconds(buses):
    got, want = buses
    assert chip_smoke.artifact_faults("mnist", got, want) == []


def test_a_changed_artifact_byte_is_found(buses):
    got, want = buses
    path = os.path.join(got, "priorities", "mnist_ood_1_dsa_scores.npy")
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        last = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([last[0] ^ 1]))
    assert chip_smoke.artifact_faults("mnist", got, want) == [
        "run 1: mnist_ood_1_dsa_scores.npy differs from the in-process walk's"]


@pytest.mark.parametrize("change", ["missing", "extra"])
def test_a_missing_or_extra_artifact_is_found(buses, change):
    got, want = buses
    if change == "missing":
        os.remove(os.path.join(got, "priorities", "mnist_nominal_0_dsa_scores.npy"))
    else:
        np.save(os.path.join(got, "priorities", "mnist_nominal_0_pc-lsa_scores.npy"), np.zeros(8))
    [fault] = chip_smoke.artifact_faults("mnist", got, want)
    assert fault.startswith("run 0 priorities:")


def _workers():
    return {
        101: {"platform": "default", "worker": "0", "runs": {0: (10.0, 40.0)}, "errors": [],
              "launches": {"fused_mnist_forward": 2, "dsa_nearest": 9}},
        102: {"platform": "default", "worker": "1", "runs": {1: (11.0, 41.0)}, "errors": [],
              "launches": {"fused_mnist_forward": 2, "dsa_nearest": 9}},
    }


def test_two_card_workers_pass():
    assert chip_smoke.sched_faults(_workers(), (0, 1), KERNELS) == []


def test_a_worker_on_the_cpu_is_found():
    workers = _workers()
    workers[102]["platform"] = "cpu"
    [fault] = chip_smoke.sched_faults(workers, (0, 1), KERNELS)
    assert "on platform cpu" in fault


def test_zero_b1_launches_in_one_worker_is_found():
    workers = _workers()
    workers[101]["launches"]["fused_mnist_forward"] = 0
    assert chip_smoke.sched_faults(workers, (0, 1), KERNELS) == [
        "worker 101 launched fused_mnist_forward 0 times"]
    del workers[101]["launches"]["fused_mnist_forward"]
    assert chip_smoke.sched_faults(workers, (0, 1), KERNELS) == [
        "worker 101 launched fused_mnist_forward 0 times"]


@pytest.mark.parametrize("fault", ["no worker", "two workers", "error", "apart"])
def test_runs_placed_wrong_are_found(fault):
    workers = _workers()
    if fault == "no worker":
        workers[102]["runs"] = {}
    elif fault == "two workers":
        workers[102]["runs"][0] = (11.0, 30.0)
    elif fault == "error":
        workers[101]["errors"] = ["RuntimeError('boom')"]
    else:
        workers[102]["runs"][1] = (60.0, 30.0)  # starts after run 0 ended
    assert chip_smoke.sched_faults(workers, (0, 1), KERNELS) != []


def test_resume_faults():
    assert chip_smoke.resume_faults({4: 1, 5: 1}, {0, 1, 2, 3}, {4, 5}) == []
    assert chip_smoke.resume_faults({2: 1, 4: 1, 5: 1}, {0, 1, 2, 3}, {4, 5}) == [
        "journaled run 2 ran again (1 attempts)"]
    assert chip_smoke.resume_faults({4: 1}, {0, 1, 2, 3}, {4, 5}) == [
        "missing run 5 ran 0 times in the resume"]


def test_worker_records_read_the_streams(tmp_path):
    records = [
        {"type": "meta", "pid": 1},  # the scheduler's own stream
        {"type": "event", "pid": 1, "name": "scheduler.requeue", "attrs": {"model_id": 0}},
        {"type": "meta", "pid": 7, "worker": "0", "platform": "default"},
        {"type": "span", "pid": 7, "name": "run", "ts": 5.0, "dur": 2.5,
         "attrs": {"model_id": 1}},
        {"type": "metrics", "pid": 7, "gauges": {"kernel.dsa_nearest.launches": 3}},
        {"type": "metrics", "pid": 7, "gauges": {"kernel.dsa_nearest.launches": 4,
                                                 "kernel.fused_mnist_forward.launches": 1,
                                                 "device.0.peak_bytes_in_use": 9}},
    ]
    with open(tmp_path / "events-7-x.jsonl", "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
        f.write('{"type": "span", "pid": 7, "na')  # a torn tail
    got = chip_smoke.worker_records(chip_smoke.read_streams(str(tmp_path)))
    assert got == {7: {"platform": "default", "worker": "0", "runs": {1: (5.0, 2.5)},
                       "errors": [],
                       "launches": {"dsa_nearest": 4, "fused_mnist_forward": 1}}}
    assert chip_smoke.sched_faults(copy.deepcopy(got), (1,), KERNELS, concurrent=1) == []
