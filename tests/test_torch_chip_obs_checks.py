"""``chip_smoke.py``'s phase 7f checks fail when they should, on the CPU.

- ``share_faults``: a dispatch graded at a share of a peak above
  ``OBS_SHARE_CAP`` (a wrong count) is found, and so is a program that
  cannot be graded: an unknown card's (no peak), one with no cost or no
  dispatch; a plain grade passes.
- ``trace_faults``: a trace with no device event, one whose device events
  lie outside the span's window and one without B1's kernel are each
  found; ``busy_share`` is the union of the device intervals in the window.
- ``store_faults``: a refresh with no rows, or with only TPU rows or rows
  without seconds, is found.
- ``plan_faults``: two plan files that differ, or one exit 3 beside an
  exit 0, are found; identical files or exit 3 twice pass.
- the whole phase rehearsed on the CPU (a small MNIST, seeded event
  streams as phases 7d and 7e write them, badges of 16): the store, the
  predict and plan commands, the alert tick and the graded walk pass, and
  the one fault is the trace's: the CPU has no device events.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from simple_tip_tpu_torch.bridge import glorot_params, params_from_jax
from simple_tip_tpu_torch.engine import run_program
from simple_tip_tpu_torch.obs import devicemeter
from test_torch_obs_store import write_stream
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

H100 = devicemeter.resolve_peaks("gpu", "NVIDIA H100 80GB HBM3")
COST = {"flops": 2.5e9, "bytes_accessed": 1.5e8}


def _program(fastest_s, cost=COST):
    return {"cost": cost, "fastest_s": fastest_s, "dispatch_s": {"p50": fastest_s}}


def test_share_faults():
    assert chip_smoke.share_faults({"chain": _program(1e-3)}, H100) == []
    # 2.5e9 FLOPs in 10 us is 250 TFLOP/s: above the card's 165
    heavy = {"flops": 2.5e9, "bytes_accessed": 1e7}
    faults = chip_smoke.share_faults({"chain": _program(1e-5, heavy)}, H100)
    assert len(faults) == 1 and "mfu" in faults[0] and "above 1.05" in faults[0]
    # 1.5e8 bytes in 40 us is 3.75 TB/s: above HBM3's 3.35
    wide = {"flops": 1e6, "bytes_accessed": 1.5e8}
    faults = chip_smoke.share_faults({"c": _program(4e-5, wide)}, H100)
    assert len(faults) == 1 and "hbm_frac" in faults[0]
    # at the cap it passes, just above it fails
    at_cap = heavy["flops"] / (1.05 * H100["flops_per_s"])
    assert chip_smoke.share_faults({"c": _program(at_cap * 1.0001, heavy)}, H100) == []
    assert chip_smoke.share_faults({"c": _program(at_cap * 0.999, heavy)}, H100)
    unknown = devicemeter.resolve_peaks("gpu", "NVIDIA H100 PCIe")
    faults = chip_smoke.share_faults({"chain": _program(1e-3)}, unknown)
    assert len(faults) == 2 and all("cannot be graded" in f for f in faults)
    assert chip_smoke.share_faults({"c": _program(1e-3, cost=None)}, H100)
    assert chip_smoke.share_faults({"c": _program(None)}, H100)
    assert len(chip_smoke.share_faults({"c": _program(1e-3, cost={"flops": 1e6})}, H100)) == 1
    assert chip_smoke.share_faults({}, H100) == ["no program was graded"]


def _kernel(ts, dur, name="void at::native::elementwise_kernel", cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 9_000_000, "tid": 7, "ts": ts, "dur": dur}


B1 = "(anonymous namespace)::mnist_forward_kernel(float const*, float const*)"


def test_trace_faults_and_busy_share():
    window = (1_000.0, 2_000.0)
    host = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 1, "ts": 1_100.0,
             "dur": 50.0}]
    good = host + [_kernel(1_100.0, 100.0, B1), _kernel(1_150.0, 100.0),
                   _kernel(1_500.0, 10.0, "Memset (Device)", "gpu_memset")]
    assert chip_smoke.trace_faults(good, window) == []
    assert "no device kernel event" in chip_smoke.trace_faults(host, window)[0]
    outside = host + [_kernel(2_500.0, 100.0, B1), _kernel(100.0, 50.0, B1)]
    assert "no device kernel event" in chip_smoke.trace_faults(outside, window)[0]
    no_b1 = host + [_kernel(1_100.0, 100.0)]
    assert "mnist_forward_kernel" in chip_smoke.trace_faults(no_b1, window)[0]
    inside = chip_smoke.device_events(good, window)
    assert len(inside) == 3
    # [1100, 1250] and [1500, 1510] of a 1000 us window
    assert chip_smoke.busy_share(inside, window) == pytest.approx(0.16)
    straddling = [_kernel(900.0, 200.0), _kernel(1_950.0, 100.0)]
    assert chip_smoke.busy_share(straddling, window) == pytest.approx(0.15)
    assert chip_smoke.busy_share([], window) == 0.0


def _row(platform, seconds):
    return {"platform": platform, "seconds": seconds, "phase": "test_prio"}


def test_store_faults():
    assert chip_smoke.store_faults([_row("default", 3.2), _row("tpu", 1.0)]) == []
    assert chip_smoke.store_faults([_row("cpu", 0.5)]) == []
    assert chip_smoke.store_faults([])
    assert chip_smoke.store_faults([_row("tpu", 1.0), _row("TPU", 2.0)])
    assert chip_smoke.store_faults([_row("default", 0.0), _row(None, 4.0),
                                    _row("default", None)])


def test_plan_faults():
    assert chip_smoke.plan_faults([0, 0], [b"{plan}", b"{plan}"]) == []
    assert chip_smoke.plan_faults([3, 3], [None, None]) == []
    assert "differ" in chip_smoke.plan_faults([0, 0], [b"{plan a}", b"{plan b}"])[0]
    assert chip_smoke.plan_faults([0, 3], [b"{plan}", None])
    assert chip_smoke.plan_faults([0, 0], [None, None])
    assert chip_smoke.plan_faults([2, 2], [None, None])


def test_phase_rehearsed_on_the_cpu(tmp_path, monkeypatch):
    for name, seed, platform in (("sched_obs", 1, "default"), ("study_obs", 2, "cpu"),
                                 (os.path.join("sched_drills", "obs"), 3, "default")):
        write_stream(str(tmp_path / name), seed, 5000 + seed, platform)
    rng = np.random.default_rng(0)
    data = ((rng.random((96, 28, 28, 1), dtype=np.float32), rng.integers(0, 10, 96)),
            (rng.random((40, 28, 28, 1), dtype=np.float32), rng.integers(0, 10, 40)))
    monkeypatch.setattr(chip_smoke, "OBS_B1_ROWS", 20)
    monkeypatch.setattr(run_program, "PROFILE_BADGE_SIZE", 16)
    monkeypatch.setenv("TIP_COV_STATS_CACHE_DIR", "off")
    for var in ("TIP_OBS_DIR", "TIP_PROFILE_DIR", "TIP_ALERT_RULES", "TIP_OBS_INDEX"):
        monkeypatch.delenv(var, raising=False)
    params = params_from_jax(glorot_params(0, "mnist"))
    with pytest.raises(AssertionError) as err:
        chip_smoke.run_obs_phase(params, data, torch.device("cpu"), str(tmp_path), "cpu")
    message = str(err.value)
    assert message.startswith("observability plane: no device kernel event")
    assert ";" not in message  # the trace's is the only fault
    plans = [tmp_path / "plan_a.json", tmp_path / "plan_b.json"]
    assert plans[0].read_bytes() == plans[1].read_bytes()
    assert (tmp_path / "alerts" / "alert_state.json").exists()
    traces = list((tmp_path / "profile" / "chain_walk").iterdir())
    assert len(traces) == 1 and traces[0].name.endswith(".pt.trace.json")
