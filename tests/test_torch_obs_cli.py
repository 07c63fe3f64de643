"""The port's inspection CLI, regression gates, live views and splice
(``simple_tip_tpu_torch/obs/cli.py``, ``regress.py``, ``live.py``,
``splice.py``) against the JAX package's.

Every subcommand runs in both packages on the same operands (the repo's
obs fixtures, seeded event streams, a seeded index): the exit codes
(0 ok / 1 regression or firing / 2 bad input / 3 nothing comparable) and
the standard output are equal. ``splice(events, t0)`` is equal on a
torch Chrome trace: a synthetic one shaped as ``torch.profiler`` writes it
(host ops, kernels on device pid 0, metadata), and a real one that
``utils/profiling.maybe_trace`` writes on the CPU under ``TIP_PROFILE_DIR``.
The deliberate difference: ``obs predict`` over an index with TPU rows
leaves them out of the fit and says so.
"""

import json
import os
import shutil

import pytest
import torch

import simple_tip_tpu.obs as jax_obs
import simple_tip_tpu_torch.obs as obs
from simple_tip_tpu.obs import regress as jax_regress
from simple_tip_tpu.obs import splice as jax_splice
from simple_tip_tpu.obs.cli import load_events as jax_load_events
from simple_tip_tpu.obs.cli import main as jax_main
from simple_tip_tpu_torch.obs import regress, splice
from simple_tip_tpu_torch.obs.cli import load_events
from simple_tip_tpu_torch.obs.cli import main
from simple_tip_tpu_torch.utils import maybe_trace
from test_torch_obs_store import seeded_rows, seeded_runs
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")
TRACE = os.path.join(FIX, "obs_trace")
REG = os.path.join(FIX, "obs_regress")
TREND = [os.path.join(FIX, "obs_trend", f"t0{i}_stable.json") for i in range(1, 5)]
HOST = [os.path.join(FIX, "host_phase_trend", f"hp0{i}_stable.json") for i in range(1, 5)]
MFU = [os.path.join(FIX, "mfu_trend", f"m0{i}.json") for i in range(1, 5)]
AUDIT = [os.path.join(FIX, "obs_audit", f"run{i}") for i in range(1, 6)]

CASES = {
    "summary": ["summary", TRACE],
    "summary_json": ["summary", TRACE, "--json"],
    "summary_phase": ["summary", TRACE, "--phase", "test_prio"],
    "check": ["check", TRACE],
    "regress_same": ["regress", os.path.join(REG, "base"), os.path.join(REG, "base")],
    "regress_slow": ["regress", os.path.join(REG, "base"), os.path.join(REG, "slow")],
    "regress_slow_loose": ["regress", os.path.join(REG, "base"), os.path.join(REG, "slow"),
                           "--max-growth", "10"],
    "regress_degraded": ["regress", os.path.join(REG, "bench_base.json"),
                         os.path.join(REG, "bench_degraded.json")],
    "regress_json": ["regress", os.path.join(REG, "base"), os.path.join(REG, "slow"), "--json"],
    "regress_garbage": ["regress", os.path.join(TRACE, "summary.golden.txt"), TRACE],
    "trend_stable": ["trend", *TREND],
    "trend_drift": ["trend", *TREND, os.path.join(FIX, "obs_trend", "t05_drift.json")],
    "trend_degraded": ["trend", *TREND, os.path.join(FIX, "obs_trend", "t06_degraded.json")],
    "trend_thin": ["trend", *TREND[:2]],
    "trend_host": ["trend", *HOST, os.path.join(FIX, "host_phase_trend", "hp05_drift.json")],
    "trend_mfu_stable": ["trend", *MFU, os.path.join(FIX, "mfu_trend", "m05_stable.json")],
    "trend_mfu_drop": ["trend", *MFU, os.path.join(FIX, "mfu_trend", "m05_drop.json")],
    "trend_audit": ["trend", *AUDIT],
    "roofline_doc": ["roofline", MFU[0]],
    "roofline_json": ["roofline", *MFU[:2], "--json"],
    "roofline_empty": ["roofline", TRACE],
    "tail": ["tail", TRACE],
    "tail_max": ["tail", TRACE, "--max-events", "3"],
    "top": ["top", TRACE, "--once"],
    "audit": ["audit", AUDIT[0]],
    "audit_json": ["audit", *AUDIT[:2], "--json"],
    "audit_nothing": ["audit", TRACE],
}


@pytest.fixture(autouse=True)
def _isolation(tmp_path, monkeypatch):
    monkeypatch.setenv("TIP_ASSETS", str(tmp_path / "assets"))
    for var in ("TIP_OBS_DIR", "TIP_PROFILE_DIR", "TIP_OBS_INDEX", "TIP_PLAN_FILE"):
        monkeypatch.delenv(var, raising=False)
    obs.reset_all()
    jax_obs.reset_all()
    yield
    obs.reset_all()
    jax_obs.reset_all()


def both(argv, capsys):
    """(exit code, stdout) of each package's CLI on ``argv``."""
    capsys.readouterr()
    got = (main(list(argv)), capsys.readouterr().out)
    want = (jax_main(list(argv)), capsys.readouterr().out)
    return got, want


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_commands_equal_jax(case, capsys):
    got, want = both(CASES[case], capsys)
    assert got == want
    expected_rc = {"check": 0, "regress_same": 0, "regress_slow": 1, "regress_degraded": 1,
                   "regress_garbage": 2, "trend_stable": 0, "trend_drift": 1,
                   "trend_degraded": 1, "trend_thin": 3, "trend_mfu_drop": 1,
                   "roofline_empty": 3, "audit_nothing": 3}
    if case in expected_rc:
        assert got[0] == expected_rc[case]


def test_export_and_splice_equal_jax(tmp_path, capsys):
    for flags in ([], ["--splice-xla"]):
        out, jax_out = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
        rc = main(["export", TRACE, "-o", out, *flags])
        assert rc == jax_main(["export", TRACE, "-o", jax_out, *flags]) == 0
        with open(out) as f, open(jax_out) as g:
            assert json.load(f) == json.load(g)


def test_runs_and_predict_equal_jax(tmp_path, capsys):
    roots = seeded_runs(str(tmp_path / "runs"))
    got, want = both(["runs", *roots, "--index", str(tmp_path / "i1")], capsys)
    assert got == want and got[0] == 0 and "audit.test_prio" in got[1]
    idx = str(tmp_path / "i2")
    os.makedirs(idx)
    with open(os.path.join(idx, "index.jsonl"), "w") as f:
        for row in seeded_rows(2):
            f.write(json.dumps(row, sort_keys=True) + "\n")
    for extra in ([], ["--json"], ["--platform", "cpu", "--workers", "4", "--batch", "8192"]):
        argv = ["predict", "--phases", "test_prio,sa_fit.total,nope", "--runs", "100",
                "--index", idx, *extra]
        assert both(argv, capsys)[0] == both(argv, capsys)[1]
    empty = str(tmp_path / "empty")
    assert both(["predict", "--phases", "x", "--runs", "1", "--index", empty, "--json"],
                capsys)[0][0] == 3


def test_predict_leaves_tpu_rows_out(tmp_path, capsys):
    idx = str(tmp_path / "idx")
    os.makedirs(idx)
    shutil.copy(os.path.join(FIX, "plan_corpus", "index.jsonl"), idx)
    capsys.readouterr()
    rc = main(["predict", "--phases", "test_prio", "--runs", "10", "--index", idx])
    out = capsys.readouterr().out
    assert "left out of the fit" in out and "tpu" in out
    assert rc in (0, 3)


def test_regress_snapshots_and_baselines_equal_jax():
    for target in (os.path.join(REG, "base"), os.path.join(REG, "bench_base.json"), *TREND,
                   HOST[0], MFU[0], AUDIT[0]):
        if os.path.isdir(target) and not os.listdir(target)[0].startswith("events"):
            continue
        assert regress.load_snapshot(target) == jax_regress.load_snapshot(target)
    base = regress.load_snapshot(os.path.join(REG, "base"))
    slow = regress.load_snapshot(os.path.join(REG, "slow"))
    assert regress.compare(base, slow) == jax_regress.compare(base, slow)
    snaps = [regress.load_snapshot(p) for p in TREND]
    assert regress.trend(snaps) == jax_regress.trend(snaps)


def _torch_like_trace(path: str, origin_us: float) -> None:
    """A Chrome trace shaped as ``torch.profiler`` writes one on the card."""
    events = [
        {"ph": "M", "name": "process_name", "pid": 4242, "tid": 0, "args": {"name": "python"}},
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0, "args": {"name": "GPU 0"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7, "args": {"name": "stream 7"}},
        {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)", "pid": "Spans", "tid": "x",
         "ts": origin_us, "dur": 900.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 4242, "tid": 4242,
         "ts": origin_us + 10.5, "dur": 40.25},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 4242,
         "tid": 4242, "ts": origin_us + 20.0, "dur": 5.0},
        {"ph": "X", "cat": "kernel", "name": "(anonymous namespace)::mnist_forward_kernel(float const*)",
         "pid": 0, "tid": 7, "ts": origin_us + 30.125, "dur": 217.44,
         "args": {"device": 0, "stream": 7}},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "pid": 0, "tid": 7,
         "ts": origin_us + 300.0, "dur": 2.0},
        {"ph": "f", "cat": "ac2g", "name": "ac2g", "id": 1, "pid": 0, "tid": 7,
         "ts": origin_us + 30.125},
    ]
    with open(path, "w") as f:
        json.dump({"schemaVersion": 1, "traceEvents": events,
                   "baseTimeNanoseconds": 1700000000000000000}, f)


def test_splice_of_a_torch_trace_equals_jax(tmp_path):
    trace_dir = tmp_path / "prof" / "chain_walk"
    trace_dir.mkdir(parents=True)
    _torch_like_trace(str(trace_dir / "trace-1-0.pt.trace.json"), 1477278564876.314)
    (tmp_path / "prof" / "other").mkdir()
    host = [
        {"type": "span", "name": "chain_walk", "ts": 101.0, "dur": 1.0, "pid": 42, "tid": 1,
         "id": "42:1", "depth": 0,
         "attrs": {"kind": "phase", "xla_trace_dir": str(trace_dir), "xla_started_ts": 101.25}},
        {"type": "span", "name": "other", "ts": 103.0, "dur": 1.0, "pid": 42, "tid": 1,
         "id": "42:2", "depth": 0, "attrs": {"xla_trace_dir": str(tmp_path / "prof" / "other")}},
    ]
    got = splice.splice(host, 100.0)
    assert got == jax_splice.splice(host, 100.0)
    events, report = got
    kernel = next(e for e in events if e.get("cat") == "kernel")
    assert kernel["ts"] == 1_250_000 + 30 and kernel["pid"] >= splice.XLA_PID_BASE
    assert any(line.startswith("spliced trace-1-0.pt.trace.json") for line in report)
    assert any(line.startswith("skip 'other'") for line in report)
    assert splice.find_trace_files(str(tmp_path / "prof")) == \
        jax_splice.find_trace_files(str(tmp_path / "prof"))


def test_maybe_trace_writes_a_spliceable_torch_trace(tmp_path, monkeypatch):
    """On the CPU: the phase span carries the JAX attribute names, the
    profiler's Chrome trace lands under TIP_PROFILE_DIR/<label>/, and both
    packages' splice put its events under the span."""
    monkeypatch.setenv("TIP_OBS_DIR", str(tmp_path / "run"))
    monkeypatch.setenv("TIP_PROFILE_DIR", str(tmp_path / "prof"))
    obs.reset_all()
    with maybe_trace("walk"):
        a = torch.ones(64, 64)
        (a @ a).sum()
    obs.reset_all()  # flush and close the stream
    events, files, _bad = load_events(str(tmp_path / "run"))
    span = next(r for r in events if r.get("type") == "span" and r["name"] == "walk")
    attrs = span["attrs"]
    assert attrs["kind"] == "phase" and attrs["xla_trace_dir"] == str(tmp_path / "prof" / "walk")
    assert span["ts"] <= attrs["xla_started_ts"] <= span["ts"] + span["dur"]
    traces = splice.find_trace_files(attrs["xla_trace_dir"])
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
    assert splice.load_trace_events(traces[0])
    t0 = min(r["ts"] for r in events if isinstance(r.get("ts"), (int, float)))
    spliced, report = splice.splice(events, t0)
    assert (spliced, report) == jax_splice.splice(jax_load_events(str(tmp_path / "run"))[0], t0)
    ops = [e for e in spliced if e.get("cat") == "cpu_op"]
    assert any("mm" in e["name"] for e in ops)
    start_us = (attrs["xla_started_ts"] - t0) * 1e6
    assert min(e["ts"] for e in spliced if "ts" in e) == pytest.approx(start_us, abs=1)


def test_maybe_trace_is_a_span_only_without_profile_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("TIP_OBS_DIR", str(tmp_path / "run"))
    obs.reset_all()
    with maybe_trace("plain"):
        pass
    obs.reset_all()
    events, _files, _bad = load_events(str(tmp_path / "run"))
    span = next(r for r in events if r.get("type") == "span")
    assert span["attrs"] == {"kind": "phase"}
    with maybe_trace("off"):  # neither plane: a no-op
        pass
