"""The port's device meter (``simple_tip_tpu_torch/obs/devicemeter.py``)
against the JAX package's ``obs/devicemeter.py``, and its hooks in the
port's run programs.

The same synthetic costs and dispatch times go through both meters:
``normalize_cost``, ``grade``, ``build_breakdown``, the roofline rows and
their rendering are equal (exactly: the same float arithmetic) for the
``cpu`` entry and for a ``TIP_DEVICE_PEAKS`` override. The bundled table
differs on purpose: the port's one card is the H100 SXM (3xTF32 FLOP/s,
HBM3 bytes/s), and every other device kind, the JAX package's v4
included, is graded analytic-only with no peak. On the CPU, a fused-chain
walk stamps the chain's analytic cost and grades each chain dispatch;
the rank and the select record their latency only. The chain's bytes are
the forward's plus those of the chain's own tensors: its taps read once,
its thresholds (or cut tables) read once a dispatch, its outputs written
once, counted here from the tensors a dispatch really reads and returns.
"""

import json

import numpy as np
import pytest
import torch

import simple_tip_tpu.obs as jax_obs
import simple_tip_tpu_torch.obs as obs
from simple_tip_tpu.obs import devicemeter as jax_dm
from simple_tip_tpu_torch.bridge import params_from_jax
from simple_tip_tpu_torch.engine import run_program as rp
from simple_tip_tpu_torch.models import MnistConvNet
from simple_tip_tpu_torch.obs import devicemeter as dm
from simple_tip_tpu_torch.utils import flops
from test_torch_model import flax_params
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

H100 = "NVIDIA H100 80GB HBM3"
RAW_COSTS = [
    {"flops": 100.0, "bytes accessed": 50.0, "optimal seconds": 0.1},
    [{"flops": 7}, {"flops": 9}],
    {"flops": "junk", "bytes_accessed": 8},
    {"unrelated key": 3.0},
    {"flops": -5.0},
    {},
    "not a dict",
    None,
    [],
    {"Flops": 3e9, "Bytes Accessed": 1e8, "peak memory": 4e6},
]
PROGRAMS = {
    "chain": {"cost": {"flops": 2.5e9, "bytes_accessed": 1.5e8},
              "dispatch_s": {"p50": 1.2e-3, "p99": 2e-3, "count": 20, "mean": 1.3e-3}},
    "group_chain@g4": {"cost": {"flops": 1e10, "bytes accessed": 6e8},
                       "dispatch_s": 4e-3, "models_per_dispatch": 4},
    "rank": {"cost": None, "dispatch_s": {"mean": 3e-3, "count": 12}},
    "hbm_heavy": {"cost": {"flops": 1e6, "bytes_accessed": 3e9}, "dispatch_s": 0.01},
}
OVERRIDE = {"my-chip": {"flops_per_s": 1e14, "hbm_bytes_per_s": 2e12, "label": "mine"}}


@pytest.fixture(autouse=True)
def _isolation(monkeypatch):
    monkeypatch.delenv("TIP_DEVICE_PEAKS", raising=False)
    for meter in (dm, jax_dm):
        meter.reset()
    obs.reset_all()
    jax_obs.reset_all()
    yield
    for meter in (dm, jax_dm):
        meter.reset()
    obs.reset_all()
    jax_obs.reset_all()


@pytest.mark.parametrize("raw", RAW_COSTS, ids=range(len(RAW_COSTS)))
def test_normalize_cost_equals_jax(raw):
    assert dm.normalize_cost(raw) == jax_dm.normalize_cost(raw)


@pytest.mark.parametrize("where", ["cpu", "override"])
def test_grade_and_breakdown_documents_equal_jax(where, monkeypatch):
    if where == "override":
        monkeypatch.setenv("TIP_DEVICE_PEAKS", json.dumps(OVERRIDE))
        platform, kind, cores = "gpu", "My-Chip rev 2", 1
    else:
        platform, kind, cores = "cpu", "cpu", 8
    for cost in ({"flops": 3e9, "bytes_accessed": 2e8}, {"flops": 1e6}, None):
        for dt in (1e-3, 0.0, None):
            assert dm.grade(cost, dt, platform, kind, cores) == \
                jax_dm.grade(cost, dt, platform, kind, cores)
    assert dm.resolve_peaks(platform, kind, cores) == jax_dm.resolve_peaks(platform, kind, cores)
    doc = dm.build_breakdown(PROGRAMS, platform, kind, cores=cores, captured_unix=1.5e9,
                             extra={"note": "x"})
    want = jax_dm.build_breakdown(PROGRAMS, platform, kind, cores=cores, captured_unix=1.5e9,
                                  extra={"note": "x"})
    assert json.dumps(doc, sort_keys=True) == json.dumps(want, sort_keys=True)
    rows = dm.rows_from_breakdown(doc)
    assert rows == jax_dm.rows_from_breakdown(want)
    assert dm.render_roofline(rows, header="h") == jax_dm.render_roofline(rows, header="h")
    assert not any(r["analytic_only"] for r in rows)


def test_live_gauges_and_metric_rows_equal_jax():
    """observe_dispatch lands the same quantile and gauges in each
    package's registry; rows_from_metrics reads them alike."""
    for meter in (dm, jax_dm):
        meter.record_program_cost("chain", {"flops": 2e9, "bytes_accessed": 1e8})
        for dt in (1e-3, 2e-3, 1.5e-3):
            meter.observe_dispatch("chain", dt, platform="cpu", device_kind="cpu", cores=4)
        meter.observe_dispatch("rank", 5e-3, platform="cpu", device_kind="cpu", cores=4)
    snap, jax_snap = obs.metrics_snapshot(), jax_obs.metrics_snapshot()
    for part in ("gauges", "quantiles"):
        assert snap[part] == jax_snap[part]
    assert dm.rows_from_metrics(snap) == jax_dm.rows_from_metrics(jax_snap)
    assert dm.program_costs() == jax_dm.program_costs()
    dm.record_program_cost("chain", None)
    assert dm.program_cost("chain") is None


def test_h100_entry_is_the_cards_3xtf32_peak():
    peaks = dm.resolve_peaks("gpu", H100)
    assert peaks["flops_per_s"] == 165e12 and peaks["hbm_bytes_per_s"] == 3.35e12
    assert not peaks["analytic_only"] and "3xTF32" in peaks["label"]
    graded = dm.grade({"flops": 165e9, "bytes_accessed": 3.35e9}, 0.002, "gpu", H100)
    assert graded["mfu"] == pytest.approx(0.5) and graded["hbm_frac"] == pytest.approx(0.5)
    assert graded["bound"] == "compute"


@pytest.mark.parametrize("kind", ["NVIDIA H100 PCIe", "NVIDIA H100 NVL", "TPU v4", "weird"])
def test_unknown_card_is_graded_analytic_only(kind):
    """No peak is assumed: achieved rates survive, MFU and the verdict do
    not, and the roofline marks the row. (The JAX table grades "TPU v4"
    against its v4 entry; the port's table has no TPU.)"""
    cost = {"flops": 2e9, "bytes_accessed": 1e8}
    graded = dm.grade(cost, 1e-3, "gpu", kind)
    assert graded["analytic_only"] and graded["mfu"] is None and graded["hbm_frac"] is None
    assert graded["achieved_flops_per_s"] == 2e12 and graded["bound"] == "unknown"
    doc = dm.build_breakdown({"chain": {"cost": cost, "dispatch_s": 1e-3}}, "gpu", kind)
    assert doc["peaks"] == {"analytic_only": True, "label": f"unknown:{kind}"}
    assert "[analytic_only]" in dm.render_roofline(dm.rows_from_breakdown(doc))
    if kind == "TPU v4":
        assert not jax_dm.grade(cost, 1e-3, "tpu", kind)["analytic_only"]


def test_analytic_cost_is_the_flops_counts():
    cost = dm.analytic_cost("mnist", 512)
    assert cost == {"flops": float(flops.conv_net_forward_flops("mnist") * 512),
                    "bytes_accessed": float(flops.conv_net_forward_hbm_bytes("mnist", 4, 4) * 512)}
    assert dm.analytic_cost("cifar10", 3)["flops"] == 3.0 * flops.conv_net_forward_flops("cifar10")
    assert dm.analytic_cost("imdb", 2) == {"flops": 2.0 * flops.transformer_forward_flops()}
    with pytest.raises(ValueError):
        dm.analytic_cost("resnet", 1)


def _nbytes(tree) -> int:
    """Bytes of every tensor in a nest of tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        return tree.nbytes
    if isinstance(tree, dict):
        tree = tree.values()
    return sum(_nbytes(t) for t in tree)


def _tap_bytes(net, layer_ids, rows: int) -> int:
    """Bytes of the f32 taps ``layer_ids`` of ``rows`` inputs, from a forward."""
    with torch.no_grad():
        _probs, taps = net(torch.zeros((1, 28, 28, 1)))
    return rows * sum(taps[i].nbytes for i in layer_ids)


def test_chain_cost_counts_the_coverage_bytes():
    bits = [36384, 2 * 36384]
    cost = dm.chain_cost("mnist", 4, 36384, bits, table_bytes=100, head_bytes=24)
    forward = dm.analytic_cost("mnist", 4)
    assert cost["flops"] == forward["flops"]
    per_input = 4 * 36384 + (4 * 1137 + 4) + (4 * 2274 + 4) + 24
    assert cost["bytes_accessed"] == forward["bytes_accessed"] + 4 * per_input + 100
    assert flops.coverage_hbm_bytes(10, [100, 40000]) == 40 + (16 + 2) + (5000 + 4)
    assert dm.chain_cost("imdb", 2, 10, [10])["bytes_accessed"] == 2 * (40 + 4 + 2)


def test_detect_device_on_the_cpu():
    assert dm.detect_device("cpu")[:2] == ("cpu", "cpu")
    assert dm.detect_device("cpu")[2] >= 1


def test_chain_walk_stamps_its_cost_and_grades_each_dispatch(monkeypatch):
    """A CPU walk of 40 rows in badges of 16: three chain dispatches graded
    against 16 forwards' analytic cost (the CPU entry has peaks, so MFU and
    the HBM fraction land), one rank per metric and one select latency,
    with no cost."""
    for var in ("TIP_SA_CACHE_DIR", "TIP_COV_STATS_CACHE_DIR"):
        monkeypatch.setenv(var, "off")
    rng = np.random.default_rng(3)
    x_train = rng.random((48, 28, 28, 1), dtype=np.float32)
    x = rng.random((40, 28, 28, 1), dtype=np.float32)
    runner = rp.FusedChainRunner(MnistConvNet(), params_from_jax(flax_params(4)), x_train,
                                 [0, 1, 2, 3], batch_size=16, badge_size=16, device="cpu")
    runner.evaluate_dataset(x, select_k=5)
    forward = dm.analytic_cost("mnist", 16)
    prog = runner.chain_program((16, 28, 28, 1), torch.float32)
    thresholds = sum(t.nbytes for m in runner.worker.metrics.values()
                     for t in (getattr(m, a, None) for a in ("min_boundaries", "max_boundaries",
                                                             "lo", "jumps"))
                     if isinstance(t, torch.Tensor))
    chain_bytes = _tap_bytes(runner.net, runner.layer_ids, 16) + thresholds + _nbytes(prog())
    assert dm.program_cost("chain") == {
        "flops": forward["flops"], "bytes_accessed": forward["bytes_accessed"] + chain_bytes}
    snap = obs.metrics_snapshot()
    q = snap["quantiles"]
    assert q["run_program.dispatch_s.chain"]["count"] == 3 == runner.chain_dispatches
    assert q["run_program.dispatch_s.rank"]["count"] == runner.rank_dispatches
    assert q["run_program.dispatch_s.select"]["count"] == runner.select_dispatches
    gauges = snap["gauges"]
    assert 0 < gauges["run_program.mfu.chain"] < 1.05
    assert 0 < gauges["run_program.hbm_frac.chain"] < 1.05
    assert not any(k.endswith((".rank", ".select")) for k in gauges)
    rows = {r["program"]: r for r in dm.rows_from_metrics(snap)}
    assert rows["chain"]["bound"] in ("compute", "hbm") and rows["rank"]["bound"] == "unknown"


def test_group_walk_grades_group_chain_over_every_slot(monkeypatch):
    for var in ("TIP_SA_CACHE_DIR", "TIP_COV_STATS_CACHE_DIR"):
        monkeypatch.setenv(var, "off")
    rng = np.random.default_rng(4)
    x_train = rng.random((48, 28, 28, 1), dtype=np.float32)
    x = rng.random((20, 28, 28, 1), dtype=np.float32)
    members = [params_from_jax(flax_params(s)) for s in (4, 5)]
    group = rp.GroupChainRunner(MnistConvNet(), members[:1], x_train, [0, 1, 2, 3],
                                batch_size=16, badge_size=16, group_size=2, device="cpu")
    group.evaluate_dataset(x)
    forward = dm.analytic_cost("mnist", 32)
    prog = group.chain_program(x, (16, 28, 28, 1), torch.float32)
    cut_tables = sum(t.nbytes for t in prog.args[1])
    chain_bytes = _tap_bytes(group.net, group.layer_ids, 32) + cut_tables + _nbytes(prog())
    assert dm.program_cost("group_chain") == {
        "flops": forward["flops"], "bytes_accessed": forward["bytes_accessed"] + chain_bytes}
    q = obs.metrics_snapshot()["quantiles"]
    assert q["run_program.dispatch_s.group_chain"]["count"] == 2
    assert q["run_program.dispatch_s.group_rank"]["count"] == group.rank_dispatches
