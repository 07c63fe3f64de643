"""The fused-chain checks of ``chip_smoke.py`` can fail.

On the CPU: ``tree_faults`` finds a flipped packed word and an output of
the graph that differs from the eager chain's; ``padding_faults`` a set bit
in a padding row; ``member_faults`` two group members swapped;
``fused_against_per_phase`` a dropped CAM pick, a coverage score, VR or SA
byte apart, an uncertainty past 1e-5 and a flipped prediction that is no
near tie (near ties are counted, not refused). ``check_graph_vs_eager`` and
``check_group_runner`` raise when the program's output or the group's
member order is broken (the CPU program is the eager closure, so the
breakage is patched in).
"""

import copy

import numpy as np
import pytest
import torch

import chip_smoke
from simple_tip_tpu_torch.bridge import params_from_jax
from simple_tip_tpu_torch.engine import run_program as rp
from test_torch_model import flax_params
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROWS = 24


def _chain_outputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, 10, ROWS),
        {"softmax": rng.random(ROWS).astype(np.float32)},
        {"NAC_0": (rng.integers(0, 99, ROWS).astype(np.int16),
                   rng.integers(-2**31, 2**31, (ROWS, 5), dtype=np.int64).astype(np.int32))},
    )


def _artifacts():
    rng = np.random.default_rng(1)
    art = {}
    for ds in ("nominal", "ood"):
        art[(ds, "is_misclassified")] = rng.random(ROWS) > 0.5
        art[(ds, "uncertainty_softmax")] = rng.random(ROWS).astype(np.float32)
        art[(ds, "uncertainty_VR")] = rng.random(ROWS)
        art[(ds, "NAC_0_scores")] = rng.integers(0, 99, ROWS).astype(np.int16)
        art[(ds, "NAC_0_cam_order")] = rng.permutation(ROWS).astype(np.int64)
        art[(ds, "dsa_scores")] = rng.random(ROWS)
    return art


GAPS = {ds: np.full(ROWS, 0.5) for ds in ("nominal", "ood")}


def test_tree_faults_find_a_flipped_packed_word():
    want = _chain_outputs()
    assert chip_smoke.tree_faults(copy.deepcopy(want), want) == []
    got = copy.deepcopy(want)
    got[2]["NAC_0"][1][3, 2] ^= 1 << 7
    assert chip_smoke.tree_faults(got, want) == ["/2/NAC_0/1"]


def test_tree_faults_find_a_graph_output_apart_from_eager():
    want = _chain_outputs()
    got = copy.deepcopy(want)
    got[1]["softmax"][5] = np.nextafter(got[1]["softmax"][5], np.float32(1))
    assert chip_smoke.tree_faults(got, want) == ["/1/softmax"]
    got = (want[0].astype(np.int32),) + copy.deepcopy(want[1:])
    assert chip_smoke.tree_faults(got, want) == ["/0"]


def test_padding_faults_find_a_set_bit_in_a_padding_row():
    full = _chain_outputs()[2]
    valid = 10
    padded = {mid: (s, np.concatenate([p[:valid], np.zeros_like(p[valid:])]))
              for mid, (s, p) in full.items()}
    assert chip_smoke.padding_faults(padded, valid, full) == []
    padded["NAC_0"][1][valid + 3, 0] = 1
    assert chip_smoke.padding_faults(padded, valid, full) == [
        "NAC_0: padding rows hold set bits"]
    padded["NAC_0"][1][valid + 3, 0] = 0
    padded["NAC_0"][1][0, 0] ^= 1
    assert chip_smoke.padding_faults(padded, valid, full) == [
        "NAC_0: valid rows differ from the unpadded badge"]


def _member_result(seed: int) -> dict:
    pred, unc, cov = _chain_outputs(seed)
    return {"pred": pred, "uncertainties": unc, "scores": {"NAC_0": cov["NAC_0"][0]},
            "cam_orders": {"NAC_0": np.arange(ROWS)[::-1].copy()},
            "unc_times": {"softmax": [0, seed, 0, 0]}, "cov_times": {"NAC_0": [seed] * 4}}


def test_member_faults_find_two_members_swapped():
    refs = [_member_result(0), _member_result(1)]
    got = copy.deepcopy(refs)
    for r in got:  # timing records are not compared
        r["unc_times"]["softmax"][1] += 1.0
    assert chip_smoke.member_faults(got, refs) == []
    faults = chip_smoke.member_faults(got[::-1], refs)
    assert faults and all(f.startswith(("member 0", "member 1")) for f in faults)
    assert chip_smoke.member_faults(got[:1], refs) == ["1 member results for 2 runs"]


def test_fused_against_per_phase_passes_equal_artifacts():
    per_phase = _artifacts()
    fused = copy.deepcopy(per_phase)
    fused[("ood", "uncertainty_softmax")] += np.float32(5e-6)
    report = chip_smoke.fused_against_per_phase(fused, per_phase, GAPS)
    assert report["misclassified_near_tie"] == {"nominal": 0, "ood": 0}
    assert 4e-6 < report["uncertainty_max_abs"]["ood uncertainty_softmax"] < 6e-6


def test_fused_against_per_phase_finds_a_dropped_cam_pick():
    per_phase = _artifacts()
    fused = copy.deepcopy(per_phase)
    order = fused[("nominal", "NAC_0_cam_order")]
    fused[("nominal", "NAC_0_cam_order")] = np.concatenate([order[1:], order[:1]])
    with pytest.raises(AssertionError, match="nominal NAC_0_cam_order"):
        chip_smoke.fused_against_per_phase(fused, per_phase, GAPS)


@pytest.mark.parametrize("key", [("ood", "NAC_0_scores"), ("nominal", "uncertainty_VR"),
                                 ("ood", "dsa_scores")])
def test_fused_against_per_phase_finds_a_byte_apart(key):
    per_phase = _artifacts()
    fused = copy.deepcopy(per_phase)
    a = fused[key]
    a[7] = a[7] + 1 if a.dtype.kind == "i" else np.nextafter(a[7], 2.0)
    with pytest.raises(AssertionError, match=f"{key[0]} {key[1]}"):
        chip_smoke.fused_against_per_phase(fused, per_phase, GAPS)


def test_fused_against_per_phase_bounds_uncertainties_and_flips():
    per_phase = _artifacts()
    fused = copy.deepcopy(per_phase)
    fused[("nominal", "uncertainty_softmax")][2] += np.float32(2e-5)
    with pytest.raises(AssertionError, match="uncertainty_softmax"):
        chip_smoke.fused_against_per_phase(fused, per_phase, GAPS)
    fused = copy.deepcopy(per_phase)
    fused[("ood", "is_misclassified")][[4, 9]] ^= True
    gaps = {ds: g.copy() for ds, g in GAPS.items()}
    gaps["ood"][[4, 9]] = 3e-6
    report = chip_smoke.fused_against_per_phase(fused, per_phase, gaps)
    assert report["misclassified_near_tie"] == {"nominal": 0, "ood": 2}
    with pytest.raises(AssertionError, match="no near tie"):
        chip_smoke.fused_against_per_phase(fused, per_phase, GAPS)
    del fused[("ood", "dsa_scores")]
    with pytest.raises(AssertionError, match="not the per-phase route's"):
        chip_smoke.fused_against_per_phase(fused, per_phase, gaps)


def test_top2_gap():
    probs = np.array([[0.1, 0.6, 0.3], [0.5, 0.2, 0.3]], np.float32)
    np.testing.assert_allclose(chip_smoke.top2_gap(probs), [0.3, 0.2], rtol=1e-6)


@pytest.fixture
def tiny_chain(monkeypatch):
    """MNIST data of a few dozen rows, 16-row badges, timers stubbed (the
    CPU has no CUDA events)."""
    monkeypatch.setattr(rp, "PROFILE_BADGE_SIZE", 16)
    monkeypatch.setattr(chip_smoke, "PROFILE_BADGE_SIZE", 16)
    monkeypatch.setattr(chip_smoke, "CHAIN_PAD_VALID", 5)
    monkeypatch.setattr(chip_smoke, "CHAIN_GROUP_ROWS", 16)
    monkeypatch.setattr(chip_smoke, "CHAIN_SELECT_K", 3)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps: 0.0)
    monkeypatch.setattr(chip_smoke, "host_ms", lambda fn, reps: 0.0)
    for var in ("TIP_SA_CACHE_DIR", "TIP_COV_STATS_CACHE_DIR"):
        monkeypatch.setenv(var, "off")
    rng = np.random.default_rng(3)

    def rows(n):
        return rng.random((n, 28, 28, 1), dtype=np.float32), rng.integers(0, 10, n)

    return rows(32), rows(16), rows(16)


def test_check_graph_vs_eager_refuses_a_program_apart(tiny_chain, monkeypatch):
    params = params_from_jax(flax_params(4))
    cpu = torch.device("cpu")
    record = chip_smoke.check_graph_vs_eager("mnist", params, tiny_chain, cpu)
    assert record["faults"] == [] and record["badge"] == [16, 28, 28, 1]
    call = rp.Program.__call__

    def flipped(prog):
        pred, unc, cov = call(prog)
        cov = dict(cov)
        s, packed = cov["NAC_0"]
        cov["NAC_0"] = (s, packed ^ 1)
        return pred, unc, cov

    monkeypatch.setattr(rp.Program, "__call__", flipped)
    with pytest.raises(AssertionError, match="NAC_0"):
        chip_smoke.check_graph_vs_eager("mnist", params, tiny_chain, cpu)


def test_check_group_runner_refuses_swapped_members(tiny_chain, monkeypatch):
    params = {run: params_from_jax(flax_params(4 + run)) for run in (0, 1)}
    cpu = torch.device("cpu")
    record = chip_smoke.check_group_runner(params, tiny_chain, cpu)
    assert record["faults"] == []
    assert {g: r["dispatches"] for g, r in record["groups"].items()} == {2: 2, 3: 2}
    evaluate = rp.GroupChainRunner.evaluate_dataset
    monkeypatch.setattr(rp.GroupChainRunner, "evaluate_dataset",
                        lambda self, *a, **k: evaluate(self, *a, **k)[::-1])
    with pytest.raises(AssertionError, match="member 0"):
        chip_smoke.check_group_runner(params, tiny_chain, cpu)
