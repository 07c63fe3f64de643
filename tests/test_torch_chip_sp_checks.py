"""``chip_smoke.py``'s phase 7e checks fail when they should, on the CPU.

- ``sp_output_faults``: a sequence-parallel output within tolerance of the
  one-rank model passes; one whose sequence shards came back in the wrong
  order (the gathered blocks swapped) is found, in the probabilities and
  in the taps.
- ``gradient_faults``: the one-rank gradients pass; n times them (what a
  summing all-gather's backward gives) and a missing leaf are found.
- ``sp_launch_faults``: every rank launching B4, B5 and B6 passes; a rank
  that launched one of them no time is found.
- ``study_faults``: on host outputs and event-stream records as
  ``full_study`` writes them, a clean two-host run passes; a host that
  skipped a rendezvous, host 0 aggregating before host 1's phase ended, a
  host other than 0 printing evaluation lines, a wrong share and a failed
  host are each found.
- ``host_launches`` reads each process's last flushed launch gauges.
"""

import copy

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _attention_output(seed=0, shape=(4, 8, 2, 16)):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


def _taps(seed=0):
    rng = np.random.default_rng(seed)
    return {i: torch.from_numpy(rng.normal(size=(6, 8, 32)).astype(np.float32))
            for i in (1, 2)} | {i: torch.from_numpy(rng.random((6, 2)).astype(np.float32))
                                for i in (3, 7)}


def test_outputs_within_tolerance_pass():
    probs = torch.softmax(_attention_output()[:, 0, 0, :2], dim=-1)
    taps = _taps()
    near = {i: t * (1 + 1e-6) for i, t in taps.items()}
    assert chip_smoke.sp_output_faults(probs * (1 + 1e-6), near, probs, taps, "ring") == []


def test_a_wrong_shard_order_is_found():
    taps = _taps()
    swapped = copy.deepcopy(taps)
    for i in (1, 2):  # [B, T, E]: the two halves of the sequence gathered the wrong way round
        t = swapped[i]
        swapped[i] = torch.cat([t[:, 4:], t[:, :4]], dim=1)
    probs = taps[7]
    faults = chip_smoke.sp_output_faults(probs, swapped, probs, taps, "ring over 2")
    assert [f.split(":")[0] for f in faults] == ["ring over 2 tap 1", "ring over 2 tap 2"]
    faults = chip_smoke.sp_output_faults(probs.flip(0), taps, probs, taps, "ring over 2")
    assert faults and faults[0].startswith("ring over 2 probs")


def _grads(seed=1):
    rng = np.random.default_rng(seed)
    return {"block.attention.query.weight": torch.from_numpy(
                (rng.normal(size=(64, 32)) * 1e-5).astype(np.float32)),
            "dense2.bias": torch.from_numpy(rng.normal(size=2).astype(np.float32))}


@pytest.mark.parametrize("n", [2, 4])
def test_n_times_the_gradients_are_found(n):
    want = _grads()
    faults, _ = chip_smoke.gradient_faults({k: v * n for k, v in want.items()}, want, "ring")
    assert {f.split(":")[0] for f in faults} == {f"ring gradient {k}" for k in want}


def test_the_one_rank_gradients_pass_and_a_missing_leaf_is_found():
    want = _grads()
    faults, worst = chip_smoke.gradient_faults({k: v.clone() for k, v in want.items()}, want, "x")
    assert faults == [] and worst == 0.0
    faults, _ = chip_smoke.gradient_faults({"dense2.bias": want["dense2.bias"]}, want, "x")
    assert faults and "apart" in faults[0]


def test_a_missing_launch_is_found():
    full = {k: 4 for k in chip_smoke.SP_KERNELS}
    assert chip_smoke.sp_launch_faults({0: full, 1: full}, "ring2") == []
    short = {**full, "flash_attention_bwd_dkv": 0}
    assert chip_smoke.sp_launch_faults({0: full, 1: short}, "ring2") == [
        "ring2: rank 1 launched flash_attention_bwd_dkv 0 times"]
    assert chip_smoke.sp_launch_faults({0: {}}, "ring2", ()) == []


def _study(t_phase_end=(10.0, 12.0), t_eval=13.0):
    """Host outputs and stream records of a clean two-host study."""
    outs = ["host 0/2: 1/2 runs, 1 local device(s), platform cuda\n[test_prio:imdb] runs 0..0 "
            "in 9s\n[evaluation:test_prio] 1s\n",
            "host 1/2: 1/2 runs, 1 local device(s), platform cuda\n[test_prio:imdb] runs 1..1 "
            "in 11s\n"]
    records = []
    for rank, end in enumerate(t_phase_end):
        records.append({"type": "span", "name": "test_prio", "ts": 1.0, "dur": end - 1.0,
                        "pid": 100 + rank, "depth": 1, "attrs": {"cs": "imdb"}})
        for when in ("pre", "post"):
            records.append({"type": "event", "name": "barrier", "ts": 12.5, "pid": 100 + rank,
                            "attrs": {"barrier": f"full_study_{when}_evaluation", "rank": rank,
                                      "waited_s": 0.1}})
    records.append({"type": "span", "name": "evaluation", "ts": t_eval, "dur": 1.0, "pid": 100,
                    "depth": 1, "attrs": {"which": "test_prio"}})
    return outs, [0, 0], records


def test_a_clean_study_passes():
    outs, codes, records = _study()
    assert chip_smoke.study_faults(outs, codes, records, (0, 1)) == []


def test_a_host_that_skipped_the_barrier_is_found():
    outs, codes, records = _study()
    skipped = [r for r in records if not (r.get("name") == "barrier" and r["attrs"]["rank"] == 1
                                          and "pre" in r["attrs"]["barrier"])]
    assert chip_smoke.study_faults(outs, codes, skipped, (0, 1)) == [
        "host 1 skipped the pre-evaluation rendezvous"]
    outs, codes, records = _study(t_phase_end=(10.0, 14.0), t_eval=13.0)
    faults = chip_smoke.study_faults(outs, codes, records, (0, 1))
    assert len(faults) == 1 and "before every host's phases ended" in faults[0]


def test_evaluation_lines_shares_and_exit_codes_are_checked():
    outs, codes, records = _study()
    outs[1] += "[evaluation:test_prio] 1s\n"
    assert chip_smoke.study_faults(outs, codes, records, (0, 1)) == [
        "host 1 printed evaluation lines"]
    outs, codes, records = _study()
    assert chip_smoke.study_faults(outs, codes, records, (0, 1, 2)) == [
        "host 0 did not report 'host 0/2: 2/3 runs'", "host 1 did not report 'host 1/2: 1/3 runs'"]
    outs, codes, records = _study()
    faults = chip_smoke.study_faults(outs, [0, 1], records, (0, 1))
    assert len(faults) == 1 and faults[0].startswith("host 1 exited 1")
    assert chip_smoke.study_faults(outs, codes, [r for r in records if r["name"] != "evaluation"],
                                   (0, 1)) == ["no evaluation span"]


def test_host_launches_reads_the_last_flush():
    records = [{"type": "metrics", "pid": 7, "gauges": {"kernel.flash_attention_fwd.launches": 3}},
               {"type": "metrics", "pid": 7, "gauges": {"kernel.flash_attention_fwd.launches": 9,
                                                        "device.0.bytes_reserved": 1}},
               {"type": "span", "pid": 8, "name": "x"}]
    assert chip_smoke.host_launches(records) == {7: {"flash_attention_fwd": 9}}
