"""The serving checks of ``chip_smoke.py`` (phase 7c) can fail.

On the CPU: ``request_cuts`` covers the rows with requests in range;
``saturated_badges`` counts the badges the batcher packs them into;
``serving_faults`` finds a flipped prediction, score or uncertainty in one
answer; ``BadgeLog`` records what the executor ran; and ``run_serving``
raises when an answer is broken (the executor's output is patched) or when
the engine sheds below the overload rate (the queue bound is patched).
Whether the phase passes rests on the card's timings, so the CPU holds
only its refusals.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from simple_tip_tpu_torch import bridge
from simple_tip_tpu_torch.bridge import params_from_jax
from simple_tip_tpu_torch.engine.run_program import FusedChainRunner
from simple_tip_tpu_torch.serving import FusedChainExecutor, StubExecutor
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_request_cuts_cover_the_rows_in_range():
    for n, seed in ((10_000, 0), (25_000, 1), (701, 2), (1, 3)):
        cuts = chip_smoke.request_cuts(n, seed)
        sizes = np.diff(cuts)
        assert cuts[0] == 0 and cuts[-1] == n
        lo, hi = chip_smoke.SERVE_REQUEST_ROWS
        assert (sizes >= 1).all() and (sizes[:-1] >= lo).all() and (sizes <= hi).all()
    np.testing.assert_array_equal(chip_smoke.request_cuts(5000, 7),
                                  chip_smoke.request_cuts(5000, 7))


def test_saturated_badges_packs_whole_chunks(monkeypatch):
    monkeypatch.setattr(chip_smoke, "SERVE_BADGE", 8)
    # requests of 5, 5, 3, 12 (8 + 4) and 1 rows: [5] [5 3] [8] [4 1]
    assert chip_smoke.saturated_badges(np.array([0, 5, 10, 13, 25, 26])) == 4
    assert chip_smoke.saturated_badges(np.array([0, 8, 16])) == 2


def _answer(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"pred": rng.integers(0, 10, n),
            "uncertainties": {"softmax": rng.random(n, dtype=np.float32)},
            "scores": {"NAC_0": rng.random(n, dtype=np.float32)}}


def test_serving_faults_find_a_broken_answer():
    ref = _answer(10)
    cuts = np.array([0, 4, 10])
    good = {i: {k: (v[cuts[i]:cuts[i + 1]] if k == "pred" else
                    {m: a[cuts[i]:cuts[i + 1]] for m, a in v.items()})
                for k, v in ref.items()} for i in range(2)}
    assert chip_smoke.serving_faults("m", good, cuts, ref) == []
    for key, sub in (("pred", None), ("uncertainties", "softmax"), ("scores", "NAC_0")):
        bad = {i: {k: (np.copy(v) if k == "pred" else {m: np.copy(a) for m, a in v.items()})
                   for k, v in ans.items()} for i, ans in good.items()}
        arr = bad[1][key] if sub is None else bad[1][key][sub]
        arr[2] = arr[2] + 1
        faults = chip_smoke.serving_faults("m", bad, cuts, ref)
        assert len(faults) == 1 and "request 1 [4:10]" in faults[0], faults


def test_badge_log_records_the_executor_runs():
    ex = StubExecutor()
    ex.register_model("m", badge_size=4)
    log = chip_smoke.BadgeLog(ex)
    assert ex.run_badge("m", [[[1], [2]], [[3]]]) == [[1, 2], [3]]
    ex.run_badge("m", [[[4]]])
    assert log.badges == [("m", 3), ("m", 1)] and log.since(1, "m") == [1]


@pytest.fixture()
def tiny_serving(monkeypatch, tmp_path):
    """``run_serving``'s inputs at a few dozen rows on the CPU, both
    families' statistics cached (so registration is a load)."""
    monkeypatch.setenv("TIP_ASSETS", str(tmp_path))
    monkeypatch.delenv("TIP_COV_STATS_CACHE_DIR", raising=False)
    for name, value in (("SERVE_BADGE", 16), ("SERVE_REQUEST_ROWS", (1, 22)),
                        ("SERVE_FINAL_ROWS", 5), ("SERVE_LATE_ROWS", 40),
                        ("SERVE_LATE_RATE", 400.0)):
        monkeypatch.setattr(chip_smoke, name, value)
    rng = np.random.default_rng(0)
    data = {
        "mnist": ((rng.random((48, 28, 28), dtype=np.float32)[..., None], None),
                  (rng.random((60, 28, 28), dtype=np.float32)[..., None], None), None),
        "imdb": ((rng.integers(0, 2000, (48, 100)), None),
                 (rng.integers(0, 2000, (70, 100)), None), None),
    }
    params = {f: params_from_jax(bridge.glorot_params(0, f)) for f in data}
    dev = torch.device("cpu")
    for f in data:
        cfg = chip_smoke.PATHS[f]
        FusedChainRunner(cfg["model"](), params[f], data[f][0][0], cfg["nc"],
                         batch_size=cfg["batch"], badge_size=16, device=dev)
    late = params_from_jax(bridge.glorot_params(1, "mnist"))
    return params, data, dev, late


def test_run_serving_refuses_a_broken_answer(tiny_serving, monkeypatch):
    params, data, dev, late = tiny_serving
    run_badge = FusedChainExecutor.run_badge

    def flipped(self, key, segments):
        parts = run_badge(self, key, segments)
        if key == "imdb":
            parts[0]["scores"]["NAC_0"][0] += 1.0
        return parts

    monkeypatch.setattr(FusedChainExecutor, "run_badge", flipped)
    with pytest.raises(AssertionError, match=r"serving: .*imdb request \d+ \[\d+:\d+\] /scores/NAC_0"):
        chip_smoke.run_serving(params, data, dev, late_params=late)


def test_run_serving_refuses_sheds_below_the_overload_rate(tiny_serving, monkeypatch):
    """Every engine gets a one-row queue: the 0.5x and 1.0x runs shed, and
    the phase says so (the request after the burst still fits)."""
    params, data, dev, late = tiny_serving
    monkeypatch.setattr(chip_smoke, "SERVE_FINAL_ROWS", 1)
    knobs = chip_smoke.ServingKnobs
    monkeypatch.setattr(chip_smoke, "ServingKnobs",
                        lambda **kw: knobs(**{**kw, "queue_bound_rows": 1}))
    with pytest.raises(AssertionError, match=r"0\.5x (mnist|imdb): \d+ requests shed"):
        chip_smoke.run_serving(params, data, dev, late_params=late)
