"""The active-learning checks of ``chip_smoke.py`` can fail: its pickle
reader refuses a missing or unexpected pickle and an accuracy that is not
a Python float in [0, 1]; its edge gaps treat equal values (+inf ones
included) as ties; its pc-mlsa selection count sees moved rows."""

import pickle

import numpy as np
import pytest

import chip_smoke
from simple_tip_tpu_torch.plotters.utils import APPROACHES
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SPLITS = [(s, p) for s in ("nominal", "ood") for p in ("observed", "future")]


def _write_bus(folder, has_dropout=True, value=0.5):
    folder.mkdir(parents=True, exist_ok=True)
    names = [(a, obs) for a in [*APPROACHES, "random"] if a != "VR" or has_dropout
             for obs in ("nominal", "ood")] + [("original", "na")]
    for approach, obs in names:
        with open(folder / f"mnist_0_{approach}_{obs}.pickle", "wb") as f:
            pickle.dump({s: value for s in SPLITS}, f)
    return len(names)


def test_reader_takes_a_complete_bus(tmp_path, monkeypatch):
    monkeypatch.setenv("TIP_ASSETS", str(tmp_path))
    n = _write_bus(tmp_path / "active_learning")
    got = chip_smoke.read_al_pickles("mnist", has_dropout=True)
    assert len(got) == n == 81
    assert got["random_ood"] == {s: 0.5 for s in SPLITS}


@pytest.mark.parametrize("fault", ["missing", "unexpected", "not a float", "above 1", "order"])
def test_reader_refuses_a_faulty_bus(tmp_path, monkeypatch, fault):
    monkeypatch.setenv("TIP_ASSETS", str(tmp_path))
    folder = tmp_path / "active_learning"
    _write_bus(folder)
    target = folder / "mnist_0_dsa-cam_ood.pickle"
    if fault == "missing":
        target.unlink()
    elif fault == "unexpected":
        _write_bus(tmp_path / "x")
        (tmp_path / "x" / "mnist_0_dsa_ood.pickle").rename(folder / "mnist_1_dsa_ood.pickle")
    else:
        acc = {s: 0.5 for s in SPLITS}
        if fault == "not a float":
            acc[SPLITS[0]] = np.float32(0.5)
        elif fault == "above 1":
            acc[SPLITS[1]] = 1.5
        else:
            acc = dict(reversed(list(acc.items())))
        with open(target, "wb") as f:
            pickle.dump(acc, f)
    with pytest.raises(AssertionError):
        chip_smoke.read_al_pickles("mnist", has_dropout=True)


def test_reader_expects_no_vr_without_dropout(tmp_path, monkeypatch):
    monkeypatch.setenv("TIP_ASSETS", str(tmp_path))
    assert _write_bus(tmp_path / "active_learning", has_dropout=False) == 79
    assert len(chip_smoke.read_al_pickles("mnist", has_dropout=False)) == 79
    with pytest.raises(AssertionError, match="missing"):
        chip_smoke.read_al_pickles("mnist", has_dropout=True)


def test_edge_gaps_count_equal_values_as_ties():
    values = np.array([0.1, np.inf, 0.3, np.inf, np.inf, 0.2])
    # the 2nd largest is +inf: rows 1, 3 and 4 tie with it
    assert chip_smoke._gaps_to_edge(values, {1, 3, 4}, 2).tolist() == [0.0, 0.0, 0.0]
    assert np.isinf(chip_smoke._gaps_to_edge(values, {2}, 2)).all()
    finite = np.array([0.5, 0.40001, 0.4, 0.1])
    np.testing.assert_allclose(chip_smoke._gaps_to_edge(finite, {1, 2}, 2), [0.0, 1e-5],
                               atol=1e-12)


def test_mlsa_selection_count_sees_moved_rows():
    card = np.arange(10, dtype=float)
    cpu = card.copy()
    cpu[[0, 9]] = cpu[[9, 0]]  # the largest row becomes the smallest
    order = np.arange(10)
    moved = chip_smoke.mlsa_selection_moved(card, cpu, order, order[::-1])
    assert moved == {"k": 2, "top_k": 1, "sc_cam_first_k": 2}
    assert chip_smoke.mlsa_selection_moved(card, card, order, order)["top_k"] == 0
