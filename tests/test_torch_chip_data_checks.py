"""The data-phase and DSA-tie checks of ``chip_smoke.py`` can fail.

On the CPU: ``first_search_tie`` accepts two rows that the card's and
the CPU's traces order differently and refuses the same row, a pick that
is not the nearer on its own side, or traces moved by 1%; ``dsa_ties``
raises for a row both sides searched alike;
``check_generated`` passes on a cache the loader generated and raises on
a relabelled row or an image moved by two uint8 levels.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from simple_tip_tpu_torch.bridge import params_from_jax
from simple_tip_tpu_torch.data import loaders, synthetic
from simple_tip_tpu_torch.models.init import init_params
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")


@pytest.mark.parametrize("card, cpu, picks, tie", [
    # each side's pick the nearer on its own traces, moved 4e-5: a tie
    ({1: 0.12980, 2: 0.12981}, {1: 0.12984, 2: 0.12982}, (1, 2), True),
    # the same row on both sides is no tie
    ({1: 0.1298, 2: 0.1300}, {1: 0.1298, 2: 0.1300}, (1, 1), False),
    # the card's pick is not its nearer row
    ({1: 0.1310, 2: 0.1298}, {1: 0.1310, 2: 0.1298}, (1, 2), False),
    # the CPU's pick is not its nearer row
    ({1: 0.12980, 2: 0.13110}, {1: 0.12981, 2: 0.13110}, (1, 2), False),
    # each side's pick nearer, but a distance moved 1% between the sides
    ({1: 0.1298, 2: 0.1300}, {1: 0.1312, 2: 0.1300}, (1, 2), False),
])
def test_first_search_tie(card, cpu, picks, tie):
    assert chip_smoke.first_search_tie(card, cpu, picks) is tie


def test_dsa_ties_raises_for_rows_searched_alike(monkeypatch):
    monkeypatch.setitem(chip_smoke.PATHS["mnist"], "sa", [6])
    params = params_from_jax(init_params("mnist", torch.Generator().manual_seed(0)))
    (x_tr, y_tr), (x_te, y_te) = synthetic.image_classification(0, 120, 30, (28, 28, 1))
    small = ((x_tr, y_tr), (x_te, y_te), (x_te, y_te))
    assert chip_smoke.dsa_ties("mnist", params, small, CPU, {"nominal": [], "ood": []}) == {}
    with pytest.raises(AssertionError, match="without a first-search tie"):
        chip_smoke.dsa_ties("mnist", params, small, CPU, {"nominal": [3]})


@pytest.fixture()
def generated(tmp_path, monkeypatch):
    """A small MNIST archive and the cache its loader generates on the CPU."""
    monkeypatch.setenv("TIP_DATA_DIR", str(tmp_path))
    (_, _), (x_te, y_te) = synthetic.image_classification(2, 10, 45, (28, 28, 1))
    np.savez(tmp_path / "mnist.npz", x_train=np.zeros((10, 28, 28), np.uint8),
             y_train=np.zeros(10, np.int64),
             x_test=np.round(x_te[..., 0] * 255).astype(np.uint8), y_test=y_te)
    loaders.load_mnist.cache_clear()
    triple = loaders.load_mnist(device="cpu")
    yield str(tmp_path), triple, (x_te, y_te)
    loaders.load_mnist.cache_clear()


def test_check_generated_passes_on_the_loaders_cache(generated):
    folder, triple, nominal = generated
    record = chip_smoke.check_generated("mnist", triple, nominal, folder, CPU)
    assert record["recomputed_max_err"] == 0.0 and sum(record["kinds"].values()) == 45


@pytest.mark.parametrize("mutation", ["label", "image"])
def test_check_generated_catches_a_changed_cache(generated, mutation):
    folder, triple, nominal = generated
    name = "mnist_c_labels.npy" if mutation == "label" else "mnist_c_images.npy"
    array = np.load(os.path.join(folder, name))
    if mutation == "label":
        array[0] = (array[0] + 1) % 10
    else:
        array[:] = np.clip(array.astype(np.int64) + 2, 0, 255).astype(np.uint8)
    np.save(os.path.join(folder, name), array)
    with pytest.raises(AssertionError):
        chip_smoke.check_generated("mnist", triple, nominal, folder, CPU)
