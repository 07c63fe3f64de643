"""The port's real-data onramp (``data/real_onramp.py``) against the JAX
package's, on the CPU.

Raw layouts are written from a seed, twice, into one folder per package:
the 15 MNIST-C corruption folders, a CIFAR-10-C release of three
corruptions, the fmnist-C pair and ``imdb/raw/{train,test}.jsonl`` (a small
English-like corpus over the bundled thesaurus's words). ``OOD_SIZE`` is cut
to 150 in both packages. Each ``prepare_*`` and ``prepare_all`` (IMDB's
corruption on the CPU in the port) writes files byte-equal to the JAX
onramp's on the same raw files; the port's loaders then read them: the
MNIST-C slices equal the raw arrays, and ``load_imdb`` reads the corrupted
set.
"""

import json
import math
import os
import shutil

import numpy as np
import pytest

from simple_tip_tpu.data import real_onramp as jax_onramp
from simple_tip_tpu_torch.data import image_corruptor, loaders, real_onramp, synthetic
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

OOD = 150
SEED = 5


def _write_raw(root: str, seed: int) -> dict:
    """Every raw layout the onramp reads, under ``root``; returns the MNIST-C
    arrays by corruption."""
    rng = np.random.default_rng(seed)
    mnist_c = {}
    for corr in real_onramp.MNIST_CORRUPTION_TYPES:
        folder = os.path.join(root, "mnist_c", corr)
        os.makedirs(folder)
        images = rng.integers(0, 256, size=(OOD, 28, 28), dtype=np.uint8)
        labels = rng.integers(0, 10, size=OOD).astype(np.int64)
        np.save(os.path.join(folder, "test_images.npy"), images)
        np.save(os.path.join(folder, "test_labels.npy"), labels)
        mnist_c[corr] = (images, labels)
    cifar = os.path.join(root, "CIFAR-10-C")
    os.makedirs(cifar)
    np.save(os.path.join(cifar, "labels.npy"), rng.integers(0, 10, size=60).astype(np.int64))
    for corr in ("snow", "fog", "brightness"):
        np.save(os.path.join(cifar, f"{corr}.npy"),
                rng.integers(0, 256, size=(60, 32, 32, 3), dtype=np.uint8))
    np.save(os.path.join(root, "fmnist-c-test.npy"),
            rng.integers(0, 256, size=(40, 28, 28), dtype=np.uint8))
    np.save(os.path.join(root, "fmnist-c-test-labels.npy"),
            rng.integers(0, 10, size=40).astype(np.int64))
    asset = os.path.join(os.path.dirname(image_corruptor.__file__), "assets",
                         "en_thesaurus.jsonl")
    with open(asset) as f:
        base_words = [json.loads(line)["word"] for line in f][:300]
    texts, labels = synthetic.english_like_texts(seed, 36, vocabulary=300,
                                                 words_per_text=(12, 30), base_words=base_words)
    raw = os.path.join(root, "imdb", "raw")
    os.makedirs(raw)
    for split, rows in (("train", range(0, 24)), ("test", range(24, 36))):
        with open(os.path.join(raw, f"{split}.jsonl"), "w") as f:
            for i in rows:
                f.write(json.dumps({"text": texts[i], "label": int(labels[i])}) + "\n")
    return mnist_c


def _outputs(root: str) -> dict:
    names = ["mnist_c_images.npy", "mnist_c_labels.npy", "cifar10_c_images.npy",
             "cifar10_c_labels.npy", "fmnist_c_images.npy", "fmnist_c_labels.npy"]
    names += [os.path.join("imdb", f"{k}.npy")
              for k in ("x_train", "y_train", "x_test", "y_test", "x_corrupted")]
    out = {}
    for name in names:
        with open(os.path.join(root, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """Both packages' ``prepare_all`` on the same raw files."""
    base = tmp_path_factory.mktemp("onramp")
    roots = {side: str(base / side) for side in ("port", "jax")}
    mnist_c = _write_raw(roots["port"], SEED)
    shutil.copytree(roots["port"], roots["jax"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(real_onramp, "OOD_SIZE", OOD)
        mp.setattr(jax_onramp, "OOD_SIZE", OOD)
        reports = {"port": real_onramp.prepare_all(roots["port"], device="cpu"),
                   "jax": jax_onramp.prepare_all(roots["jax"])}
    return roots, reports, mnist_c


def test_prepare_all_reports_and_writes_as_jax(prepared):
    roots, reports, _ = prepared
    assert reports["port"] == {k: v.replace(roots["jax"], roots["port"])
                               for k, v in reports["jax"].items()}
    assert {reports["port"][k] for k in ("mnist_c", "cifar10_c", "fmnist_c", "imdb")} == {"built"}
    got, want = _outputs(roots["port"]), _outputs(roots["jax"])
    for name in want:
        assert got[name] == want[name], name


@pytest.mark.parametrize("which", ["mnist_c", "cifar10_c", "fmnist_c"])
def test_each_image_prepare_equals_jax(prepared, tmp_path, monkeypatch, which):
    roots = prepared[0]
    monkeypatch.setattr(real_onramp, "OOD_SIZE", OOD)
    monkeypatch.setattr(jax_onramp, "OOD_SIZE", OOD)
    paths = {}
    for side, mod in (("port", real_onramp), ("jax", jax_onramp)):
        out = str(tmp_path / side)
        os.makedirs(out)
        raw = roots[side]
        if which == "mnist_c":
            paths[side] = mod.prepare_mnist_c(os.path.join(raw, "mnist_c"), out)
        elif which == "cifar10_c":
            paths[side] = mod.prepare_cifar10_c(os.path.join(raw, "CIFAR-10-C"), out)
        else:
            paths[side] = mod.prepare_fmnist_c(os.path.join(raw, "fmnist-c-test.npy"),
                                               os.path.join(raw, "fmnist-c-test-labels.npy"),
                                               out)
    for got, want in zip(paths["port"], paths["jax"]):
        assert os.path.basename(got) == os.path.basename(want)
        with open(got, "rb") as f, open(want, "rb") as g:
            assert f.read() == g.read(), got
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))


def test_short_mnist_c_release_is_refused(tmp_path, monkeypatch):
    monkeypatch.setattr(real_onramp, "OOD_SIZE", 20_000)
    raw = tmp_path / "mnist_c"
    for corr in real_onramp.MNIST_CORRUPTION_TYPES:
        (raw / corr).mkdir(parents=True)
        np.save(raw / corr / "test_images.npy", np.zeros((10, 28, 28), np.uint8))
        np.save(raw / corr / "test_labels.npy", np.zeros(10, np.int64))
    with pytest.raises(ValueError, match="expected 20000"):
        real_onramp.prepare_mnist_c(str(raw), str(tmp_path))


def test_loaders_read_the_prepared_caches(prepared, monkeypatch):
    roots, _, mnist_c = prepared
    x = np.load(os.path.join(roots["port"], "mnist_c_images.npy"))
    y = np.load(os.path.join(roots["port"], "mnist_c_labels.npy"))
    per = math.ceil(OOD / len(real_onramp.MNIST_CORRUPTION_TYPES))
    assert x.shape == (OOD, 28, 28, 1) and x.dtype == np.uint8
    for i, corr in enumerate(real_onramp.MNIST_CORRUPTION_TYPES):
        lo, hi = i * per, min(OOD, (i + 1) * per)
        assert x[lo:hi, ..., 0].tobytes() == mnist_c[corr][0][lo:hi].tobytes(), corr
        assert y[lo:hi].tobytes() == mnist_c[corr][1][lo:hi].tobytes(), corr
    monkeypatch.setenv("TIP_DATA_DIR", roots["port"])
    assert loaders.dataset_presence("imdb") == "real"
    loaders.load_imdb.cache_clear()
    try:
        (tr_x, _), (te_x, _), (ood_x, ood_y) = loaders.load_imdb(device="cpu")
    finally:
        loaders.load_imdb.cache_clear()
    assert tr_x.shape == (24, 100) and te_x.shape == (12, 100)
    assert ood_x.shape == (24, 100) and len(ood_y) == 24
    x_corr = np.load(os.path.join(roots["port"], "imdb", "x_corrupted.npy"))
    assert (x_corr != te_x).any(), "the corruption changed no token"
