"""The port's loaders (``simple_tip_tpu_torch/data/loaders.py``) against the
JAX package's, on the CPU, over one temporary ``TIP_DATA_DIR`` that both
packages see (their ``lru_cache``s cleared around every change):
``dataset_presence`` in all four states; the synthetic fallback byte-equal
by default and under ``TIP_SYNTH_HARDNESS``; the sizes ``TIP_SYNTH_SCALE``
selects; small ``.npz`` fixtures with caches giving byte-equal triples;
with nominal data only, the port generating and caching a set whose
labels, allocation and file formats are the JAX package's; each package
reading the other's cache byte-equal; an incomplete cache never
overwritten; IMDB's real layout byte-equal."""

import os

import numpy as np
import pytest

from simple_tip_tpu.data import loaders as jax_loaders
from simple_tip_tpu_torch.data import image_corruptor, loaders
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

IMAGE_CASES = {"mnist": (28, 1, True), "fmnist": (28, 1, False), "cifar10": (32, 3, True)}


def _clear():
    for module in (loaders, jax_loaders):
        for fn in (module.load_mnist, module.load_fmnist, module.load_cifar10, module.load_imdb):
            fn.cache_clear()


@pytest.fixture()
def data_dir(tmp_path, monkeypatch):
    d = tmp_path / "datasets"
    d.mkdir()
    monkeypatch.setenv("TIP_DATA_DIR", str(d))
    monkeypatch.delenv("TIP_SYNTH_SCALE", raising=False)
    monkeypatch.delenv("TIP_SYNTH_HARDNESS", raising=False)
    _clear()
    yield d
    _clear()


def _write_npz(folder, name, n_train=30, n_test=16, seed=0):
    hw, c, _ = IMAGE_CASES[name]
    rng = np.random.default_rng(seed)
    shape = (hw, hw) if c == 1 else (hw, hw, c)
    np.savez(
        os.path.join(folder, f"{name}.npz"),
        x_train=rng.integers(0, 256, size=(n_train,) + shape, dtype=np.uint8),
        y_train=rng.integers(0, 10, size=(n_train, 1)).astype(np.int64),
        x_test=rng.integers(0, 256, size=(n_test,) + shape, dtype=np.uint8),
        y_test=rng.integers(0, 10, size=n_test).astype(np.int64),
    )


def _load(name, package):
    fn = getattr(package, f"load_{name}")
    return fn(device="cpu") if package is loaders else fn()


def _assert_same_triple(got, want):
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype and gx.shape == wx.shape
        assert gy.dtype == wy.dtype and gy.shape == wy.shape
        assert gx.tobytes() == wx.tobytes()
        assert gy.tobytes() == wy.tobytes()


@pytest.mark.parametrize("name", ["mnist", "fmnist", "cifar10", "imdb"])
def test_presence_states_equal_jax(data_dir, name):
    def both():
        state = loaders.dataset_presence(name)
        assert state == jax_loaders.dataset_presence(name)
        return state

    assert both() == "synthetic"
    if name == "imdb":
        (data_dir / "imdb").mkdir()
        for f in loaders.IMDB_CACHE_FILES[:-1]:
            np.save(data_dir / "imdb" / f, np.zeros(2))
        assert both() == "synthetic"
        np.save(data_dir / "imdb" / loaders.IMDB_CACHE_FILES[-1], np.zeros(2))
        assert both() == "real"
        return
    _write_npz(data_dir, name)
    assert both() == "nominal-only"
    np.save(data_dir / f"{name}_c_labels.npy", np.zeros(2))
    assert both() == "incomplete-cache"
    np.save(data_dir / f"{name}_c_images.npy", np.zeros(2))
    assert both() == "real"


@pytest.mark.parametrize("hardness", [None, "0", "0.2"])
@pytest.mark.parametrize("name", ["mnist", "fmnist", "cifar10", "imdb"])
def test_synthetic_fallback_is_byte_equal(data_dir, monkeypatch, name, hardness):
    """At 300 / 100 rows (both packages' size knob patched) the stand-ins,
    their corruptions and the OOD mix are byte-equal."""
    if hardness is not None:
        monkeypatch.setenv("TIP_SYNTH_HARDNESS", hardness)
    for module in (loaders, jax_loaders):
        monkeypatch.setattr(module, "_synth_sizes", lambda default, paper: (300, 100))
    _assert_same_triple(_load(name, loaders), _load(name, jax_loaders))


def test_paper_scale_knob_selects_the_paper_sizes(monkeypatch):
    default, paper = (12000, 2000), (60000, 10000)
    assert loaders._synth_sizes(default, paper) == jax_loaders._synth_sizes(default, paper)
    assert loaders._synth_sizes(default, paper) == default
    for value in ("paper", " PAPER "):
        monkeypatch.setenv("TIP_SYNTH_SCALE", value)
        assert loaders._synth_sizes(default, paper) == paper
        assert jax_loaders._synth_sizes(default, paper) == paper


@pytest.mark.parametrize("name", sorted(IMAGE_CASES))
def test_npz_with_caches_gives_equal_triples(data_dir, name):
    hw, c, scale_uint8 = IMAGE_CASES[name]
    _write_npz(data_dir, name)
    rng = np.random.default_rng(3)
    shape = (16, hw, hw) if c == 1 else (16, hw, hw, c)
    images = (rng.integers(0, 256, size=shape, dtype=np.uint8) if scale_uint8
              else rng.random(shape, dtype=np.float32))
    np.save(data_dir / f"{name}_c_images.npy", images)
    np.save(data_dir / f"{name}_c_labels.npy", rng.integers(0, 10, size=16))
    got = _load(name, loaders)
    _assert_same_triple(got, _load(name, jax_loaders))
    assert got[2][0].shape == (32, hw, hw, c)


@pytest.mark.parametrize("name", sorted(IMAGE_CASES))
def test_generated_cache_follows_the_jax_format(data_dir, name):
    """With the archive only, the port generates the corrupted set on the
    CPU and caches it in the JAX package's names and dtypes; labels and OOD
    layout are the JAX package's draws (the images differ where the kinds
    draw random values)."""
    hw, c, scale_uint8 = IMAGE_CASES[name]
    _write_npz(data_dir, name)
    got = _load(name, loaders)
    assert loaders.dataset_presence(name) == "real"
    cached = np.load(data_dir / f"{name}_c_images.npy")
    labels = np.load(data_dir / f"{name}_c_labels.npy")
    assert cached.dtype == (np.uint8 if scale_uint8 else np.float32)
    assert cached.shape == ((16, hw, hw, c))
    assert labels.dtype == np.int64 and labels.shape == (16,)
    # the same numpy draws as the JAX generator, on the same nominal set
    with np.load(data_dir / f"{name}.npz") as d:
        x_test = d["x_test"].astype("float32") / 255.0
        y_test = d["y_test"].astype(np.int64)
    if x_test.ndim == 3:
        x_test = x_test[..., None]
    kinds = image_corruptor.CIFAR10_C_KINDS if name == "cifar10" else image_corruptor.MNIST_C_KINDS
    rng = np.random.default_rng({"mnist": 11, "fmnist": 22, "cifar10": 33}[name])
    parts = []
    for idx in image_corruptor._allocate(rng, 16, 16, len(kinds)):
        rng.integers(1, 6, size=len(idx))
        parts.append(y_test[idx])
    np.testing.assert_array_equal(labels, np.concatenate(parts)[rng.permutation(16)])
    corrupted = cached.astype(np.float32) / 255.0 if scale_uint8 else cached
    ood = jax_loaders._ood_mix(x_test, y_test, corrupted, labels, seed=0)
    np.testing.assert_array_equal(got[2][0], ood[0])
    np.testing.assert_array_equal(got[2][1], ood[1])


@pytest.mark.parametrize("name", sorted(IMAGE_CASES))
def test_generated_labels_equal_jax(data_dir, name, monkeypatch):
    """The JAX package's generator on the same archive (in another folder)
    draws the same labels in the same order."""
    _write_npz(data_dir, name)
    port_labels = _load(name, loaders)[2][1]
    other = data_dir.parent / "jax_datasets"
    other.mkdir()
    _write_npz(other, name)
    monkeypatch.setenv("TIP_DATA_DIR", str(other))
    _clear()
    want = _load(name, jax_loaders)
    np.testing.assert_array_equal(port_labels, want[2][1])
    assert sorted(os.listdir(other)) == sorted(os.listdir(data_dir))
    for f in (f"{name}_c_images.npy", f"{name}_c_labels.npy"):
        a, b = np.load(other / f), np.load(data_dir / f)
        assert a.dtype == b.dtype and a.shape == b.shape


@pytest.mark.parametrize("name", ["mnist", "cifar10"])
@pytest.mark.parametrize("first", ["jax", "port"])
def test_each_package_reads_the_others_cache(data_dir, name, first):
    _write_npz(data_dir, name)
    packages = {"jax": jax_loaders, "port": loaders}
    want = _load(name, packages[first])
    _clear()
    second = "port" if first == "jax" else "jax"
    _assert_same_triple(_load(name, packages[second]), want)


def test_incomplete_cache_is_never_overwritten(data_dir):
    _write_npz(data_dir, "mnist")
    stray = data_dir / "mnist_c_images.npy"
    np.save(stray, np.arange(5))
    before = stray.read_bytes()
    (_, _), (x_test, _), (ood_x, ood_y) = _load("mnist", loaders)
    assert stray.read_bytes() == before
    assert not (data_dir / "mnist_c_labels.npy").exists()
    assert ood_x.shape[0] == 2 * x_test.shape[0] == ood_y.shape[0]
    assert loaders.dataset_presence("mnist") == "incomplete-cache"


def test_imdb_real_layout_is_byte_equal(data_dir):
    folder = data_dir / "imdb"
    folder.mkdir()
    rng = np.random.default_rng(4)
    arrays = {"x_train": rng.integers(0, 2000, size=(40, 100)),
              "y_train": rng.integers(0, 2, size=40),
              "x_test": rng.integers(0, 2000, size=(20, 100)),
              "y_test": rng.integers(0, 2, size=20),
              "x_corrupted": rng.integers(0, 2000, size=(20, 100))}
    for k, v in arrays.items():
        np.save(folder / f"{k}.npy", v)
    got = _load("imdb", loaders)
    _assert_same_triple(got, _load("imdb", jax_loaders))
    assert got[0][0].dtype == np.int32 and got[2][0].shape == (40, 100)


def test_generation_needs_a_device(data_dir, monkeypatch):
    """Without ``device``, a missing cache is generated on the card, and
    with no card the loader raises instead of using the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _write_npz(data_dir, "mnist")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loaders.load_mnist()
    assert loaders.dataset_presence("mnist") == "nominal-only"
