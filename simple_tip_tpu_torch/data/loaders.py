"""Case-study dataset loaders of the port: real npy/npz caches when present,
synthetic stand-ins otherwise.

The port's own copy of the JAX package's ``data/loaders.py``. Each loader
returns ``((x_train, y_train), (x_test, y_test), (ood_x, ood_y))``; the OOD
set is the nominal test set and its corrupted copy, concatenated and
shuffled with ``np.random.default_rng(0)``.

Real-data file layout under ``TIP_DATA_DIR`` (``./datasets`` by default),
the JAX package's:

- ``mnist.npz`` / ``fmnist.npz`` / ``cifar10.npz``: keras-style archives with
  x_train, y_train, x_test, y_test (uint8 images / int labels);
- ``{mnist,fmnist,cifar10}_c_images.npy`` + ``..._c_labels.npy``: the
  corrupted set (uint8 for MNIST and CIFAR-10, float32 in [0, 1] for
  fmnist); when only the archive is there, the loader generates it with
  ``data/image_corruptor.py`` on ``device`` (the card unless the caller
  asks for the CPU) and caches it. The two packages share these files, so
  whichever generated a study's cache first fixes its OOD set;
- ``imdb/x_train.npy, y_train.npy, x_test.npy, y_test.npy, x_corrupted.npy``:
  tokenized and padded sequences (``data/imdb_prep.py`` builds them).
"""

import logging
import os
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np

from simple_tip_tpu_torch.config import data_folder
from simple_tip_tpu_torch.data import synthetic
from simple_tip_tpu_torch.device import DeviceLike

logger = logging.getLogger(__name__)

Triple = Tuple[
    Tuple[np.ndarray, np.ndarray],
    Tuple[np.ndarray, np.ndarray],
    Tuple[np.ndarray, np.ndarray],
]

IMDB_CACHE_FILES = [
    "x_train.npy",
    "y_train.npy",
    "x_test.npy",
    "y_test.npy",
    "x_corrupted.npy",
]


def dataset_presence(name: str) -> str:
    """What the loader would consume for ``name`` right now:

    - ``"real"``: nominal data and corruption cache both present;
    - ``"nominal-only"``: nominal archive present, corruption cache absent
      (the image loaders generate a corrupted set and cache it);
    - ``"incomplete-cache"``: exactly one corruption-cache file present (the
      loader refuses to overwrite it and uses a generated set in memory);
    - ``"synthetic"``: no real data; deterministic stand-ins.
    """
    root = data_folder()
    if name == "imdb":
        have = all(os.path.exists(os.path.join(root, "imdb", f)) for f in IMDB_CACHE_FILES)
        return "real" if have else "synthetic"
    if not os.path.exists(os.path.join(root, f"{name}.npz")):
        return "synthetic"
    img = os.path.exists(os.path.join(root, f"{name}_c_images.npy"))
    lab = os.path.exists(os.path.join(root, f"{name}_c_labels.npy"))
    if img and lab:
        return "real"
    if img or lab:
        return "incomplete-cache"
    return "nominal-only"


def _npz_path(name: str) -> Optional[str]:
    path = os.path.join(data_folder(), name)
    return path if os.path.exists(path) else None


def _atomic_save(path: str, array: np.ndarray) -> None:
    """Write an npy atomically (temp file + rename), so an interrupted run
    never leaves a truncated file."""
    tmp = path + ".tmp.npy"  # ends in .npy so np.save keeps the name as-is
    np.save(tmp, array)
    os.replace(tmp, path)


def _warn_synthetic(name: str):
    logger.warning(
        "Dataset %s not found under %s — falling back to a DETERMINISTIC "
        "SYNTHETIC stand-in. Pipeline results are structurally valid but are "
        "NOT paper-comparable numbers.",
        name,
        data_folder(),
    )


def _synth_sizes(default: Tuple[int, int], paper: Tuple[int, int]) -> Tuple[int, int]:
    """Synthetic stand-in sizes: ``default``, or the dataset's real ``paper``
    scale under ``TIP_SYNTH_SCALE=paper``."""
    if os.environ.get("TIP_SYNTH_SCALE", "").strip().lower() == "paper":
        return paper
    return default


def _ood_mix(x_test, y_test, x_corr, y_corr, seed: int = 0):
    ood_x = np.concatenate((x_test, x_corr), axis=0)
    ood_y = np.concatenate((y_test, y_corr), axis=0)
    perm = np.random.default_rng(seed).permutation(len(ood_y))
    return ood_x[perm], ood_y[perm]


def _load_image_case(
    name: str,
    shape,
    synth_seed: int,
    scale_uint8: bool,
    device: DeviceLike,
    paper_sizes: Tuple[int, int] = (60000, 10000),
) -> Triple:
    npz = _npz_path(f"{name}.npz")
    c_img = _npz_path(f"{name}_c_images.npy")
    c_lab = _npz_path(f"{name}_c_labels.npy")
    if npz is not None:
        with np.load(npz) as d:
            x_train = d["x_train"].astype("float32") / 255.0
            y_train = d["y_train"].astype(np.int64).flatten()
            x_test = d["x_test"].astype("float32") / 255.0
            y_test = d["y_test"].astype(np.int64).flatten()
        if x_train.ndim == 3:
            x_train = x_train[..., None]
            x_test = x_test[..., None]
        if c_img is not None and c_lab is not None:
            x_corr = np.load(c_img).astype("float32")
            if scale_uint8:
                x_corr = x_corr / 255.0
            if x_corr.ndim == 3:
                x_corr = x_corr[..., None]
            y_corr = np.load(c_lab).astype(np.int64).flatten()
        else:
            from simple_tip_tpu_torch.data import image_corruptor

            logger.warning(
                "%s corruption cache missing — generating a %s-style corrupted "
                "set with simple_tip_tpu_torch.data.image_corruptor (cached for reuse)",
                name,
                "CIFAR-10-C" if name == "cifar10" else "MNIST-C",
            )
            make = (
                image_corruptor.cifar10_c_like
                if name == "cifar10"
                else image_corruptor.mnist_c_like
            )
            x_corr, y_corr = make(x_test, y_test, seed=synth_seed, device=device)
            if scale_uint8:
                quantized = np.round(x_corr * 255.0).astype(np.uint8)
                to_cache = quantized
                x_corr = quantized.astype("float32") / 255.0
            else:
                to_cache = x_corr
            if c_img is not None or c_lab is not None:
                # Exactly one of the two cache files exists: never overwrite
                # it with generated data; use the in-memory set.
                logger.error(
                    "%s corruption cache is INCOMPLETE (images: %s, labels: %s)"
                    " — refusing to overwrite; using generated set in-memory."
                    " Fix or remove the existing file to enable caching.",
                    name,
                    c_img or "missing",
                    c_lab or "missing",
                )
            else:
                try:
                    _atomic_save(os.path.join(data_folder(), f"{name}_c_images.npy"), to_cache)
                    _atomic_save(os.path.join(data_folder(), f"{name}_c_labels.npy"), y_corr)
                except OSError as e:  # read-only dataset volume: keep in-memory set
                    logger.warning("could not cache %s corrupted set (%s)", name, e)
    else:
        _warn_synthetic(name)
        n_train, n_test = _synth_sizes((12000, 2000), paper_sizes)
        (x_train, y_train), (x_test, y_test) = synthetic.image_classification(
            seed=synth_seed, n_train=n_train, n_test=n_test, shape=shape
        )
        x_corr = synthetic.corrupt_images(x_test, seed=synth_seed + 1)
        y_corr = y_test.copy()
    ood_x, ood_y = _ood_mix(x_test, y_test, x_corr, y_corr, seed=0)
    return (x_train, y_train), (x_test, y_test), (ood_x, ood_y)


@lru_cache(maxsize=None)
def load_mnist(device: DeviceLike = None) -> Triple:
    """MNIST + MNIST-C (or synthetic stand-ins); a missing corruption cache
    is generated on ``device``."""
    return _load_image_case("mnist", (28, 28, 1), synth_seed=11, scale_uint8=True, device=device)


@lru_cache(maxsize=None)
def load_fmnist(device: DeviceLike = None) -> Triple:
    """Fashion-MNIST + fmnist-C (or synthetic stand-ins); its corruption
    cache holds floats."""
    return _load_image_case("fmnist", (28, 28, 1), synth_seed=22, scale_uint8=False,
                            device=device)


@lru_cache(maxsize=None)
def load_cifar10(device: DeviceLike = None) -> Triple:
    """CIFAR-10 + CIFAR-10-C sample (or synthetic stand-ins)."""
    return _load_image_case(
        "cifar10",
        (32, 32, 3),
        synth_seed=33,
        scale_uint8=True,
        device=device,
        paper_sizes=(50000, 10000),  # CIFAR-10's real split is 50k/10k
    )


@lru_cache(maxsize=None)
def load_imdb(maxlen: int = 100, vocab_size: int = 2000, device: DeviceLike = None) -> Triple:
    """Tokenized IMDB + thesaurus-corrupted OOD set (or synthetic stand-ins).

    The corrupted set reuses y_test (corruption is label-preserving), so
    ood = (x_test ++ x_corrupted, y_test ++ y_test), shuffled with seed 0.
    ``device`` is unused (the caches are tokens) and kept so that every
    loader takes it.
    """
    folder = os.path.join(data_folder(), "imdb")
    if dataset_presence("imdb") == "real":
        x_train = np.load(os.path.join(folder, "x_train.npy")).astype(np.int32)
        y_train = np.load(os.path.join(folder, "y_train.npy")).astype(np.int64)
        x_test = np.load(os.path.join(folder, "x_test.npy")).astype(np.int32)
        y_test = np.load(os.path.join(folder, "y_test.npy")).astype(np.int64)
        x_corr = np.load(os.path.join(folder, "x_corrupted.npy")).astype(np.int32)
    else:
        _warn_synthetic("imdb")
        n_train, n_test = _synth_sizes((10000, 2500), (25000, 25000))
        (x_train, y_train), (x_test, y_test) = synthetic.token_classification(
            seed=44, n_train=n_train, n_test=n_test, maxlen=maxlen, vocab_size=vocab_size
        )
        x_corr = synthetic.corrupt_tokens(x_test, seed=45, vocab_size=vocab_size)
    ood_x, ood_y = _ood_mix(x_test, y_test, x_corr, y_test.copy(), seed=0)
    return (x_train, y_train), (x_test, y_test), (ood_x, ood_y)
