"""Deterministic synthetic stand-in datasets (numpy only).

The port's own copy of the JAX package's ``data/synthetic.py`` generators
that ``chip_smoke.py`` draws its full-size inputs with: the same seeds give
the same arrays as there at their default hardness
(``tests/test_torch_synthetic.py``). Shapes, dtypes, value ranges and class
structure match the real datasets; the signal is class-dependent. A fixed
fraction ``HARD_FRAC`` of samples is made ambiguous (an even blend of the
labelled class and a random partner class), which keeps nominal
misclassifications, and so nominal APFD, non-degenerate.
"""

from typing import Tuple

import numpy as np

HARD_FRAC = 0.08


def image_classification(
    seed: int,
    n_train: int,
    n_test: int,
    shape: Tuple[int, int, int],
    num_classes: int = 10,
    noise: float = 0.25,
):
    """Class-stamped noisy images in [0, 1], uint8-quantised like real data.

    Returns ``((x_train, y_train), (x_test, y_test))``, float32 NHWC images
    and int64 labels.
    """
    rng = np.random.default_rng(seed)
    h, w, c = shape
    # Per-class fixed random template with a localised bright stamp.
    templates = rng.uniform(0.0, 0.4, size=(num_classes, h, w, c)).astype(np.float32)
    for cls in range(num_classes):
        r = (cls * 7919) % (h - 8)
        col = (cls * 104729) % (w - 8)
        templates[cls, r : r + 8, col : col + 8, :] += np.float32(0.55)

    def make(n, rng):
        labels = rng.integers(0, num_classes, size=n)
        x = templates[labels]
        if num_classes > 1:
            hard = rng.random(n) < HARD_FRAC
            partners = (labels + rng.integers(1, num_classes, size=n)) % num_classes
            x[hard] = 0.5 * x[hard] + 0.5 * templates[partners[hard]]
        x += rng.normal(0, noise, size=(n, h, w, c)).astype(np.float32)
        x = np.clip(x, 0, 1)
        x = np.round(x * 255).astype(np.uint8).astype(np.float32) / 255.0
        return x, labels.astype(np.int64)

    x_train, y_train = make(n_train, rng)
    x_test, y_test = make(n_test, rng)
    return (x_train, y_train), (x_test, y_test)


def corrupt_images(x: np.ndarray, seed: int, severity: float = 0.5) -> np.ndarray:
    """Additive noise, contrast loss or translation per image (a stand-in
    for the *-C corruption benchmarks)."""
    rng = np.random.default_rng(seed)
    out = x.copy()
    n = x.shape[0]
    kinds = rng.integers(0, 3, size=n)
    idx = np.where(kinds == 0)[0]
    out[idx] = np.clip(out[idx] + rng.normal(0, severity * 0.5, out[idx].shape), 0, 1)
    idx = np.where(kinds == 1)[0]
    out[idx] = out[idx] * (1 - severity) + out[idx].mean() * severity
    idx = np.where(kinds == 2)[0]
    shift = max(1, int(severity * 6))
    out[idx] = np.roll(out[idx], shift, axis=1)
    return out.astype(np.float32)


def token_classification(
    seed: int,
    n_train: int,
    n_test: int,
    maxlen: int = 100,
    vocab_size: int = 2000,
    num_classes: int = 2,
):
    """Token sequences whose classes over-sample disjoint vocabulary bands
    (an IMDB stand-in). Returns int32 tokens ``[n, maxlen]`` and int64
    labels; ``HARD_FRAC`` of samples split their band budget evenly with a
    partner class."""
    rng = np.random.default_rng(seed)

    def make(n, rng):
        labels = rng.integers(0, num_classes, size=n)
        hard = rng.random(n) < HARD_FRAC
        partners = (labels + rng.integers(1, num_classes, size=n)) % num_classes
        x = rng.integers(1, vocab_size, size=(n, maxlen))
        for cls in range(num_classes):
            band_lo = 100 + cls * 300
            band_all = rng.integers(band_lo, band_lo + 300, size=(n, maxlen))
            own = (labels == cls) & ~hard
            half = ((labels == cls) | (partners == cls)) & hard
            mask = rng.random((n, maxlen))
            sel = (own[:, None] & (mask < 0.3)) | (half[:, None] & (mask < 0.15))
            x = np.where(sel, band_all, x)
        return x.astype(np.int32), labels.astype(np.int64)

    x_train, y_train = make(n_train, rng)
    x_test, y_test = make(n_test, rng)
    return (x_train, y_train), (x_test, y_test)


def corrupt_tokens(
    x: np.ndarray, seed: int, severity: float = 0.5, vocab_size: int = 2000
) -> np.ndarray:
    """Random token replacement at rate ``0.4 * severity`` (a stand-in for
    the thesaurus-corrupted IMDB set)."""
    rng = np.random.default_rng(seed)
    mask = rng.random(x.shape) < severity * 0.4
    noise = rng.integers(1, vocab_size, size=x.shape)
    return np.where(mask, noise, x).astype(x.dtype)
