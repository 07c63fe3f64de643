"""Deterministic synthetic stand-in datasets (numpy only).

The port's own copy of the JAX package's ``data/synthetic.py`` generators
that ``chip_smoke.py`` draws its full-size inputs with: the same seeds give
the same arrays as there under any hardness
(``tests/test_torch_synthetic.py``). Shapes, dtypes, value ranges and class
structure match the real datasets; the signal is class-dependent. A
fraction of samples (``hard_frac``, else ``TIP_SYNTH_HARDNESS``, else
``DEFAULT_HARDNESS``) is made ambiguous (an even blend of the labelled class
and a random partner class), which keeps nominal misclassifications, and so
nominal APFD, non-degenerate; ``TIP_SYNTH_HARDNESS=0`` gives the fully
separable sets.

``english_like_texts`` makes raw texts for the text corruptor and the IMDB
cache builder (words of random syllables under a Zipf law).
"""

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_HARDNESS = 0.08


def _hardness(explicit: Optional[float]) -> float:
    """Ambiguous-sample fraction: ``explicit``, else ``TIP_SYNTH_HARDNESS``,
    else the default, clipped to [0, 1]. Read when a set is generated."""
    if explicit is not None:
        return min(1.0, max(0.0, float(explicit)))
    try:
        val = float(os.environ.get("TIP_SYNTH_HARDNESS", DEFAULT_HARDNESS))
    except ValueError:
        val = DEFAULT_HARDNESS
    return min(1.0, max(0.0, val))


def image_classification(
    seed: int,
    n_train: int,
    n_test: int,
    shape: Tuple[int, int, int],
    num_classes: int = 10,
    noise: float = 0.25,
    hard_frac: Optional[float] = None,
):
    """Class-stamped noisy images in [0, 1], uint8-quantised like real data.

    Returns ``((x_train, y_train), (x_test, y_test))``, float32 NHWC images
    and int64 labels.
    """
    hard_frac = _hardness(hard_frac)
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
        if hard_frac > 0 and num_classes > 1:
            hard = rng.random(n) < hard_frac
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
    hard_frac: Optional[float] = None,
):
    """Token sequences whose classes over-sample disjoint vocabulary bands
    (an IMDB stand-in). Returns int32 tokens ``[n, maxlen]`` and int64
    labels; ``hard_frac`` of samples split their band budget evenly with a
    partner class. At hardness 0 the draws follow the JAX package's older
    generator (the same stream as there)."""
    hard_frac = _hardness(hard_frac)
    rng = np.random.default_rng(seed)

    def make(n, rng):
        labels = rng.integers(0, num_classes, size=n)
        if hard_frac == 0.0 or num_classes < 2:
            x = rng.integers(1, vocab_size, size=(n, maxlen))
            for cls in range(num_classes):
                idx = np.where(labels == cls)[0]
                band_lo = 100 + cls * 300
                mask = rng.random((idx.shape[0], maxlen)) < 0.3
                band_tokens = rng.integers(band_lo, band_lo + 300, size=(idx.shape[0], maxlen))
                x[idx] = np.where(mask, band_tokens, x[idx])
            return x.astype(np.int32), labels.astype(np.int64)
        hard = rng.random(n) < hard_frac
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


_ONSETS = ("b", "c", "d", "f", "g", "h", "k", "l", "m", "n", "p", "r", "s", "t", "v", "w",
           "br", "ch", "cl", "dr", "fl", "gr", "pl", "sh", "st", "th", "tr", "")
_VOWELS = ("a", "e", "i", "o", "u", "ea", "ou", "ai", "io", "ee")
_CODAS = ("", "", "n", "r", "s", "t", "l", "nd", "st", "ng", "ck", "m")


def english_like_texts(seed: int, n_texts: int, vocabulary: int = 6000,
                       words_per_text: Tuple[int, int] = (40, 120),
                       base_words: Sequence[str] = ()) -> Tuple[List[str], np.ndarray]:
    """``n_texts`` English-like reviews and their 0/1 labels.

    A vocabulary of ``vocabulary`` distinct words, ``base_words`` first (for
    example a thesaurus's, so that synonym corruptions find some) and then
    words of one to three random syllables (a fifth of them one-syllable
    function words), is sampled under a Zipf law in a shuffled order; each
    label over-samples its own tenth of the vocabulary.
    Sentences start with a capital and end with ``.``, ``!`` or ``?``, and
    commas fall between words, so the texts exercise the tokenizer's
    filters and the corruptor's punctuation split.
    """
    rng = np.random.default_rng(seed)
    words = list(dict.fromkeys(w.lower() for w in base_words))[:vocabulary]
    seen = set(words)
    while len(words) < vocabulary:
        n_syll = 1 if len(words) % 5 == 0 else int(rng.integers(2, 4))
        w = "".join(_ONSETS[rng.integers(len(_ONSETS))] + _VOWELS[rng.integers(len(_VOWELS))]
                    + _CODAS[rng.integers(len(_CODAS))] for _ in range(n_syll))
        if w not in seen:
            seen.add(w)
            words.append(w)
    words = [words[i] for i in rng.permutation(vocabulary)]
    weights = 1.0 / np.arange(1, vocabulary + 1)
    labels = rng.integers(0, 2, size=n_texts)
    band = vocabulary // 10
    texts = []
    for label in labels:
        n = int(rng.integers(*words_per_text))
        idx = rng.choice(vocabulary, size=n, p=weights / weights.sum())
        own = rng.random(n) < 0.15
        idx[own] = rng.integers(band * (1 + label), band * (2 + label), size=int(own.sum()))
        parts, start = [], True
        for i, k in enumerate(idx):
            w = words[k]
            parts.append(w.capitalize() if start else w)
            start = False
            r = rng.random()
            if r < 0.08 or i == n - 1:
                parts[-1] += ".!?"[int(rng.integers(3))]
                start = True
            elif r < 0.14:
                parts[-1] += ","
        texts.append(" ".join(parts))
    return texts, labels.astype(np.int64)
