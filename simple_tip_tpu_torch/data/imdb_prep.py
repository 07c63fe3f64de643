"""IMDB preprocessing: tokenizer + padding with Keras-equivalent semantics,
and the cache-building pipeline (reference: src/dnn_test_prio/
case_study_imdb.py:295-344 uses keras' Tokenizer + pad_sequences; this module
reimplements their exact behavior so token ids and shapes match).

Builds the ``TIP_DATA_DIR/imdb/*.npy`` caches from raw texts; raw IMDB texts
must be supplied locally (zero egress). The port's own copy of the JAX
package's ``data/imdb_prep.py``: the same arrays from the same texts; the
text corruptor's distance matrix is computed on ``device``.
"""

import os
from collections import Counter
from typing import Dict, List, Sequence

import numpy as np

from simple_tip_tpu_torch.device import DeviceLike

KERAS_FILTERS = '!"#$%&()*+,-./:;<=>?@[\\]^_`{|}~\t\n'


class KerasLikeTokenizer:
    """Reimplementation of tf.keras.preprocessing.text.Tokenizer defaults:
    lowercase, strip filter chars, split on spaces; ranks words by frequency
    (ties broken by insertion order); ``texts_to_sequences`` keeps only words
    with rank < num_words."""

    def __init__(self, num_words: int = None):
        self.num_words = num_words
        self.word_counts: Counter = Counter()
        self.word_index: Dict[str, int] = {}

    @staticmethod
    def _text_to_word_sequence(text: str) -> List[str]:
        text = text.lower()
        translate_map = {ord(c): " " for c in KERAS_FILTERS}
        text = text.translate(translate_map)
        return [w for w in text.split(" ") if w]

    def fit_on_texts(self, texts: Sequence[str]) -> None:
        """Count words and assign frequency-ranked indices (1-based)."""
        word_order: List[str] = []
        for text in texts:
            seq = self._text_to_word_sequence(text)
            for w in seq:
                if w not in self.word_counts:
                    word_order.append(w)
                self.word_counts[w] += 1
        # Keras sorts by count desc; python's sort is stable, and keras uses
        # the counts dict's insertion order for ties.
        wcounts = sorted(
            ((w, self.word_counts[w]) for w in word_order),
            key=lambda x: x[1],
            reverse=True,
        )
        self.word_index = {w: i + 1 for i, (w, _) in enumerate(wcounts)}

    def texts_to_sequences(self, texts: Sequence[str]) -> List[List[int]]:
        """Map texts to lists of in-vocabulary word ranks."""
        res = []
        for text in texts:
            seq = self._text_to_word_sequence(text)
            vect = []
            for w in seq:
                i = self.word_index.get(w)
                if i is not None and (self.num_words is None or i < self.num_words):
                    vect.append(i)
            res.append(vect)
        return res


def pad_sequences(sequences: List[List[int]], maxlen: int) -> np.ndarray:
    """Keras pad_sequences defaults: pre-padding with 0, pre-truncating."""
    out = np.zeros((len(sequences), maxlen), dtype=np.int32)
    for i, seq in enumerate(sequences):
        if not seq:
            continue
        trunc = seq[-maxlen:]
        out[i, -len(trunc) :] = trunc
    return out


def build_imdb_caches(
    x_train_texts: List[str],
    y_train: List[int],
    x_test_texts: List[str],
    y_test: List[int],
    out_folder: str,
    vocab_size: int = 2000,
    maxlen: int = 100,
    severity: float = 0.5,
    seed: int = 0,
    device: DeviceLike = None,
) -> None:
    """Produce the reference-named npy caches (x_train, y_train, x_test,
    y_test, x_corrupted) from raw texts, including the thesaurus-corrupted OOD
    set at the reference's severity (case_study_imdb.py:319)."""
    from simple_tip_tpu_torch.ops.text_corruptor import TextCorruptor

    corruptor = TextCorruptor(
        base_dataset=list(x_train_texts) + list(x_test_texts),
        cache_dir=os.path.join(out_folder, "corruptor"),
        device=device,
    )
    x_test_ood = corruptor.corrupt(list(x_test_texts), severity=severity, seed=seed)

    tokenizer = KerasLikeTokenizer(num_words=vocab_size)
    tokenizer.fit_on_texts(x_train_texts)

    x_train = pad_sequences(tokenizer.texts_to_sequences(x_train_texts), maxlen)
    x_test = pad_sequences(tokenizer.texts_to_sequences(x_test_texts), maxlen)
    x_corrupted = pad_sequences(tokenizer.texts_to_sequences(x_test_ood), maxlen)

    os.makedirs(out_folder, exist_ok=True)
    np.save(os.path.join(out_folder, "x_train.npy"), x_train)
    np.save(os.path.join(out_folder, "y_train.npy"), np.asarray(y_train))
    np.save(os.path.join(out_folder, "x_test.npy"), x_test)
    np.save(os.path.join(out_folder, "y_test.npy"), np.asarray(y_test))
    np.save(os.path.join(out_folder, "x_corrupted.npy"), x_corrupted)
