"""Deterministic, severity-monotonic English text corruption (IMDB-C generator).

Behavioral contract matches the reference (reference: src/core/text_corruptor.py):

- Four corruption types — TYPO (random char replacement), SYNONYM (thesaurus
  lookup; falls back to TYPO when no synonyms), AUTOCOMPLETE (word sharing a
  3..5-char prefix; falls back to AUTOCORRECT), AUTOCORRECT (one of the 5
  Levenshtein-nearest dictionary words, probability ~ 1/distance).
- Per-sentence seed = md5(text) + seed, so corruption of a text is independent
  of the order/subset of the dataset; higher severity strictly adds
  corruptions on top of those applied at lower severity.
- Reference quirk preserved verbatim: the sampling weights vector is ordered
  [typo, autocomplete, autocorrect, synonym] while the enum numbers TYPO=0,
  SYNONYM=1, AUTOCOMPLETE=2, AUTOCORRECT=3 — so ``autocomplete_weight``
  effectively weights SYNONYM, ``autocorrect_weight`` weights AUTOCOMPLETE and
  ``synonym_weight`` weights AUTOCORRECT (reference: src/core/
  text_corruptor.py:128-146 vs :92-102). Changing this would change every
  IMDB-C corruption draw, so parity wins over readability.
- Dictionary = the ``dictionary_size`` most frequent words (len>4, not
  numeric) of a base dataset; pickle/npy caching keyed by dataset hash.

The port's own copy of the JAX package's ``ops/text_corruptor.py``: the same
words, draws and caches (pickle and npy files of the same names and
contents, so either package reads the other's cache directory). Only the
dictionary's pairwise Levenshtein matrix runs on the device
(``ops/levenshtein.lev_matrix``, the card unless ``device="cpu"``); the
corruption itself is host Python, as in the JAX package.

The reference downloads a wordnet thesaurus at runtime; here it is read
from an explicit path, else ``TIP_DATA_DIR/en_thesaurus.jsonl``, else the
port's bundled ``data/assets/en_thesaurus.jsonl`` (a byte copy of the JAX
package's). With none of them, every SYNONYM corruption degrades to TYPO,
the reference's own no-synonym fallback.
"""

import collections
import dataclasses
import enum
import hashlib
import json
import logging
import os
import pickle
import re
import shutil
import warnings
from typing import Dict, List, Optional

import numpy as np

from simple_tip_tpu_torch.config import data_folder
from simple_tip_tpu_torch.device import DeviceLike
from simple_tip_tpu_torch.ops.levenshtein import lev_matrix

DEFAULT_CACHE_DIR = "./.text_corruption_cache/"

MAX_COMMON_START_FOR_AUTOCOMPLETE = 5
MIN_COMMON_START_FOR_AUTOCOMPLETE = 3

logger = logging.getLogger(__name__)


def split_by_whitespace(strings: List[str]) -> List[List[str]]:
    """Split strings into words (same regex as huggingface WhitespaceSplit)."""
    return [re.findall(r"\w+|[^\w\s]+", l) for l in strings]


def bad_autocompletes(
    word: str, start_bags: Dict[int, Dict[str, List[str]]], common_letters: int
) -> Optional[List[str]]:
    """Dictionary words sharing the first ``common_letters`` chars with
    ``word`` (recursively relaxing the prefix length down to 3)."""
    if common_letters < MIN_COMMON_START_FOR_AUTOCOMPLETE:
        return None
    common_letters = min(common_letters, len(word))
    start = word[:common_letters]
    bag = start_bags.get(common_letters, {}).get(start, [])
    bag = [w for w in bag if w != word]
    if len(bag) == 0:
        return bad_autocompletes(word, start_bags, common_letters=common_letters - 1)
    return bag


class CorruptionType(enum.Enum):
    """The four corruption types, imitating natural corruptions."""

    TYPO = 0
    SYNONYM = 1
    AUTOCOMPLETE = 2
    AUTOCORRECT = 3


def _get_rng(seed):
    return np.random.default_rng(seed)


@dataclasses.dataclass
class CorruptionWeights:
    """Probabilities of the different corruption types."""

    typo_weight: float = 0.05
    autocomplete_weight: float = 0.30
    autocorrect_weight: float = 0.30
    synonym_weight: float = 0.35


def _generate_corruption_types(
    seed: int, num_words: int, weights: CorruptionWeights
) -> List[CorruptionType]:
    w = np.array(
        [
            weights.typo_weight,
            weights.autocomplete_weight,
            weights.autocorrect_weight,
            weights.synonym_weight,
        ]
    )
    rng = _get_rng(seed)
    return [CorruptionType(rng.choice(4, p=w / w.sum())) for _ in range(num_words)]


def _hash_text_to_int(words: List[str]) -> int:
    return int(_hash_text_to_str(words), 16) % 1000000


def _hash_text_to_str(words: List[str]) -> str:
    return hashlib.md5(" ".join(words).encode("utf-8")).hexdigest()


class TextCorruptor:
    """Corruptor for arbitrary English text datasets. The dictionary's
    distance matrix is computed on ``device`` (the card by default) unless
    the cache holds it."""

    def __init__(
        self,
        base_dataset: List[str],
        cache_dir: Optional[str] = DEFAULT_CACHE_DIR,
        dictionary_size: int = 4000,
        clear_cache: bool = False,
        thesaurus_path: Optional[str] = None,
        device: DeviceLike = None,
    ):
        if cache_dir is DEFAULT_CACHE_DIR:
            warnings.warn(
                "Using default cache directory, which is probably not what you "
                "want. Consider passing your own cache dir when creating a "
                "TextCorruptor instance. "
            )
        self.base_ds_hash = _hash_text_to_str(list(base_dataset) + [str(dictionary_size)])
        self.cache_dir: Optional[str] = None
        if cache_dir is not None:
            self.cache_dir = os.path.join(cache_dir, self.base_ds_hash)
            if not os.path.exists(self.cache_dir):
                os.makedirs(self.cache_dir)
            elif clear_cache:
                shutil.rmtree(self.cache_dir)
                os.makedirs(self.cache_dir)

        self.common_words = self._extract_common_words(base_dataset, dictionary_size)
        self._word_index = {w: i for i, w in enumerate(self.common_words)}
        self.start_bags = self._word_start_bags()
        self.lev_dist = self._calculate_distances(device)
        self.thesaurus = self.load_bad_translations(thesaurus_path)

    # -- dictionary construction --------------------------------------------

    def _extract_common_words(self, base_dataset: List[str], size: int) -> List[str]:
        """The ``size`` most common words (len>4, non-numeric, containing
        letters), sorted alphabetically; pickle-cached."""
        if self.cache_dir is not None:
            words_file = os.path.join(self.cache_dir, "common-words.pkl")
            if os.path.exists(words_file):
                with open(words_file, "rb") as f:
                    return pickle.load(f)
        words = split_by_whitespace(base_dataset)
        words = [w.lower() for l in words for w in l]
        words = [w for w in words if len(w) > 4]
        words = [w for w in words if not w.isdigit()]
        words = [w for w in words if any(c.isalpha() for c in w)]
        chosen_words = sorted(dict(collections.Counter(words).most_common(size)).keys())
        if self.cache_dir is not None:
            with open(words_file, "wb") as f:
                pickle.dump(chosen_words, f)
        return chosen_words

    def _word_start_bags(self) -> Dict[int, Dict[str, List[str]]]:
        """Bags of same-prefix dictionary words for prefix lengths 3..5."""
        assert self.common_words is not None, "Common words not extracted yet."
        if self.cache_dir is not None:
            bags_file = os.path.join(self.cache_dir, "word-start-bags.pkl")
            if os.path.exists(bags_file):
                with open(bags_file, "rb") as f:
                    return pickle.load(f)
        result: Dict[int, Dict[str, List[str]]] = {}
        for num_start_chars in range(
            MIN_COMMON_START_FOR_AUTOCOMPLETE, MAX_COMMON_START_FOR_AUTOCOMPLETE + 1
        ):
            bag: Dict[str, List[str]] = {}
            for word in self.common_words:
                if len(word) >= num_start_chars:
                    bag.setdefault(word[:num_start_chars], []).append(word)
            result[num_start_chars] = bag
        if self.cache_dir is not None:
            with open(bags_file, "wb") as f:
                pickle.dump(result, f)
        return result

    def _calculate_distances(self, device: DeviceLike = None) -> np.ndarray:
        """Pairwise Levenshtein distances over the dictionary, on ``device``;
        npy-cached."""
        if self.cache_dir is not None:
            distances_file = os.path.join(self.cache_dir, "distances.npy")
            if os.path.exists(distances_file):
                return np.load(distances_file)
        distances = lev_matrix(self.common_words, device)
        if self.cache_dir is not None:
            np.save(os.path.join(self.cache_dir, "distances.npy"), distances)
        return distances

    def load_bad_translations(self, thesaurus_path: Optional[str] = None) -> Dict[str, List[str]]:
        """Load the synonym map from a jsonl thesaurus
        ({"word": ..., "synonyms": [...]} per line). Resolution order:
        explicit ``thesaurus_path`` > ``TIP_DATA_DIR/en_thesaurus.jsonl`` > the
        bundled ``simple_tip_tpu_torch/data/assets/en_thesaurus.jsonl``. Only if
        all are missing does the thesaurus come up empty, in which case
        SYNONYM corruptions degrade to TYPO."""
        candidates = [thesaurus_path] if thesaurus_path else []
        candidates.append(os.path.join(data_folder(), "en_thesaurus.jsonl"))
        candidates.append(
            os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                "data",
                "assets",
                "en_thesaurus.jsonl",
            )
        )
        path = next((p for p in candidates if p and os.path.isfile(p)), None)
        if path is None:
            logger.warning(
                "No thesaurus file found (looked for %s); SYNONYM corruptions "
                "will degrade to TYPO.",
                candidates,
            )
            return {}
        with open(path) as f:
            data = [json.loads(line) for line in f]
        result: Dict[str, set] = {}
        for d in data:
            word, synonyms = d["word"], d["synonyms"]
            if len(synonyms) > 1:
                result.setdefault(word, set()).update(synonyms)
        return {w: list(s) for w, s in result.items()}

    # -- corruption ----------------------------------------------------------

    def corrupt(
        self,
        texts: List[str],
        severity: float,
        seed: int,
        weights: Optional[CorruptionWeights] = None,
        force_recalculate: bool = False,
    ) -> List[str]:
        """Corrupt a list of texts; deterministic per (text, seed, severity),
        order/subset independent, severity-monotonic (higher severity applies
        a superset of the lower-severity corruptions)."""
        assert 0 <= severity <= 1, "Severity must be between 0 and 1."
        cache_file = None
        if self.cache_dir is not None:
            ds_hash = _hash_text_to_str(texts)
            cache_file = os.path.join(
                self.cache_dir, "corrupted", f"{ds_hash}-{severity}-{seed}.pkl"
            )
            if os.path.exists(cache_file) and not force_recalculate:
                with open(cache_file, "rb") as f:
                    return pickle.load(f)
        if weights is None:
            weights = CorruptionWeights()

        def _corrupt_single_text(words: List[str]) -> str:
            new_text = []
            # Seed independent of dataset order/size.
            sentence_seed = _hash_text_to_int(words) + seed
            # Types chosen independently of severity; severity then selects a
            # prefix of a seeded shuffle -> monotonic corruption sets.
            corruption_types = _generate_corruption_types(
                sentence_seed, len(words), weights
            )
            corruption_indexes = np.arange(len(words))
            _get_rng(sentence_seed).shuffle(corruption_indexes)
            corruption_indexes = set(
                corruption_indexes[: round(len(words) * severity)].tolist()
            )
            for i, word in enumerate(words):
                if i not in corruption_indexes or len(word) < 2:
                    new_text.append(word)
                else:
                    new_text.append(
                        self._corrupt_word(word, sentence_seed + i, corruption_types[i])
                    )
            return " ".join(new_text)

        texts_as_words = split_by_whitespace(texts)
        corrupted_texts = [_corrupt_single_text(t) for t in texts_as_words]

        if cache_file is not None:
            os.makedirs(os.path.dirname(cache_file), exist_ok=True)
            with open(cache_file, "wb") as f:
                pickle.dump(corrupted_texts, f)
        return corrupted_texts

    @staticmethod
    def _corrupt_typo(text: str, seed: int) -> str:
        import string as _string

        letter_index = seed % len(text)
        candidate_letters = _string.ascii_lowercase.replace(text[letter_index], "")
        random_candidate_index = _hash_text_to_int([text, str(seed)]) % len(
            candidate_letters
        )
        typo = candidate_letters[random_candidate_index]
        return text[:letter_index] + typo + text[letter_index + 1 :]

    def _corrupt_autocomplete(self, word: str, seed: int) -> str:
        candidates = bad_autocompletes(word, self.start_bags, common_letters=5)
        if candidates is None or len(candidates) == 0:
            return self._corrupt_autocorrect(word, seed)
        random_candidate_index = _hash_text_to_int([word, str(seed)]) % len(candidates)
        return candidates[random_candidate_index]

    def _corrupt_autocorrect(self, word: str, seed: int) -> str:
        if word not in self._word_index:
            return word
        word_index = self._word_index[word]
        candidate_indices = np.argsort(self.lev_dist[word_index])[1:6]
        candidate_distances = 1 / self.lev_dist[word_index][candidate_indices]
        rng = _get_rng(seed)
        chosen_index = rng.choice(
            candidate_indices, p=candidate_distances / candidate_distances.sum()
        )
        return self.common_words[chosen_index]

    def _corrupt_synonym(self, word: str, seed: int) -> str:
        synonyms = self.thesaurus.get(word) or []
        if len(synonyms) == 0:
            return self._corrupt_typo(word, seed)
        method_salt = "_corrupt_synonym"
        random_candidate_index = _hash_text_to_int([word, str(seed), method_salt]) % len(
            synonyms
        )
        return synonyms[random_candidate_index]

    def _corrupt_word(self, w: str, seed: int, corruption_type: CorruptionType) -> str:
        if corruption_type == CorruptionType.TYPO:
            return self._corrupt_typo(w, seed)
        elif corruption_type == CorruptionType.AUTOCOMPLETE:
            return self._corrupt_autocomplete(w, seed)
        elif corruption_type == CorruptionType.AUTOCORRECT:
            return self._corrupt_autocorrect(w, seed)
        elif corruption_type == CorruptionType.SYNONYM:
            return self._corrupt_synonym(w, seed)
        else:
            raise ValueError(f"Unknown corruption type: {corruption_type}")
