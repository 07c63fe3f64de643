"""The port's text side against the JAX package's, on the CPU:
``ops/levenshtein.lev_matrix`` byte-equal to the JAX package's host kernel
(ASCII, non-ASCII and words over 255 bytes, where both clip); the
``TextCorruptor``'s dictionary, prefix bags, distances and thesaurus equal,
its corruptions string-equal over several severities and seeds, and each
package reading the other's cache directory; the tokenizer,
``pad_sequences`` and ``build_imdb_caches`` byte-equal. The corpus is
``data/synthetic.english_like_texts`` over the bundled thesaurus's words;
every cache directory is a ``tmp_path``."""

import json
import os

import numpy as np
import pytest

from simple_tip_tpu.data import imdb_prep as jax_prep
from simple_tip_tpu.ops import text_corruptor as jax_tc
from simple_tip_tpu.ops.native import lev_matrix as jax_lev_matrix
from simple_tip_tpu_torch.data import imdb_prep, synthetic
from simple_tip_tpu_torch.ops import text_corruptor as tc
from simple_tip_tpu_torch.ops.levenshtein import lev_matrix, levenshtein
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ASSET = os.path.join(os.path.dirname(tc.__file__), "..", "data", "assets", "en_thesaurus.jsonl")
DICTIONARY = 300


@pytest.fixture(scope="module")
def corpus():
    with open(ASSET) as f:
        words = [json.loads(line)["word"] for line in f]
    texts, labels = synthetic.english_like_texts(7, 160, vocabulary=900, words_per_text=(20, 60),
                                                 base_words=words)
    return texts, labels


@pytest.fixture(autouse=True)
def _no_user_thesaurus(tmp_path, monkeypatch):
    monkeypatch.setenv("TIP_DATA_DIR", str(tmp_path / "no_datasets"))


def _words(seed, n, alphabet, lengths):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(alphabet, size=rng.integers(*lengths))) for _ in range(n)]


@pytest.mark.parametrize("words", [
    _words(0, 80, list("abcde"), (0, 9)),
    _words(1, 60, list("aéßx漢字"), (1, 7)),
    ["x" * 300, "y" * 280 + "x" * 5, "x" * 256, "", "abc", "é" * 130],
], ids=["ascii", "utf8", "over_255_bytes"])
def test_lev_matrix_equals_the_host_kernel(words):
    got = lev_matrix(words, "cpu")
    want = jax_lev_matrix(words)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_lev_matrix_in_blocks(monkeypatch):
    words = _words(2, 50, list("abcdef"), (1, 12))
    monkeypatch.setattr("simple_tip_tpu_torch.ops.levenshtein.CPU_PAIRS_PER_BLOCK", 7 * 50)
    assert lev_matrix(words, "cpu").tobytes() == jax_lev_matrix(words).tobytes()


def test_single_pair_counts_bytes():
    assert levenshtein("kitten", "sitting") == 3
    assert levenshtein("é", "e") == 2  # two UTF-8 bytes against one
    assert levenshtein("", "abc") == 3


@pytest.fixture(scope="module")
def both_corruptors(corpus, tmp_path_factory):
    texts, _ = corpus
    root = tmp_path_factory.mktemp("corruptors")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TIP_DATA_DIR", str(root / "no_datasets"))
        port = tc.TextCorruptor(texts, cache_dir=str(root / "port"), dictionary_size=DICTIONARY,
                                device="cpu")
        ref = jax_tc.TextCorruptor(texts, cache_dir=str(root / "jax"), dictionary_size=DICTIONARY)
    return port, ref, root


def test_dictionary_bags_distances_and_thesaurus_equal(both_corruptors):
    port, ref, _ = both_corruptors
    assert port.common_words == ref.common_words
    assert len(port.common_words) == DICTIONARY
    assert port.start_bags == ref.start_bags
    assert port.lev_dist.dtype == np.uint8
    assert port.lev_dist.tobytes() == ref.lev_dist.tobytes()
    assert port.thesaurus == ref.thesaurus and len(port.thesaurus) > 100
    assert port.base_ds_hash == ref.base_ds_hash


@pytest.mark.parametrize("severity", [0.0, 0.1, 0.5, 1.0])
@pytest.mark.parametrize("seed", [0, 3])
def test_corrupt_is_string_equal(both_corruptors, corpus, severity, seed):
    port, ref, _ = both_corruptors
    texts = corpus[0][:40]
    got = port.corrupt(texts, severity=severity, seed=seed, force_recalculate=True)
    want = ref.corrupt(texts, severity=severity, seed=seed, force_recalculate=True)
    assert got == want
    if severity >= 0.5:
        assert sum(g != t for g, t in zip(got, texts)) > 30


def test_each_package_reads_the_other_cache(corpus, tmp_path):
    texts = corpus[0]
    cache = str(tmp_path / "shared")
    ref = jax_tc.TextCorruptor(texts, cache_dir=cache, dictionary_size=DICTIONARY)
    want = ref.corrupt(texts[:10], severity=0.5, seed=1)
    folder = os.path.join(cache, ref.base_ds_hash)
    names = sorted(os.listdir(folder))
    assert names == ["common-words.pkl", "corrupted", "distances.npy", "word-start-bags.pkl"]
    # a distances cache the port must read, not recompute
    marker = np.load(os.path.join(folder, "distances.npy"))
    marker[0, 1] = marker[1, 0] = 77
    np.save(os.path.join(folder, "distances.npy"), marker)
    port = tc.TextCorruptor(texts, cache_dir=cache, dictionary_size=DICTIONARY, device="cpu")
    assert port.lev_dist[0, 1] == 77
    assert port.corrupt(texts[:10], severity=0.5, seed=1) == want
    # and the reverse: the port's fresh cache read by the JAX package
    cache2 = str(tmp_path / "port_first")
    port2 = tc.TextCorruptor(texts, cache_dir=cache2, dictionary_size=DICTIONARY, device="cpu")
    got = port2.corrupt(texts[:10], severity=0.5, seed=1)
    ref2 = jax_tc.TextCorruptor(texts, cache_dir=cache2, dictionary_size=DICTIONARY)
    assert ref2.lev_dist.tobytes() == port2.lev_dist.tobytes()
    assert ref2.corrupt(texts[:10], severity=0.5, seed=1) == got


def test_thesaurus_lookup_order(tmp_path, monkeypatch, corpus):
    data = tmp_path / "data"
    data.mkdir()
    monkeypatch.setenv("TIP_DATA_DIR", str(data))
    with open(data / "en_thesaurus.jsonl", "w") as f:
        f.write(json.dumps({"word": "zzword", "synonyms": ["a", "b"]}) + "\n")
    explicit = tmp_path / "explicit.jsonl"
    with open(explicit, "w") as f:
        f.write(json.dumps({"word": "yyword", "synonyms": ["c", "d"]}) + "\n")
    port = tc.TextCorruptor(corpus[0][:20], cache_dir=None, dictionary_size=50, device="cpu")
    assert set(port.thesaurus) == {"zzword"}
    assert set(port.load_bad_translations(str(explicit))) == {"yyword"}
    os.remove(data / "en_thesaurus.jsonl")
    assert port.load_bad_translations() == jax_tc.TextCorruptor.load_bad_translations(port)


def test_split_and_autocompletes_equal(both_corruptors, corpus):
    port, ref, _ = both_corruptors
    texts = corpus[0][:20]
    assert tc.split_by_whitespace(texts) == jax_tc.split_by_whitespace(texts)
    for word in port.common_words[:60]:
        for letters in (3, 4, 5):
            assert (tc.bad_autocompletes(word, port.start_bags, letters)
                    == jax_tc.bad_autocompletes(word, ref.start_bags, letters))
    assert [t.value for t in tc.CorruptionType] == [t.value for t in jax_tc.CorruptionType]


def test_tokenizer_and_padding_equal(corpus):
    texts = corpus[0]
    port = imdb_prep.KerasLikeTokenizer(num_words=500)
    ref = jax_prep.KerasLikeTokenizer(num_words=500)
    port.fit_on_texts(texts[:100])
    ref.fit_on_texts(texts[:100])
    assert port.word_index == ref.word_index
    seqs = port.texts_to_sequences(texts[100:])
    assert seqs == ref.texts_to_sequences(texts[100:])
    for maxlen in (10, 100):
        got = imdb_prep.pad_sequences(seqs + [[]], maxlen)
        want = jax_prep.pad_sequences(seqs + [[]], maxlen)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_build_imdb_caches_equal(corpus, tmp_path):
    texts, labels = corpus
    args = (texts[:100], labels[:100], texts[100:], labels[100:])
    imdb_prep.build_imdb_caches(*args, str(tmp_path / "port"), vocab_size=400, maxlen=50,
                                device="cpu")
    jax_prep.build_imdb_caches(*args, str(tmp_path / "jax"), vocab_size=400, maxlen=50)
    for name in ("x_train", "y_train", "x_test", "y_test", "x_corrupted"):
        got = np.load(tmp_path / "port" / f"{name}.npy")
        want = np.load(tmp_path / "jax" / f"{name}.npy")
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert got.tobytes() == want.tobytes(), name
    assert not np.array_equal(np.load(tmp_path / "port" / "x_corrupted.npy"),
                              np.load(tmp_path / "port" / "x_test.npy"))
