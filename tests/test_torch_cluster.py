"""The port's k-means, silhouette and Gaussian mixture (``ops/cluster.py``)
against the JAX package's estimators on the CPU, from the same seeded
inputs, with its cluster backend pinned to ``jax`` (its estimators, as on an
accelerator; ``auto`` would pick sklearn on a CPU host).

Tolerances: k-means labels byte-equal, centroids and inertia within rtol
1e-5; silhouettes within 1e-5 and the same chosen k (an exact tie going to
the smaller k); mixture weights, means, covariances and log-likelihoods
within rtol 1e-4 (atol 1e-6 for covariance entries near 0);
MLSA's ``reg_covar`` rung the same, its scores within rtol 1e-4 (2e-3 on
the duplicated features, whose covariance keeps a condition number near 1e6
after the 1e-2 ridge: float32 solves are good to about that).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_tip_tpu.ops import cluster as jax_cluster
from simple_tip_tpu.ops import surprise as jax_surprise
from simple_tip_tpu_torch.ops import cluster
from simple_tip_tpu_torch.ops import surprise
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _jax_backend(monkeypatch):
    monkeypatch.setenv("TIP_CLUSTER_BACKEND", "jax")


def blobs(seed: int, rows: int = 100, dims: int = 8, centres=(0.0, 3.0, 6.0), scale=1.0):
    """Seeded Gaussian blobs, ``rows`` each, float32."""
    rng = np.random.default_rng(seed)
    return np.concatenate(
        [rng.normal(c, scale, (rows, dims)) for c in centres]
    ).astype(np.float32)


@pytest.mark.parametrize("k", [2, 3, 5])
def test_kmeans_matches_jax(k):
    x = blobs(k, dims=16)
    want = jax_cluster.KMeans(k, random_state=0).fit(x)
    got = cluster.KMeans(k, random_state=0, device="cpu")
    got.fit_predict(x)
    assert got.labels_.tobytes() == np.asarray(want.labels_).astype(got.labels_.dtype).tobytes()
    np.testing.assert_allclose(got.cluster_centers_, want.cluster_centers_, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.inertia_, want.inertia_, rtol=1e-5)
    query = blobs(10 + k, rows=20, dims=16)
    assert np.array_equal(got.predict(query), want.predict(query))


def test_kmeans_plus_plus_draws_the_jax_centroids():
    x = blobs(1, dims=16)
    for k in (2, 5):
        want = jax_cluster._kmeans_plus_plus(np.random.RandomState(3), x, k)
        got = cluster._kmeans_plus_plus(np.random.RandomState(3), x, k)
        assert got.tobytes() == want.tobytes()


def test_silhouettes_match_jax_and_pick_the_same_k():
    x = blobs(4, dims=12)
    labelings = [jax_cluster.KMeans(k, random_state=0).fit_predict(x) for k in (2, 3, 4, 5)]
    want = jax_cluster.silhouette_scores_multi(x, labelings, chunk=128)
    got = cluster.silhouette_scores_multi(x, labelings, chunk=128, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert int(np.argmax(got)) == int(np.argmax(want)) == 1
    # a singleton cluster scores 0
    single = np.zeros(x.shape[0], dtype=np.int64)
    single[0], single[1:150] = 1, 2
    np.testing.assert_allclose(
        cluster.silhouette_scores_multi(x, [single], device="cpu"),
        jax_cluster.silhouette_scores_multi(x, [single]), rtol=0, atol=1e-5)


def test_kmeans_discriminator_picks_the_same_k_and_clusters():
    x = blobs(5, rows=80, dims=10, centres=(0.0, 4.0, 8.0, 12.0))
    want = jax_surprise._KmeansDiscriminator(x, range(2, 6), subsampling=0.3)
    got = surprise._KmeansDiscriminator(x, range(2, 6), subsampling=0.3, device="cpu")
    assert got.best_k == want.best_k == 4
    np.testing.assert_allclose(got.best_score, want.best_score, rtol=0, atol=1e-5)
    assert np.array_equal(got(x, None), want(x, None))


def test_an_exact_silhouette_tie_goes_to_the_smaller_k(monkeypatch):
    x = blobs(6, rows=40, dims=6)
    scores = lambda x, labelings, **_: [0.5, 0.25, 0.5, 0.5]  # noqa: E731
    monkeypatch.setattr(jax_cluster, "silhouette_scores_multi", scores)
    monkeypatch.setattr(surprise, "silhouette_scores_multi", scores)
    want = jax_surprise._KmeansDiscriminator(x, range(2, 6))
    got = surprise._KmeansDiscriminator(x, range(2, 6), device="cpu")
    assert got.best_k == want.best_k == 2


@pytest.mark.parametrize("seed", [0, 1])
def test_gaussian_mixture_matches_jax(seed):
    x = blobs(seed, rows=120, dims=6, centres=(0.0, 5.0, 10.0))
    want = jax_cluster.GaussianMixture(3, random_state=cluster.GMM_SEED).fit(x)
    got = cluster.GaussianMixture(3, device="cpu").fit(x)
    np.testing.assert_allclose(got.weights_, want.weights_, rtol=1e-4)
    np.testing.assert_allclose(got.means_, want.means_, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.covariances_, want.covariances_, rtol=1e-4, atol=1e-6)
    query = np.concatenate([x[::9], x[::9] + 0.7])
    np.testing.assert_allclose(got.score_samples(query), want.score_samples(query), rtol=1e-4)


def test_failed_cholesky_is_nan_like_jax():
    bad = np.array([[[1.0, 2.0], [2.0, 1.0]], [[4.0, 2.0], [2.0, 3.0]]], np.float32)
    got = cluster._cholesky_or_nan(torch.from_numpy(bad)).numpy()
    want = np.asarray(jnp.linalg.cholesky(jnp.asarray(bad)))
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)


def _modal(kind: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    base = rng.normal(0, 100.0, (60, 4))
    if kind == "collapsed":  # a constant feature
        extra = np.full((60, 2), 7.0)
    else:  # two duplicated features at a scale where float32 loses 1e-6
        extra = base[:, :2]
    return np.concatenate([base, extra], axis=1).astype(np.float32)


@pytest.mark.parametrize(
    "kind,rung,rtol", [("collapsed", 1e-6, 1e-4), ("duplicated", 1e-2, 2e-3)]
)
def test_mlsa_picks_the_same_reg_covar_rung_as_jax(kind, rung, rtol):
    x = _modal(kind)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_surprise.MLSA(x, num_components=3)
        got = surprise.MLSA(x, num_components=3, device="cpu")
    assert got.gmm.reg_covar == want.gmm.reg_covar == rung
    np.testing.assert_allclose(got(x), want(x), rtol=rtol)


def test_mlsa_raises_like_jax_when_every_rung_fails():
    x = _modal("duplicated") * np.float32(10.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(ValueError):
            jax_surprise.MLSA(x, num_components=3)
        with pytest.raises(ValueError):
            surprise.MLSA(x, num_components=3, device="cpu")


@pytest.mark.parametrize(
    "make",
    [
        lambda: cluster.KMeans(2),
        lambda: cluster.GaussianMixture(2),
        lambda: cluster.silhouette_scores_multi(np.zeros((4, 2)), [np.array([0, 0, 1, 1])]),
    ],
    ids=["kmeans", "gmm", "silhouette"],
)
def test_cluster_entry_points_default_to_the_card(make):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
