"""The port's KDE and its four other SA variants (LSA, MDSA, MLSA and the
multimodal wrapper, by class and by k-means) against the JAX package's on
the CPU, from the same seeded inputs, with its cluster backend pinned to
``jax`` (its estimators and device scoring paths, as on an accelerator).

Tolerances: KDE log densities and LSA scores with equal +inf masks and the
finite values within rtol 1e-4; MDSA and MLSA scores within rtol 1e-4; the
same removed features, chosen k and modal ids; MDSA's pseudo-inverse
(a float64 ``eigh`` on the device) against ``scipy.linalg.pinvh`` within
float32 rounding (rtol 1e-5).
"""

import warnings

import numpy as np
import pytest
import scipy.linalg
import torch

from simple_tip_tpu.ops import kde as jax_kde
from simple_tip_tpu.ops import surprise as jax_surprise
from simple_tip_tpu_torch.engine.sa_prep import SharedTrainPrep, VariantFitter
from simple_tip_tpu_torch.ops import kde, surprise
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _jax_backend(monkeypatch):
    monkeypatch.setenv("TIP_CLUSTER_BACKEND", "jax")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def traces(seed: int, rows: int, dims: int, classes: int = 3):
    """Seeded class-shifted traces (float32) and their classes."""
    rng = np.random.default_rng(seed)
    labels = np.arange(rows) % classes
    x = rng.normal(0, 1, (rows, dims)) * rng.uniform(0.2, 2.0, dims) + labels[:, None]
    return x.astype(np.float32), labels.astype(np.int64)


def assert_scores_match(got, want, rtol=1e-4):
    assert got.dtype == want.dtype == np.float64 and got.shape == want.shape
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=0)


def test_kde_log_densities_match_jax_with_the_same_underflow():
    x, _ = traces(0, 240, 6)
    points = np.concatenate([x[::5] + 0.1, x[:10] * 30.0])  # the last ten underflow
    want = jax_kde.StableGaussianKDE(x.T)
    got = kde.StableGaussianKDE(x.T, device="cpu")
    assert got.factor == want.factor and got.log_det == want.log_det
    with np.errstate(divide="ignore"):
        lw, lg = -np.log(want.evaluate(points.T)), -np.log(got.evaluate(points.T))
    assert np.isinf(lw[-10:]).all() and np.isfinite(lw[:-10]).all()
    assert_scores_match(lg, lw)


def test_kde_fails_silently_like_jax():
    x, _ = traces(1, 30, 4)
    x[:, 2] = 1.5  # a constant feature: the stabilisation gives up
    want = jax_kde.StableGaussianKDE(x.T)
    got = kde.StableGaussianKDE(x.T, device="cpu")
    assert got.prepare_failed and want.prepare_failed
    assert np.array_equal(got.evaluate(x.T), want.evaluate(x.T))


def test_lsa_prunes_to_the_same_features():
    x, _ = traces(2, 200, 40)
    want = jax_surprise.LSA(x, max_features=12)
    got = surprise.LSA(x, max_features=12, device="cpu")
    assert got.removed_neurons == want.removed_neurons and len(got.removed_neurons) == 28
    q, _ = traces(3, 60, 40)
    assert_scores_match(got(q), want(q))


def test_lsa_scores_are_minus_the_log_of_its_log_density():
    x, _ = traces(2, 200, 40)
    q, _ = traces(3, 60, 40)
    q[:10] *= 30.0  # their densities underflow
    lsa = surprise.LSA(x, max_features=12, device="cpu")
    log_density = lsa.log_density(q)
    assert log_density.dtype == torch.float32 and torch.isfinite(log_density).all()
    scores = lsa(q)
    assert np.isinf(scores[:10]).all() and np.isfinite(scores[10:]).all()
    with np.errstate(divide="ignore"):
        want = -np.log(torch.exp(log_density).numpy().astype(np.float64))
    assert scores.tobytes() == want.tobytes()


class _SingularOnce:
    """A KDE class that raises ``error`` for feature ``dim`` of the first
    dataset it is given, then fits as ``cls`` does."""

    def __init__(self, cls, error, dim):
        self.cls, self.error, self.dim, self.calls = cls, error, dim, 0

    def __call__(self, dataset, **kwargs):
        self.calls += 1
        if self.calls == 1:
            raise self.error("leading minor", self.dim)
        return self.cls(dataset, **kwargs)


def test_lsa_drops_the_same_feature_on_a_singular_kde(monkeypatch):
    x, _ = traces(4, 200, 40)
    monkeypatch.setattr(jax_surprise, "StableGaussianKDE",
                        _SingularOnce(jax_kde.StableGaussianKDE, jax_kde.KDESingularError, 5))
    monkeypatch.setattr(surprise, "StableGaussianKDE",
                        _SingularOnce(kde.StableGaussianKDE, kde.KDESingularError, 5))
    want = jax_surprise.LSA(x, max_features=12)
    got = surprise.LSA(x, max_features=12, device="cpu")
    assert got.removed_neurons == want.removed_neurons and len(got.removed_neurons) == 29
    q, _ = traces(5, 40, 40)
    assert_scores_match(got(q), want(q))


def test_lsa_with_every_feature_dropped_scores_zero(monkeypatch):
    x, _ = traces(6, 50, 1)
    monkeypatch.setattr(jax_surprise, "StableGaussianKDE",
                        _SingularOnce(jax_kde.StableGaussianKDE, jax_kde.KDESingularError, 0))
    monkeypatch.setattr(surprise, "StableGaussianKDE",
                        _SingularOnce(kde.StableGaussianKDE, kde.KDESingularError, 0))
    got = surprise.LSA(x, device="cpu")
    want = jax_surprise.LSA(x)
    assert got.kde is None and want.kde is None and got.removed_neurons == [0]
    assert np.array_equal(got(x), want(x)) and not got(x).any()


def _covariance(kind: str) -> np.ndarray:
    x, _ = traces(17, 200 if kind != "rank-deficient" else 8, 12)
    if kind == "rank-deficient":
        x[:, 3] = 0.0  # a dead feature, and fewer rows than features
    c = x - x.mean(axis=0)
    return (c.T @ c).astype(np.float64) / x.shape[0] if kind != "zero" else np.zeros((12, 12))


@pytest.mark.parametrize("kind", ["full-rank", "rank-deficient", "zero"])
def test_pinvh_on_the_device_matches_scipy(kind):
    a = _covariance(kind)
    want = scipy.linalg.pinvh(a).astype(np.float32)
    got = surprise.pinvh(a, torch.device("cpu")).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max(initial=0))


def test_mdsa_matches_jax():
    x, _ = traces(7, 300, 12)
    q, _ = traces(8, 50, 12)
    assert_scores_match(surprise.MDSA(x, device="cpu")(q), jax_surprise.MDSA(x)(q))


@pytest.mark.parametrize("rows", [150, 2, 1], ids=["fit", "clamped", "duplicated"])
def test_mlsa_matches_jax(rows):
    x, _ = traces(9, 150, 5)
    x = x[:rows]
    q, _ = traces(10, 30, 5)
    want = jax_surprise.MLSA(x, num_components=3)
    got = surprise.MLSA(x, num_components=3, device="cpu")
    assert got.gmm.n_components == want.gmm.n_components
    assert got.gmm.reg_covar == want.gmm.reg_covar
    assert_scores_match(got(q), want(q))


MODALS = {
    "pc-lsa": (lambda a, _: jax_surprise.LSA(a), lambda a: surprise.LSA(a, device="cpu")),
    "pc-mdsa": (lambda a, _: jax_surprise.MDSA(a), lambda a: surprise.MDSA(a, device="cpu")),
    "pc-mlsa": (lambda a, _: jax_surprise.MLSA(a, num_components=3),
                lambda a: surprise.MLSA(a, num_components=3, device="cpu")),
}


def by_class(x, y, modal):
    """The registry's per-class build: ``VariantFitter.by_class`` over the
    shared by-class partition of ``x``."""
    cpu = torch.device("cpu")
    return VariantFitter(SharedTrainPrep(torch.from_numpy(x), y, cpu), cpu).by_class(modal)


@pytest.mark.parametrize("name", sorted(MODALS))
def test_multimodal_by_class_matches_jax(name):
    x, y = traces(11, 360, 6)
    q, qy = traces(12, 60, 6)
    want_ctor, got_ctor = MODALS[name]
    want = jax_surprise.MultiModalSA.build_by_class(x, y, want_ctor)
    got = by_class(x, y, got_ctor)
    assert sorted(got.modal_sa) == sorted(want.modal_sa) == [0, 1, 2]
    assert_scores_match(got(q, qy), want(q, qy))


def test_multimodal_by_kmeans_matches_jax():
    x, y = traces(13, 400, 6, classes=4)
    x += 4.0 * y[:, None]  # four separated clusters
    q, qy = traces(14, 80, 6, classes=4)
    q += 4.0 * qy[:, None]
    want = jax_surprise.MultiModalSA.build_with_kmeans(
        x, y, lambda a, _: jax_surprise.MDSA(a), potential_k=range(2, 6), subsampling=0.3)
    got = surprise.MultiModalSA.build_with_kmeans(
        x, y, lambda a, _: surprise.MDSA(a, device="cpu"), potential_k=range(2, 6),
        subsampling=0.3, device="cpu")
    assert got.discriminator.best_k == want.discriminator.best_k == 4
    assert sorted(got.modal_sa) == sorted(want.modal_sa)
    assert_scores_match(got(q, qy), want(q, qy))


def test_multimodal_raises_on_a_modal_with_no_sa():
    x, y = traces(15, 90, 4)
    sa = by_class(x, y, lambda a: surprise.MDSA(a, device="cpu"))
    del sa.modal_sa[2]
    with pytest.raises(ValueError, match="No modal found for modal id 2"):
        sa(x, y)


@pytest.mark.parametrize("cls", [surprise.MDSA, surprise.LSA, surprise.MLSA])
def test_sa_variants_default_to_the_card(cls):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    x, _ = traces(16, 30, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(x)
