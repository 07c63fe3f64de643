"""Distance-based surprise adequacy (DSA) and surprise-coverage profiles.

Counterpart of ``DSA`` and ``SurpriseCoverageMapper`` of the JAX package's
``ops/surprise.py``: DSA is the distance of a test activation trace to its
nearest same-class training trace, over the distance from that training
trace to its nearest other-class training trace (classes by the TEST
sample's predicted label in both). Both nearest-neighbour searches go
through ``ops/dsa_cuda.masked_nearest``: the CUDA kernel on the card (over
the class-sorted layout of the training rows, built once per ``DSA``, and
one query plan per score call for its two searches), the chunked plain
formulation on the CPU. The training subsample is the same
seeded numpy draw as the JAX package's, so the same rows are kept.

The four other variants:

- ``LSA``: -log of a KDE density (``ops/kde.py``) over the training traces,
  with the features pruned to the ``max_features`` of highest variance and a
  feature dropped, and the KDE refitted, whenever its Cholesky fails;
- ``MDSA``: the squared Mahalanobis distance to the training traces (float32
  mean and covariance on the host, the float64 pseudo-inverse and the
  quadratic form on the device);
- ``MLSA``: the negative log-likelihood under a Gaussian mixture
  (``ops/cluster.py``), refitted with a larger ``reg_covar`` (1e-6, 1e-4,
  1e-2) while the fit fails;
- ``MultiModalSA``: one SA per modal, the modals given by the predicted
  class or by silhouette-scored k-means (``_KmeansDiscriminator``); a row of
  a modal with no SA raises ``ValueError``.

Their fits keep what is delicate on the host, as the JAX package does
(variance pruning, the KDE's float64 covariance and Cholesky, MDSA's
covariance, k-means++ draws), and run the iterative fits, MDSA's float64
pseudo-inverse and the scoring on the device.
"""

import warnings
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from simple_tip_tpu_torch.device import DeviceLike, resolve
from simple_tip_tpu_torch.ops.cluster import GaussianMixture, KMeans, silhouette_scores_multi
from simple_tip_tpu_torch.ops.dsa_cuda import (
    QueryPlan, class_layout, masked_nearest, plan_queries, worth_planning,
)
from simple_tip_tpu_torch.ops.kde import KDESingularError, StableGaussianKDE

Activations = Union[Sequence[torch.Tensor], torch.Tensor, np.ndarray]

# pc-mmdsa's k-means, as the JAX package's registry runs it: restarts per
# candidate k, their seed, and the seed of the training subsample
KMEANS_N_INIT = 10
KMEANS_SEED = 0
SUBSAMPLING_SEED = 0


def _resolve_subsample_count(subsampling, population: int) -> Optional[int]:
    """How many samples a ``subsampling`` spec keeps (None: all). A float in
    (0, 1) is a share, a positive int an absolute cap."""
    if subsampling is None or subsampling == 1.0:
        return None
    if isinstance(subsampling, int) and subsampling > 0:
        return min(subsampling, population)
    if 0 < subsampling < 1:
        return int(subsampling * population)
    raise ValueError(
        "subsampling must be a float between 0 and 1 (share of training "
        "data), or a positive int declaring the number of samples"
    )


def subsample_indices(subsampling, population: int, seed: int) -> Optional[np.ndarray]:
    """The JAX package's seeded draw (``_subsample_arrays``), or None for all."""
    keep = _resolve_subsample_count(subsampling, population)
    if keep is None:
        return None
    return np.random.RandomState(seed).choice(population, keep, replace=False)


def _class_predictions(predictions) -> np.ndarray:
    """Validate and convert class predictions to a 1-D int64 array."""
    if isinstance(predictions, torch.Tensor):
        predictions = predictions.cpu().numpy()
    predictions = np.asarray(predictions)
    if predictions.ndim != 1:
        raise ValueError(
            "Class predictions must be one-dimensional. If your predictions "
            "are one_hot encoded, use eg `np.argmax(softmax_outputs, axis=1)`"
        )
    if not np.issubdtype(predictions.dtype, np.integer):
        truncated = predictions.astype(np.int64)
        if float(np.abs(predictions - truncated).max(initial=0.0)) >= 1.5e-5:
            raise ValueError("Predictions must be integers")
        predictions = truncated
    if predictions.size and int(predictions.min()) < 0:
        raise ValueError("Class predictions must be >= 0")
    return predictions.astype(np.int64)


def _flatten_layers(layers: Activations) -> torch.Tensor:
    """Per-layer activations (or one high-rank tensor) as (samples, neurons)."""
    if isinstance(layers, torch.Tensor):
        return layers.reshape(layers.shape[0], -1)
    return torch.cat([layer.reshape(layer.shape[0], -1) for layer in layers], dim=1)


def _as_rows(activations: Activations, device: Optional[torch.device] = None) -> torch.Tensor:
    """Activations (tensors or host arrays, one or per layer) as float32
    (samples, neurons) rows, on ``device`` where given."""
    if isinstance(activations, np.ndarray):
        activations = torch.from_numpy(np.ascontiguousarray(activations))
    elif not isinstance(activations, torch.Tensor):
        activations = [torch.as_tensor(np.asarray(a)) if isinstance(a, np.ndarray) else a
                       for a in activations]
    rows = _flatten_layers(activations).float()
    return rows if device is None else rows.to(device)


class SurpriseCoverageMapper:
    """SA values -> boolean bucket profiles (host numpy, float64 edges)."""

    def __init__(self, sections: int, upper_bound: float):
        self.sections = sections
        self.thresholds = np.linspace(
            start=0, stop=upper_bound, num=sections + 1, dtype=np.float64
        )

    def get_coverage_profile(self, surprise_values: np.ndarray) -> np.ndarray:
        """Map SA values to (samples, sections) boolean bucket membership."""
        surprise_values = np.asarray(surprise_values)
        res = np.zeros(shape=(surprise_values.shape[0], self.sections), dtype=bool)
        for i in range(self.sections):
            res[..., i] = np.logical_and(
                self.thresholds[i] <= surprise_values,
                surprise_values < self.thresholds[i + 1],
            )
        return res


class DSA:
    """Distance-based surprise adequacy over training traces on one device.

    ``activations`` are the training traces (tensors on the scoring device),
    ``predictions`` their predicted classes. ``badge_size`` (None: all at
    once) scores the test traces in chunks of that many rows; every row's
    score is computed on its own, so the chunking never changes a score.

    The searches run on ``rows``, the kept training traces centred on their
    mean ``mean``, with queries centred alike (``traces``). Distances do
    not change under a common shift, but the searches expand
    d^2 = |x|^2 + |t|^2 - 2 x.t in float32, which cancels badly when the
    traces lie far from the origin relative to their spread: on seeded IMDB
    traces (norm ~2.4, nearest distances down to 0.05) the uncentred
    expansion is off the float64 DSA by up to 1.3e-4 relative, the centred
    one by 1.1e-6. Centring cannot help where the classes themselves lie
    far apart, as in a trained model's traces (MNIST tap 3 after one epoch:
    centred norm ~22, nearest distances ~1.4, expansion off by up to 1.2e-4
    relative), so the searches only pick the nearest rows and both
    distances are then recomputed as |x - t|. The JAX package expands
    uncentred and keeps the expanded distances.
    """

    def __init__(
        self,
        activations: Activations,
        predictions,
        subsampling=1.0,
        subsampling_seed: int = 0,
        badge_size: Optional[int] = None,
    ):
        train = _flatten_layers(activations).float()
        labels = _class_predictions(predictions)
        chosen = subsample_indices(subsampling, train.shape[0], subsampling_seed)
        if chosen is not None:
            train = train[torch.as_tensor(chosen, device=train.device)]
            labels = labels[chosen]
        self.mean = train.double().mean(dim=0).float()
        self.rows = (train - self.mean).contiguous()
        self.rows_sq = (self.rows * self.rows).sum(dim=1)
        self.train_labels = torch.as_tensor(labels, dtype=torch.int32, device=train.device)
        # the kernel's class-sorted copy of the rows (the CPU's plain search needs none)
        self.layout = (class_layout(self.rows, self.rows_sq, self.train_labels)
                       if self.rows.is_cuda else None)
        self.badge_size = badge_size

    def nearest(self, x: torch.Tensor, labels: torch.Tensor, want_same: bool,
                queries=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(min d2, argmin) of centred queries ``x`` against the class-masked
        centred training rows (``queries``: their ``query_plan``)."""
        return masked_nearest(x, labels, self.rows, self.rows_sq, self.train_labels, want_same,
                              self.layout, queries)

    def query_plan(self, host_labels: np.ndarray) -> Optional[QueryPlan]:
        """The ``plan_queries`` that both searches of a score call of queries
        with these labels share, or None (the kernel walks every tile): on the
        CPU, and where the searches are too small to repay a plan."""
        if self.layout is None or not worth_planning(len(host_labels), *self.rows.shape):
            return None
        return plan_queries(host_labels, self.layout, self.rows.device)

    def _distance(self, x: torch.Tensor, d2: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """The distance from ``x`` to its nearest row ``idx``, recomputed as
        |x - t| (no cancellation), or inf where the search found no row."""
        exact = (x - self.rows.index_select(0, idx.long())).square().sum(dim=1).sqrt()
        return torch.where(torch.isinf(d2), d2, exact)

    def _score(self, x: torch.Tensor, labels: torch.Tensor, host_labels: np.ndarray) -> torch.Tensor:
        queries = self.query_plan(host_labels)
        a2, a_idx = self.nearest(x, labels, True, queries)
        closest = self.rows.index_select(0, a_idx.long())
        b2, b_idx = self.nearest(closest, labels, False, queries)
        return self._distance(x, a2, a_idx) / self._distance(closest, b2, b_idx)

    def traces(self, activations: Activations) -> torch.Tensor:
        """Test activations as centred float32 rows (the searches' queries)."""
        return (_flatten_layers(activations).float() - self.mean).contiguous()

    def __call__(self, activations: Activations, predictions) -> np.ndarray:
        """DSA of each test trace (float64, like the JAX package's)."""
        x = self.traces(activations)
        host_labels = _class_predictions(predictions)
        labels = torch.as_tensor(host_labels, dtype=torch.int32, device=x.device)
        chunk = self.badge_size or max(1, x.shape[0])
        parts = [
            self._score(x[start : start + chunk], labels[start : start + chunk],
                        host_labels[start : start + chunk])
            for start in range(0, x.shape[0], chunk)
        ]
        dsa = torch.cat(parts) if parts else x.new_zeros(0)
        return dsa.cpu().numpy().astype(np.float64)


def _by_class_discriminator(activations: Activations, predictions) -> np.ndarray:
    """Discriminator assigning each sample to its predicted class."""
    return _class_predictions(predictions)


class _KmeansDiscriminator:
    """Silhouette-scored k-means over the candidate ``potential_k``: every
    candidate is fitted, then one silhouette pass scores them all; the
    highest score wins, a tie going to the smaller k (strict ``>``)."""

    def __init__(
        self,
        training_data: Activations,
        potential_k: Iterable[int],
        subsampling=1.0,
        device: DeviceLike = None,
    ):
        self.device = resolve(device)
        rows = _as_rows(training_data, self.device)
        chosen = subsample_indices(subsampling, rows.shape[0], SUBSAMPLING_SEED)
        if chosen is not None:
            rows = rows[torch.as_tensor(chosen, device=self.device)]
        fitted = []
        for k in potential_k:
            kmeans = KMeans(k, n_init=KMEANS_N_INIT, random_state=KMEANS_SEED, device=self.device)
            fitted.append((k, kmeans, kmeans.fit_predict(rows)))
        scores = silhouette_scores_multi(rows, [labels for _, _, labels in fitted],
                                         device=self.device)
        self.best_score = -np.inf
        self.best_k = None
        self.best_clusterer = None
        for (k, kmeans, _), silhouette_avg in zip(fitted, scores):
            if silhouette_avg > self.best_score:
                self.best_score = silhouette_avg
                self.best_k = k
                self.best_clusterer = kmeans

    def __call__(self, activations: Activations, predictions) -> np.ndarray:
        return self.best_clusterer.predict(_as_rows(activations, self.device))


class MultiModalSA:
    """Routes samples through a discriminator to per-modal SA instances."""

    def __init__(self, discriminator: Callable, modal_sa: Dict[int, Callable]):
        self.discriminator = discriminator
        self.modal_sa = modal_sa

    @staticmethod
    def build_with_kmeans(
        activations: Activations,
        predictions,
        sa_constructor: Callable,
        potential_k: Iterable[int],
        subsampling=1.0,
        device: DeviceLike = None,
    ):
        """One SA per cluster of silhouette-scored k-means (pc-mmdsa)."""
        discriminator = _KmeansDiscriminator(activations, potential_k, subsampling=subsampling,
                                             device=device)
        return MultiModalSA.build(activations, predictions, discriminator, sa_constructor)

    @staticmethod
    def build(activations: Activations, predictions, discriminator: Callable,
              sa_constructor: Callable):
        """Fit one SA per modal id that the discriminator gives the rows."""
        rows = _as_rows(activations)
        predictions = None if predictions is None else np.asarray(predictions)
        modal_indexes = discriminator(rows, predictions)
        sa_s = {}
        for modal_id in np.unique(modal_indexes):
            mask = modal_indexes == modal_id
            idx = torch.from_numpy(np.flatnonzero(mask)).to(rows.device)
            sa_s[int(modal_id)] = sa_constructor(
                rows[idx], None if predictions is None else predictions[mask])
        return MultiModalSA(discriminator=discriminator, modal_sa=sa_s)

    def __call__(self, activations: Activations, predictions) -> np.ndarray:
        rows = _as_rows(activations)
        predictions = None if predictions is None else np.asarray(predictions)
        modal_ids = np.asarray(self.discriminator(rows, predictions))
        if len(modal_ids) != rows.shape[0]:
            raise ValueError(f"The discriminator returned {len(modal_ids)} modal indexes "
                             f"for {rows.shape[0]} samples")
        if len(modal_ids) == 0:
            return np.ndarray(shape=(0,))
        present = np.unique(modal_ids)
        per_modal = []
        for modal_id in present:
            if int(modal_id) not in self.modal_sa:
                raise ValueError(
                    f"No modal found for modal id {modal_id}. Check your discriminator")
            mask = modal_ids == modal_id
            idx = torch.from_numpy(np.flatnonzero(mask)).to(rows.device)
            per_modal.append(self.modal_sa[int(modal_id)](
                rows[idx], None if predictions is None else predictions[mask]))
        res = np.full(modal_ids.shape, -np.inf, dtype=per_modal[0].dtype)
        for modal_id, values in zip(present, per_modal):
            res[modal_ids == modal_id] = values
        return res


def pinvh(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """``scipy.linalg.pinvh(a)`` of a symmetric float64 host matrix, with
    scipy's default cut-off (eigenvalues at most ``max(a.shape) * eps``
    times the largest in magnitude are dropped), from a float64 ``eigh`` on
    ``device``; float32. scipy's own ``eigh`` (LAPACK ``syev``) takes seconds
    on the host at 1,600 features."""
    w, u = torch.linalg.eigh(torch.from_numpy(np.atleast_2d(a)).to(device))
    cutoff = w.abs().max() * (max(a.shape) * np.finfo(np.float64).eps)
    kept = w.abs() > cutoff
    u = u[:, kept]
    return ((u / w[kept]) @ u.T).float()


class MDSA:
    """Mahalanobis-distance SA: the squared Mahalanobis distance of a trace
    to the training traces' mean under the pseudo-inverse of their (biased)
    covariance. The mean and covariance are the JAX package's host numpy
    (float32, so equal traces give equal covariances); the pseudo-inverse
    (``pinvh``) and the quadratic form run on the device."""

    def __init__(self, activations: Activations, device: DeviceLike = None):
        self.device = resolve(device)
        host = _as_rows(activations).cpu().numpy()
        location = host.mean(axis=0, dtype=np.float64).astype(np.float32)
        centered = host - location
        covariance = (centered.T @ centered).astype(np.float64) / host.shape[0]
        self.location = torch.from_numpy(location).to(self.device)
        self.precision = pinvh(covariance, self.device)

    def __call__(self, activations: Activations, predictions=None) -> np.ndarray:
        centered = _as_rows(activations, self.device) - self.location
        scores = ((centered @ self.precision) * centered).sum(dim=1)
        return scores.cpu().numpy().astype(np.float64)


class LSA:
    """Likelihood SA: -log KDE density over the training traces, the
    features pruned to the ``max_features`` of highest variance and dropped
    one at a time where the KDE's Cholesky fails."""

    def __init__(self, activations: Activations, max_features: int = 300,
                 device: DeviceLike = None):
        self.device = resolve(device)
        host = _as_rows(activations).cpu().numpy()
        num_features = min(max_features, host.shape[1])
        dropped_columns = np.argsort(np.var(host, axis=0))[:-num_features]
        self.removed_neurons: List[int] = [int(x) for x in dropped_columns]
        self.kde = self._create_gaussian_kde(host)

    def _kept(self, width: int) -> np.ndarray:
        return np.delete(np.arange(width), self.removed_neurons)

    def _create_gaussian_kde(self, host: np.ndarray) -> Optional[StableGaussianKDE]:
        kept = self._kept(host.shape[1])
        if kept.size == 0:
            warnings.warn(
                "The removal of low-variance and/or numerically unstable "
                "features removed all ATs. This instance of LSA will thus "
                "always return density 0",
                UserWarning,
            )
            return None
        try:
            return StableGaussianKDE(host[:, kept].transpose(), device=self.device)
        except KDESingularError as e:
            if e.problematic_dim is None:
                warnings.warn("Problem regarding KDE fitting", UserWarning)
                raise
            problematic_index = int(kept[e.problematic_dim])
            warnings.warn(
                f"Dropping AT {problematic_index}, as leading to numerical error.",
                UserWarning,
            )
            self.removed_neurons.append(problematic_index)
            return self._create_gaussian_kde(host)

    def log_density(self, activations: Activations) -> torch.Tensor:
        """The KDE's float32 log density at each trace, on the device (-inf
        where the KDE failed silently); its ``exp`` is the density that
        ``__call__`` takes the -log of."""
        rows = _as_rows(activations, self.device)
        kept = torch.from_numpy(self._kept(rows.shape[1])).to(self.device)
        return self.kde.log_evaluate(rows.index_select(1, kept).T)

    def __call__(self, activations: Activations, predictions=None) -> np.ndarray:
        if self.kde is None:
            return np.zeros(shape=(_as_rows(activations).shape[0],))
        density = torch.exp(self.log_density(activations)).cpu().numpy().astype(np.float64)
        with np.errstate(divide="ignore"):
            return -np.log(density)


class MLSA:
    """Multimodal likelihood SA: the negative log-likelihood under a
    Gaussian mixture of ``num_components`` (clamped to the sample count; a
    single sample is duplicated), refitted with a larger ``reg_covar``
    while the fit fails."""

    REG_COVAR_LADDER = (1e-6, 1e-4, 1e-2)

    def __init__(
        self,
        activations: Activations,
        num_components: int = 2,
        device: DeviceLike = None,
    ):
        self.device = resolve(device)
        rows = _as_rows(activations, self.device)
        if rows.shape[0] < num_components:
            warnings.warn(
                f"MLSA modal has only {rows.shape[0]} samples for "
                f"{num_components} mixture components; clamping components "
                "to the sample count"
            )
            num_components = max(1, rows.shape[0])
            if rows.shape[0] == 1:
                rows = rows.repeat(2, 1)
        last_error = None
        for reg_covar in self.REG_COVAR_LADDER:
            try:
                self.gmm = GaussianMixture(num_components, reg_covar=reg_covar,
                                           device=self.device)
                self.gmm.fit(rows)
                self.gmm.score_samples(rows[:1])
                break
            except ValueError as e:
                last_error = e
                if reg_covar != self.REG_COVAR_LADDER[-1]:
                    warnings.warn(
                        f"GMM fit failed at reg_covar={reg_covar:g} ({e}); "
                        "retrying with stronger covariance regularization"
                    )
        else:
            raise last_error

    def __call__(self, activations: Activations, predictions=None) -> np.ndarray:
        return -self.gmm.score_samples(_as_rows(activations, self.device))
