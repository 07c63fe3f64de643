"""K-means (with the silhouette that picks k) and a Gaussian mixture, in torch.

Counterpart of the JAX package's ``ops/cluster.py`` (its ``jax`` cluster
backend, which is what it runs on an accelerator), with the same fitted
results from the same seeds:

- ``KMeans(n_clusters, n_init, random_state)``: k-means++ initial
  centroids drawn on the host with ``np.random.RandomState`` (the same
  draws as the JAX package), then ``KMEANS_MAX_ITER`` fixed Lloyd
  iterations on the device for every restart at once; the restart of least
  inertia wins. Distances are the expanded d^2 = |x|^2 + |c|^2 - 2 x.c; an
  empty cluster keeps its old centroid.
- ``silhouette_scores_multi``: the mean silhouette of several labelings of
  the same rows in one chunked distance pass on the device.
- ``GaussianMixture(n_components, reg_covar)``: EM with full covariances
  from ``GMM_N_INIT`` k-means starts (one k-means++ restart each, seeded
  ``GMM_SEED + s``), ``GMM_MAX_ITER`` fixed iterations, best final mean
  log-likelihood wins.

A Cholesky that fails gives NaN factors, as ``jnp.linalg.cholesky`` does
(``torch.linalg.cholesky`` would raise, and on the card only later): the NaN
spreads through the EM state, that restart's log-likelihood is NaN, and
``_validate_fit`` raises ``ValueError``, which moves MLSA's ``reg_covar``
ladder to its next rung on both packages alike. Since a NaN restart is the
one that ``np.argmax`` picks, EM stops at the first NaN log-likelihood.
Every product stays in exact float32 (``device.resolve`` turns TF32 off):
the argmins and the chosen k depend on it.
"""

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from simple_tip_tpu_torch.device import DeviceLike, resolve

Rows = Union[np.ndarray, torch.Tensor]

# float32 of d * log(2 pi) as the JAX package rounds it: log(2 pi) in float32,
# then the product in float32
_LOG_2PI_F32 = np.float32(np.log(np.float32(2 * np.pi)))

# the JAX package's settings, the only ones its registry uses
KMEANS_MAX_ITER = 300
GMM_MAX_ITER = 100
GMM_N_INIT = 3
GMM_SEED = 0


def on_device(x: Rows, device: torch.device) -> torch.Tensor:
    """``x`` as a float32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)


def _nearest_centroid(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid labels (argmin of the expanded quadform)."""
    d2 = (x * x).sum(dim=1)[:, None] + (c * c).sum(dim=1)[None, :] - 2.0 * (x @ c.T)
    return d2.argmin(dim=1)


def _kmeans_plus_plus(rng: np.random.RandomState, x: np.ndarray, k: int) -> np.ndarray:
    """Seeded k-means++ initial centroids (host). The JAX package recomputes
    every chosen centroid's distances at each step; the running minimum here
    gives the same float32 values with one distance pass per centroid."""
    n = x.shape[0]
    centroids = [x[rng.randint(n)]]
    d2 = ((x - centroids[0]) ** 2).sum(-1)
    for _ in range(1, k):
        probs = d2 / max(d2.sum(), 1e-12)
        centroids.append(x[rng.choice(n, p=probs)])
        d2 = np.minimum(d2, ((x - centroids[-1]) ** 2).sum(-1))
    return np.asarray(centroids, dtype=np.float32)


def _lloyd(x: torch.Tensor, centroids: torch.Tensor, max_iter: int):
    """``max_iter`` Lloyd iterations for every restart of ``centroids``
    ``[r, k, d]`` at once; returns (centroids, labels ``[r, n]``, inertia ``[r]``)."""
    n, d = x.shape
    r, k, _ = centroids.shape
    x_sq = (x * x).sum(dim=1)

    def assign(c):
        xc = (x @ c.reshape(r * k, d).T).reshape(n, r, k).permute(1, 0, 2)
        d2 = x_sq[None, :, None] + (c * c).sum(dim=2)[:, None, :] - 2.0 * xc
        d2_min, labels = d2.min(dim=2)
        return labels, d2_min.clamp_min(0.0)

    c = centroids
    for _ in range(max_iter):
        labels, _ = assign(c)
        one_hot = torch.nn.functional.one_hot(labels, k).to(x.dtype)  # [r, n, k]
        counts = one_hot.sum(dim=1)  # [r, k]
        sums = (one_hot.permute(1, 0, 2).reshape(n, r * k).T @ x).reshape(r, k, d)
        new_c = sums / counts.clamp_min(1.0)[..., None]
        # keep the old centroid of an empty cluster
        c = torch.where(counts[..., None] > 0, new_c, c)
    labels, d2 = assign(c)
    return c, labels, d2.sum(dim=1)


class KMeans:
    """fit_predict / predict with the fitted ``cluster_centers_``,
    ``labels_`` and ``inertia_``; ``device=None`` is the card."""

    def __init__(self, n_clusters: int, n_init: int = 10, random_state: int = 0,
                 device: DeviceLike = None):
        self.n_clusters = n_clusters
        self.n_init = n_init
        self.random_state = random_state
        self.device = resolve(device)
        self.cluster_centers_: Optional[np.ndarray] = None
        self.labels_: Optional[np.ndarray] = None
        self.inertia_: Optional[float] = None

    def fit_predict(self, x: Rows) -> np.ndarray:
        """Fit on ``x`` (best of ``n_init`` k-means++ restarts); its labels."""
        rows = on_device(x, self.device)
        host = rows.cpu().numpy()
        rng = np.random.RandomState(self.random_state)
        inits = np.stack(
            [_kmeans_plus_plus(rng, host, self.n_clusters) for _ in range(self.n_init)]
        )
        centroids, labels, inertia = _lloyd(
            rows, torch.from_numpy(inits).to(self.device), KMEANS_MAX_ITER
        )
        best = int(np.argmin(inertia.cpu().numpy()))
        self.cluster_centers_ = centroids[best].cpu().numpy()
        self.labels_ = labels[best].cpu().numpy()
        self.inertia_ = float(inertia[best])
        return self.labels_

    def predict(self, x: Rows) -> np.ndarray:
        """Nearest-centroid labels on the device."""
        assert self.cluster_centers_ is not None, "KMeans is not fitted"
        rows = on_device(x, self.device)
        c = torch.from_numpy(self.cluster_centers_).to(self.device)
        return _nearest_centroid(rows, c).cpu().numpy()


def silhouette_scores_multi(
    x: Rows, labelings: Sequence[np.ndarray], chunk: int = 2048, device: DeviceLike = None
) -> List[float]:
    """Mean silhouette of each labeling of ``x``, all from one chunked
    distance pass: every chunk's distances (d^2 clamped at 0, square-rooted)
    multiply the stacked one-hot matrices of all labelings at once. A
    singleton cluster's rows score 0."""
    dev = resolve(device)
    rows = on_device(x, dev)
    n = rows.shape[0]
    labs, counts, offsets, onehots = [], [], [], []
    off = 0
    for labels in labelings:
        uniq, lab = np.unique(np.asarray(labels), return_inverse=True)
        k = len(uniq)
        assert k >= 2, "silhouette requires >= 2 clusters"
        labs.append(lab.reshape(-1))
        counts.append(np.bincount(lab.reshape(-1), minlength=k).astype(np.float32))
        onehots.append(np.eye(k, dtype=np.float32)[lab.reshape(-1)])
        offsets.append((off, off + k))
        off += k
    big_onehot = torch.from_numpy(np.concatenate(onehots, axis=1)).to(dev)  # [n, sum_k]
    x_sq = (rows * rows).sum(dim=1)

    sils: List[List[np.ndarray]] = [[] for _ in labelings]
    for start in range(0, n, chunk):
        xc = rows[start : start + chunk]
        d2 = x_sq[start : start + chunk, None] + x_sq[None, :] - 2.0 * (xc @ rows.T)
        sums_all = (d2.clamp_min(0.0).sqrt() @ big_onehot).cpu().numpy()
        for i, (lo, hi) in enumerate(offsets):
            sums = sums_all[:, lo:hi]
            lc = labs[i][start : start + chunk]
            own = counts[i][lc]
            # a: mean distance within the own cluster, self excluded
            a = sums[np.arange(len(lc)), lc] / np.maximum(own - 1, 1)
            means = sums / np.maximum(counts[i][None, :], 1)
            means[np.arange(len(lc)), lc] = np.inf
            b = means.min(axis=1)
            s = (b - a) / np.maximum(a, b)
            s[own == 1] = 0.0
            sils[i].append(s)
    return [float(np.concatenate(parts).mean()) for parts in sils]


def _cholesky_or_nan(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of ``a [..., d, d]``; where a factorisation
    fails, its lower triangle is NaN (``jnp.linalg.cholesky``'s result)."""
    chol, info = torch.linalg.cholesky_ex(a)
    nan_lower = torch.full_like(chol, float("nan")).tril()
    return torch.where((info > 0)[..., None, None], nan_lower, chol)


def _weighted_log_prob(diff, chol, log_weights):
    """Per-component weighted log-densities ``[..., n, k]`` from the
    differences ``[..., k, n, d]`` to the means, the covariances' factors
    and the log weights ``[..., k]``."""
    d = diff.shape[-1]
    sol = torch.linalg.solve_triangular(chol, diff.transpose(-1, -2), upper=False)
    maha = (sol * sol).sum(dim=-2)  # [..., k, n]
    log_det = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(dim=-1)
    log_gauss = -0.5 * (maha + float(np.float32(d) * _LOG_2PI_F32) + log_det[..., None])
    return log_gauss.transpose(-1, -2) + log_weights[..., None, :]


def _gmm_em(x: torch.Tensor, resp: torch.Tensor, reg_covar: float, max_iter: int):
    """EM for every restart of ``resp [r, n, k]`` at once; returns (weights,
    means, covariances, final mean log-likelihood), each batched over r."""
    n, d = x.shape
    eye = torch.eye(d, dtype=x.dtype, device=x.device)

    def m_step(resp):
        nk = resp.sum(dim=1) + 1e-10  # [r, k]
        means = (resp.transpose(1, 2) @ x) / nk[..., None]  # [r, k, d]
        diff = x - means[:, :, None, :]  # [r, k, n, d]
        weighted = resp.transpose(1, 2)[..., None] * diff
        cov = weighted.transpose(-1, -2) @ diff / nk[..., None, None] + eye * reg_covar
        return nk / n, means, cov, diff

    ll = torch.zeros(resp.shape[0], dtype=x.dtype, device=x.device)
    for _ in range(max_iter):
        weights, _, cov, diff = m_step(resp)
        weighted = _weighted_log_prob(diff, _cholesky_or_nan(cov), torch.log(weights))
        log_norm = torch.logsumexp(weighted, dim=2, keepdim=True)
        resp = torch.exp(weighted - log_norm)
        ll = log_norm.mean(dim=(1, 2))
        if bool(torch.isnan(ll).any()):
            break  # NaN is sticky, and a NaN restart is the one picked: the fit fails
    weights, means, cov, _ = m_step(resp)
    return weights, means, cov, ll


class GaussianMixture:
    """fit / score_samples; ``device=None`` is the card."""

    def __init__(self, n_components: int, reg_covar: float = 1e-6, device: DeviceLike = None):
        self.n_components = n_components
        self.reg_covar = reg_covar
        self.device = resolve(device)
        self.weights_ = None
        self.means_ = None
        self.covariances_ = None

    def fit(self, x: Rows) -> "GaussianMixture":
        """EM restarts from k-means labels; the best final log-likelihood wins."""
        rows = on_device(x, self.device)
        resps = []
        for s in range(GMM_N_INIT):
            km = KMeans(self.n_components, n_init=1, random_state=GMM_SEED + s,
                        device=self.device)
            resps.append(np.eye(self.n_components, dtype=np.float32)[km.fit_predict(rows)])
        weights, means, cov, lls = _gmm_em(
            rows, torch.from_numpy(np.stack(resps)).to(self.device), self.reg_covar, GMM_MAX_ITER
        )
        best = int(np.argmax(lls.cpu().numpy()))
        self.weights_ = weights[best].cpu().numpy()
        self.means_ = means[best].cpu().numpy()
        self.covariances_ = cov[best].cpu().numpy()
        self._validate_fit()
        return self

    def _validate_fit(self) -> None:
        """Raise, as sklearn does, when a fitted parameter is not finite or a
        covariance has no float64 Cholesky factor."""
        finite = (
            np.all(np.isfinite(self.weights_))
            and np.all(np.isfinite(self.means_))
            and np.all(np.isfinite(self.covariances_))
        )
        if finite:
            try:
                np.linalg.cholesky(self.covariances_.astype(np.float64))
            except np.linalg.LinAlgError:
                finite = False
        if not finite:
            raise ValueError(
                "Fitting the mixture model failed because some components "
                "have ill-defined empirical covariance (for instance caused "
                "by singleton or collapsed samples). Try to decrease the "
                "number of components, or increase reg_covar."
            )

    def score_samples(self, x: Rows) -> np.ndarray:
        """Log-likelihood of each row under the mixture (float64 on the host):
        the covariances' factors with 1e-12 on the diagonal, the weights
        floored at 1e-35."""
        rows = on_device(x, self.device)
        means = torch.from_numpy(self.means_).to(self.device)
        cov = torch.from_numpy(self.covariances_).to(self.device)
        weights = torch.from_numpy(self.weights_).to(self.device)
        d = means.shape[1]
        chol = _cholesky_or_nan(cov + torch.eye(d, device=self.device) * 1e-12)
        weighted = _weighted_log_prob(rows - means[:, None, :], chol,
                                      torch.log(weights.clamp_min(1e-35)))
        return torch.logsumexp(weighted, dim=1).cpu().numpy().astype(np.float64)
