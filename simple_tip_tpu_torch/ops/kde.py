"""Gaussian kernel density estimation with covariance stabilisation.

Counterpart of the JAX package's ``ops/kde.py`` ``StableGaussianKDE`` on its
``jax`` backend. The fit stays on the host in float64 numpy/scipy, as there:

- Scott's bandwidth factor ``n**(-1/(d+4))``;
- while the scaled covariance has a non-positive eigenvalue, the data
  covariance's diagonal is *replaced* by a doubling increment (1e-10,
  2e-10, ...); past ``MAX_INCREMENT`` the fit fails silently and every
  density is 0;
- the Cholesky factor of ``2*pi*covariance``; a failure raises
  ``KDESingularError`` with the 0-based index of the offending feature, so
  LSA can drop it and refit.

``log_evaluate`` runs on the device in float32: triangular solves against
the covariance's Cholesky factor, the expanded whitened d^2, then
``logsumexp(-d^2/2) + log_norm``; ``evaluate`` is its ``exp``. The
log-space form keeps float32 in range where ``exp(-log_det/2)/n`` alone
would not. A density can still underflow to 0, as on the JAX package's
device path.
"""

import warnings
from typing import Optional

import numpy as np
import scipy.linalg
import torch

from simple_tip_tpu_torch.device import DeviceLike, resolve

# rows of a points-by-dataset distance block (bounds the device memory)
EVAL_BLOCK = 1 << 26


class KDESingularError(np.linalg.LinAlgError):
    """Cholesky failure carrying the 0-based index of the offending feature
    (None if unknown)."""

    def __init__(self, message: str, problematic_dim: Optional[int]):
        super().__init__(message)
        self.problematic_dim = problematic_dim


class StableGaussianKDE:
    """Gaussian KDE over a ``(d, n)`` dataset; ``device=None`` is the card."""

    MAX_INCREMENT = 1e-5

    def __init__(self, dataset: np.ndarray, device: DeviceLike = None):
        self.device = resolve(device)
        self.dataset = np.atleast_2d(np.asarray(dataset, dtype=np.float64))
        self.d, self.n = self.dataset.shape
        self.factor = np.power(self.n, -1.0 / (self.d + 4))
        self.prepare_failed = False
        self._compute_covariance()
        if not self.prepare_failed:
            # the device copies of the float32 evaluation
            chol = self.cho_cov / np.sqrt(2 * np.pi)
            self._chol = torch.from_numpy(chol.astype(np.float32)).to(self.device)
            white = torch.linalg.solve_triangular(
                self._chol,
                torch.from_numpy(self.dataset.astype(np.float32)).to(self.device),
                upper=False,
            )
            self._white_data = white
            self._white_sq = (white * white).sum(dim=0)
            self._log_norm = float(np.float32(-0.5 * self.log_det - np.log(self.n)))

    def _compute_covariance(self):
        data_covariance = np.atleast_2d(np.cov(self.dataset, rowvar=1, bias=False))
        data_covariance = self._stabilize_covariance(data_covariance)
        if self.prepare_failed:
            return
        try:
            np.linalg.inv(data_covariance)
        except np.linalg.LinAlgError:
            self.prepare_failed = True
            return
        try:
            chol = scipy.linalg.cholesky(data_covariance * self.factor**2 * 2 * np.pi, lower=True)
        except scipy.linalg.LinAlgError as e:
            dim = None
            msg = str(e)
            if "leading minor" in msg:
                try:
                    dim = int(msg.split("-th")[0].strip().lstrip("(")) - 1
                except ValueError:
                    dim = None
            raise KDESingularError(msg, dim) from e
        self.cho_cov = chol
        self.log_det = 2 * np.log(np.diag(chol)).sum()

    def _stabilize_covariance(self, covariance: np.ndarray):
        """Replace the diagonal with a doubling increment until the scaled
        covariance is numerically positive definite, or fail silently."""
        if not np.isfinite(covariance).all():
            warnings.warn(
                "Covariance matrix is not finite (too few samples?). "
                "Failing silently. All likelihoods will be reported as 0."
            )
            self.prepare_failed = True
            return None
        increment = 1e-10
        while np.any(np.linalg.eigh(covariance * self.factor**2)[0] <= 0):
            np.fill_diagonal(covariance, increment)
            if increment > self.MAX_INCREMENT:
                warnings.warn(
                    "Was not able to fix numerical imprecision in covariance "
                    "matrix. Failing silently. All likelihoods will be "
                    "reported as 0."
                )
                self.prepare_failed = True
                return None
            increment += increment
        self.prepare_failed = False
        return covariance

    def log_evaluate(self, points) -> torch.Tensor:
        """Float32 log densities on the device at ``points`` of shape
        ``(d, m)`` (a host array or a tensor); -inf if the fit failed."""
        if isinstance(points, torch.Tensor):
            points = points.detach().to(device=self.device, dtype=torch.float32)
        else:
            points = torch.from_numpy(
                np.atleast_2d(np.asarray(points, dtype=np.float32))
            ).to(self.device)
        if points.dim() == 1:
            points = points[None, :]
        if self.prepare_failed:
            return points.new_full((points.shape[1],), -np.inf)
        if points.shape[0] != self.d:
            raise ValueError(f"points have dimension {points.shape[0]}, dataset has {self.d}")
        white = torch.linalg.solve_triangular(self._chol, points, upper=False)  # [d, m]
        block = max(1, EVAL_BLOCK // max(1, self.n))
        out = []
        for start in range(0, white.shape[1], block):
            wp = white[:, start : start + block]
            d2 = (
                self._white_sq[None, :]
                + (wp * wp).sum(dim=0)[:, None]
                - 2.0 * (wp.T @ self._white_data)
            ).clamp_min(0.0)
            out.append(torch.logsumexp(-0.5 * d2, dim=1) + self._log_norm)
        return torch.cat(out) if out else points.new_zeros(0)

    def evaluate(self, points) -> np.ndarray:
        """Densities (float64 on the host) at ``points``: the float32 ``exp``
        of ``log_evaluate``, so zeros if the fit failed."""
        return torch.exp(self.log_evaluate(points)).cpu().numpy().astype(np.float64)
