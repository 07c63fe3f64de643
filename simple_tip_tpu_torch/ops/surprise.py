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
"""

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from simple_tip_tpu_torch.ops.dsa_cuda import (
    QueryPlan, class_layout, masked_nearest, plan_queries, worth_planning,
)

Activations = Union[Sequence[torch.Tensor], torch.Tensor]


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
