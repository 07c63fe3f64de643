"""Neuron-coverage criteria (NAC, KMNC, NBC, SNAC, TKNC) on torch tensors.

Counterpart of the JAX package's ``ops/coverage.py``: each criterion maps a
badge of per-layer activations (NHWC taps) to ``(scores, profiles)``, where
``profiles`` is a boolean coverage-bit array per sample and ``scores`` its
count of set bits in the smallest integer dtype that holds the maximum
(int16, int32 or int64; the artifacts keep that dtype). The constructors
take the train-set statistics as per-layer tensors.

``make_fused_profile_fn`` computes every metric's scores and MSB-first
packed profiles (numpy ``packbits`` layout) from one badge.
"""

import abc
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

_MSB_FIRST = (128, 64, 32, 16, 8, 4, 2, 1)


def sum_score(profiles: torch.Tensor) -> torch.Tensor:
    """Per-sample count of covered sections in the smallest integer dtype
    that can hold the maximum possible score."""
    if profiles.dtype != torch.bool:
        raise ValueError("profiles must be boolean")
    maxval = int(np.prod(profiles.shape[1:]))
    if maxval <= np.iinfo(np.int16).max:
        dtype = torch.int16
    elif maxval <= np.iinfo(np.int32).max:
        dtype = torch.int32
    else:
        dtype = torch.int64
    return profiles.reshape(profiles.shape[0], -1).sum(dim=1, dtype=dtype)


def flatten_layers(layers: Sequence[torch.Tensor]) -> torch.Tensor:
    """Flatten a list of per-layer activation tensors to (batch, neurons)."""
    return torch.cat([layer.reshape(layer.shape[0], -1) for layer in layers], dim=1)


def _flatten_1d(arrays: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([a.reshape(-1) for a in arrays])


class CoverageMethod(abc.ABC):
    """Abstract neuron-coverage criterion: callable on a badge of activations."""

    @abc.abstractmethod
    def __call__(self, activations: List[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Return (scores, profiles) for a badge of per-layer activations."""


class NAC(CoverageMethod):
    """Neuron-Activation Coverage: bit set where activation > threshold."""

    def __init__(self, cov_threshold: float):
        self.cov_threshold = cov_threshold

    def __call__(self, activations):
        profiles = flatten_layers(activations) > self.cov_threshold
        return sum_score(profiles), profiles


class KMNC(CoverageMethod):
    """K-Multisection Neuron Coverage: which of k train-range buckets each
    neuron's activation falls into; bucket i is [lo + i*jump, lo + (i+1)*jump)."""

    def __init__(self, mins, maxs, sections: int):
        self.sections = sections
        self.lo = _flatten_1d(mins)
        self.jumps = (_flatten_1d(maxs) - self.lo) / sections

    def __call__(self, activations):
        acts = flatten_layers(activations)
        steps = torch.arange(self.sections + 1, dtype=torch.float32, device=acts.device)
        edges = self.lo[None, :, None] + self.jumps[None, :, None] * steps
        a = acts[:, :, None]
        profiles = (edges[..., :-1] <= a) & (a < edges[..., 1:])
        return sum_score(profiles), profiles


class NBC(CoverageMethod):
    """Neuron Boundary Coverage: activation outside [min - s*std, max + s*std]."""

    def __init__(self, mins, maxs, stds, scaler: float):
        std = _flatten_1d(stds)
        self.min_boundaries = _flatten_1d(mins) - scaler * std
        self.max_boundaries = _flatten_1d(maxs) + scaler * std

    def __call__(self, activations):
        acts = flatten_layers(activations)
        profiles = torch.stack(
            [acts <= self.min_boundaries, acts >= self.max_boundaries], dim=-1
        )
        return sum_score(profiles), profiles


class SNAC(CoverageMethod):
    """Strong Neuron Activation Coverage: activation >= max + s*std."""

    def __init__(self, maxs, stds, scaler: float):
        self.max_boundaries = _flatten_1d(maxs) + scaler * _flatten_1d(stds)

    def __call__(self, activations):
        profiles = flatten_layers(activations) >= self.max_boundaries
        return sum_score(profiles), profiles


class TKNC(CoverageMethod):
    """Top-K Neuron Coverage: per layer, bit set for the k highest-activated
    neurons of each sample.

    Ties at the top-k boundary go to the HIGHER neuron index, as in the JAX
    package. ``torch.topk`` promises no tie order and relu layers are full
    of exact zeros, so the top k are the last k of a stable ascending sort
    (equal values keep ascending index order there).
    """

    def __init__(self, top_neurons: int):
        self.top_neurons = top_neurons

    def __call__(self, activations):
        profiles = []
        for layer in activations:
            layer = layer.reshape(layer.shape[0], -1)
            order = torch.sort(layer, dim=1, stable=True).indices
            prof = torch.zeros(layer.shape, dtype=torch.bool, device=layer.device)
            prof.scatter_(1, order[:, -self.top_neurons :], True)
            profiles.append(prof)
        flat = flatten_layers(profiles)
        return sum_score(flat), flat


def packbits(flat: torch.Tensor) -> torch.Tensor:
    """``np.packbits(flat, axis=1)``: uint8 rows, MSB first, zero-padded."""
    n, w = flat.shape
    pad = (-w) % 8
    if pad:
        flat = torch.cat([flat, flat.new_zeros(n, pad)], dim=1)
    weights = torch.tensor(_MSB_FIRST, dtype=torch.int32, device=flat.device)
    return (flat.reshape(n, -1, 8).to(torch.int32) * weights).sum(dim=2).to(torch.uint8)


def make_fused_profile_fn(metrics: Dict[str, CoverageMethod]) -> Callable:
    """``fn(activations) -> {metric_id: (scores, packed profiles)}`` for
    every configured metric."""

    def fused(activations):
        out = {}
        for mid, metric in metrics.items():
            s, p = metric(activations)
            out[mid] = (s, packbits(p.reshape(p.shape[0], -1)))
        return out

    return fused
