"""Streaming per-neuron min / max / std over activation badges, on the device.

Counterpart of the JAX package's ``DeviceAggregateStatisticsCollector``
(``ops/stats.py``): each badge folds into the running per-layer
(min, max, count, mean, m2) state with Chan et al.'s parallel Welford update
in float32; ``std`` is the sample standard deviation (``n - 1``). The three
statistics are computed together, so their measured time is credited in
equal thirds to the min, max and Welford timers (the coverage worker's
setup debits read them).
"""

import time
from typing import List, Sequence, Tuple

import torch

from simple_tip_tpu_torch.ops.timer import Timer

AggStats = Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]


def _badge_moments(b: torch.Tensor):
    flat = b.reshape(b.shape[0], -1).float()
    mean = flat.mean(dim=0)
    return mean, ((flat - mean) ** 2).sum(dim=0)


class DeviceAggregateStatisticsCollector:
    """Per-layer min/max/std folded badge by badge on the badge's device."""

    def __init__(self):
        self.done = False
        self._state = None  # per layer: [min, max, count, mean, m2]
        self.min_timer = Timer()
        self.max_timer = Timer()
        self.welford_timer = Timer()
        self._elapsed = 0.0

    def track(self, badge: Sequence[torch.Tensor]) -> None:
        """Fold the next badge of per-layer activation tensors in."""
        if self.done:
            raise RuntimeError(
                "`get` has been called. calling it multiple times falsifies timer."
            )
        t0 = time.perf_counter()
        if self._state is None:
            self._state = []
            for b in badge:
                mean, m2 = _badge_moments(b)
                self._state.append([b.amin(dim=0), b.amax(dim=0), b.shape[0], mean, m2])
        else:
            for s, b in zip(self._state, badge):
                mn, mx, cnt, mean, m2 = s
                b_mean, b_m2 = _badge_moments(b)
                b_cnt = b.shape[0]
                delta = b_mean - mean
                total = cnt + b_cnt
                s[0] = torch.minimum(mn, b.amin(dim=0))
                s[1] = torch.maximum(mx, b.amax(dim=0))
                s[2] = total
                s[3] = mean + delta * (b_cnt / total)
                s[4] = m2 + b_m2 + delta**2 * (cnt * b_cnt / total)
        if badge[0].device.type == "cuda":
            torch.cuda.synchronize(badge[0].device)
        self._elapsed += time.perf_counter() - t0

    def get(self) -> AggStats:
        """``(mins, maxs, stds)`` per layer, shaped like one sample of it."""
        self.done = True
        third = self._elapsed / 3.0
        for t in (self.min_timer, self.max_timer, self.welford_timer):
            t.add(third)
        mins = [s[0] for s in self._state]
        maxs = [s[1] for s in self._state]
        stds = [torch.sqrt(s[4] / (s[2] - 1)).reshape(s[0].shape) for s in self._state]
        return mins, maxs, stds
