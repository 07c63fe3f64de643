"""Monotonic accumulating timer that synchronises the card before each read.

Same semantics as the JAX package's ``ops/timer.py``: re-entrant
accumulation over start/stop segments, a context-manager form,
``RuntimeError`` on misuse and a ``RuntimeWarning`` when read while running.
CUDA launches return before the card finishes, so a timer given a CUDA
device synchronises it at start and stop; the ``[setup, pred, quant, cam]``
records then measure device work, not the enqueue.
"""

import time
import warnings
from typing import Optional

import torch


class Timer:
    """Accumulating ``perf_counter`` timer; ``device`` opts into syncs."""

    def __init__(self, start: bool = False, device: Optional[torch.device] = None):
        self._start_time = None
        self._elapsed = 0.0
        self._cuda = device is not None and torch.device(device).type == "cuda"
        if start:
            self.start()

    def _sync(self) -> None:
        if self._cuda:
            torch.cuda.synchronize()

    def start(self):
        """Start the timer; it must not already be running."""
        if self._start_time is not None:
            raise RuntimeError("Timer is already started")
        self._sync()
        self._start_time = time.perf_counter()

    def stop(self):
        """Stop the timer; it must be running."""
        if self._start_time is None:
            raise RuntimeError("Timer is not started")
        self._sync()
        self._elapsed += time.perf_counter() - self._start_time
        self._start_time = None

    def get(self) -> float:
        """Elapsed seconds over all completed segments (warns if still running)."""
        if self._start_time is not None:
            warnings.warn("Timer is not stopped", RuntimeWarning)
        return self._elapsed

    def add(self, seconds: float) -> None:
        """Credit ``seconds`` measured elsewhere to this timer."""
        self._elapsed += seconds

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
