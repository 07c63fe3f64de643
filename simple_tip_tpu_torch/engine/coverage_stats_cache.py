"""Disk cache of the coverage worker's training statistics, across processes.

Own copy of the JAX package's ``engine/coverage_stats_cache.py``:
``CoverageWorker`` opens with a pass over the whole training set for the
per-neuron mins, maxs and standard deviations of NBC, SNAC and KMNC. They
depend only on (weights, training set, taps), so one pickle per
fingerprint under ``TIP_COV_STATS_CACHE_DIR`` (default
``$TIP_ASSETS/coverage_stats_cache``; ``off`` disables it) spares every
later phase and process that pass. The statistics are stored as host numpy
arrays, one per tap, and loaded onto the worker's device. Writes are
atomic, a load checks the meta, and any read failure is a logged miss that
the recompute overwrites. The key is ``content_fingerprint`` under this
package's version string and its ``torch`` tag (no cluster-backend tag:
the statistics do not depend on one), so the two packages never load each
other's entries; a worker of the bf16 scoring mode adds the ``bfloat16``
tag (``sa_prep.dtype_tags``: its taps are the bf16 model's), float32 keys
carry none. Outcomes count as in the JAX package:
``cov_stats_cache.{hit,miss,stale,corrupt,store}`` counters and
``cov_stats_cache`` events in ``obs``.
"""

import logging
import os
import pickle
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from simple_tip_tpu_torch import obs
from simple_tip_tpu_torch.config import output_folder
from simple_tip_tpu_torch.engine.sa_prep import BACKEND_TAG, content_fingerprint, dtype_tags
from simple_tip_tpu_torch.utils.artifacts_io import atomic_write_bytes, sweep_orphan_tmp

logger = logging.getLogger(__name__)

#: Bump when the entry layout or the statistics change; other versions miss.
COV_STATS_FORMAT_VERSION = "cov-stats-cache-torch-v1"

Stats = Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]


class CoverageStatsCache:
    """Disk cache of one ``(mins, maxs, stds)`` triple of per-tap statistics."""

    def __init__(self, root: str, fingerprint: str):
        self.root = root
        self.fingerprint = fingerprint
        sweep_orphan_tmp(self.root)

    @classmethod
    def from_env(cls, params, training_set, activation_layers: Sequence,
                 compute_dtype=None) -> Optional["CoverageStatsCache"]:
        """The cache of ``TIP_COV_STATS_CACHE_DIR`` (None when ``off`` or
        ``0``) for the flax-layout ``params`` of a model scoring in
        ``compute_dtype``."""
        raw = os.environ.get("TIP_COV_STATS_CACHE_DIR", "").strip()
        if raw.lower() in ("off", "0"):
            return None
        if not raw:
            raw = os.path.join(output_folder(), "coverage_stats_cache")
        fp = content_fingerprint(COV_STATS_FORMAT_VERSION, params, training_set,
                                 activation_layers, BACKEND_TAG, *dtype_tags(compute_dtype))
        return cls(root=raw, fingerprint=fp)

    @property
    def path(self) -> str:
        return os.path.join(self.root, f"cov_stats_{self.fingerprint[:16]}.pkl")

    def load(self, device: torch.device) -> Optional[Stats]:
        """The cached statistics as tensors on ``device``, or None for a
        missing, stale or unreadable entry."""
        path = self.path
        try:
            with open(path, "rb") as f:
                entry = pickle.load(f)
            meta = entry["meta"]
            if (
                meta["version"] != COV_STATS_FORMAT_VERSION
                or meta["fingerprint"] != self.fingerprint
            ):
                logger.info("coverage-stats cache STALE (%s)", path)
                obs.counter("cov_stats_cache.stale").inc()
                obs.event("cov_stats_cache", outcome="stale")
                return None
            stats = tuple([torch.from_numpy(np.asarray(a)).to(device) for a in stat]
                          for stat in entry["stats"])
        except FileNotFoundError:
            obs.counter("cov_stats_cache.miss").inc()
            obs.event("cov_stats_cache", outcome="miss")
            return None
        except Exception as e:  # noqa: BLE001 - an unreadable entry is recomputed
            logger.warning("coverage-stats cache entry corrupt (%s: %r); recomputing", path, e)
            obs.counter("cov_stats_cache.corrupt").inc()
            obs.event("cov_stats_cache", outcome="corrupt")
            return None
        obs.counter("cov_stats_cache.hit").inc()
        obs.event("cov_stats_cache", outcome="hit")
        logger.info("coverage-stats cache HIT (%s)", path)
        return stats

    def store(self, stats: Stats) -> None:
        """Write the statistics as host arrays (atomic; a failure warns,
        never raises)."""
        try:
            os.makedirs(self.root, exist_ok=True)
            entry = {
                "meta": {"version": COV_STATS_FORMAT_VERSION, "fingerprint": self.fingerprint},
                "stats": tuple([t.detach().cpu().numpy() for t in stat] for stat in stats),
            }
            atomic_write_bytes(self.path, pickle.dumps(entry, protocol=4))
            logger.info("coverage-stats cache stored (%s)", self.path)
            obs.counter("cov_stats_cache.store").inc()
        except Exception as e:  # noqa: BLE001 - the cache only saves time
            logger.warning("coverage-stats cache store failed (%r)", e)
