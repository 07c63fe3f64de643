"""Shared preparation of the training traces for the SA variants.

Counterpart of the serial part of the JAX package's ``engine/sa_prep.py``:
``SharedTrainPrep`` flattens the training traces and partitions them by
predicted class once, for every variant, and ``debit_for`` charges that
shared cost into each variant's setup record (the flatten to every
variant, the partition also to the three per-class ones).
``VariantFitter`` builds the registry's variants from it, one after
another on one device. The JAX package's process pool, its fit pipeline,
its whole-variant fan-out and its disk cache of fitted scorers are not
ported.
"""

from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from simple_tip_tpu_torch.ops.surprise import (
    DSA,
    MultiModalSA,
    _as_rows,
    _by_class_discriminator,
    _class_predictions,
)
from simple_tip_tpu_torch.ops.timer import Timer

#: The variants fitted one SA per predicted class (they share the partition).
BY_CLASS = ("pc-lsa", "pc-mdsa", "pc-mlsa")


class SharedTrainPrep:
    """Flat training traces on the device and their by-class partition."""

    def __init__(self, train_ats, train_pred, device: torch.device):
        flat_timer, part_timer = Timer(device=device), Timer(device=device)
        with flat_timer:
            self.flat = _as_rows(train_ats, device)
            self.pred = _class_predictions(train_pred)
        with part_timer:
            self.class_views: Dict[int, torch.Tensor] = {}
            for c in np.unique(self.pred):
                idx = torch.from_numpy(np.flatnonzero(self.pred == c)).to(device)
                self.class_views[int(c)] = self.flat[idx]
        self.flatten_debit = flat_timer.get()
        self.partition_debit = part_timer.get()

    def debit_for(self, sa_name: str) -> float:
        """Shared-prep seconds owed by ``sa_name``'s setup record."""
        if sa_name in BY_CLASS:
            return self.flatten_debit + self.partition_debit
        return self.flatten_debit


class VariantFitter:
    """Builds registry variants from one ``SharedTrainPrep`` on ``device``;
    ``dsa_badge_size`` chunks DSA's scoring."""

    def __init__(self, prep: SharedTrainPrep, device: torch.device,
                 dsa_badge_size: Optional[int] = None):
        self.prep = prep
        self.device = device
        self.dsa_badge_size = dsa_badge_size

    def dsa(self, subsampling) -> DSA:
        return DSA(self.prep.flat, self.prep.pred, subsampling=subsampling,
                   badge_size=self.dsa_badge_size)

    def by_class(self, modal: Callable) -> MultiModalSA:
        """One ``modal(traces)`` per predicted class, from the partition."""
        modal_sa = {c: modal(acts) for c, acts in self.prep.class_views.items()}
        return MultiModalSA(discriminator=_by_class_discriminator, modal_sa=modal_sa)

    def with_kmeans(self, modal: Callable, potential_k: Iterable[int],
                    subsampling) -> MultiModalSA:
        """One ``modal(traces)`` per cluster of silhouette-scored k-means."""
        return MultiModalSA.build_with_kmeans(
            self.prep.flat, self.prep.pred, lambda acts, _: modal(acts), potential_k,
            subsampling=subsampling, device=self.device)
