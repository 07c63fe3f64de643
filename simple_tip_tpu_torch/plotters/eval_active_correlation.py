"""Active-learning statistics (the paper's Fig 4): Wilcoxon p-values and
A12 effect sizes over the AL accuracies on the (dataset, future) split of
every (case study, dataset), pooled, written as
``results/active_correlation_{p,eff}.csv``.

Own copy of the JAX package's ``plotters/eval_active_correlation.py`` on
the port's AL pickle reader, without the heatmap. Only runs below
``NUM_RUNS`` count, and a sample is ``{cs}_{run}``, so the OOD pass
replaces the nominal value of the same run, as in the reference.
"""

import logging
from typing import Dict

import numpy as np

from simple_tip_tpu_torch.plotters import utils
from simple_tip_tpu_torch.plotters.correlation_plot import pooled_statistics
from simple_tip_tpu_torch.plotters.eval_active_learning_table import (
    load_arrays_active_learning,
)

logger = logging.getLogger(__name__)

_EXTENDED = [*utils.APPROACHES, "original", "random"]


def _future_split_accuracies(case_study: str, dataset: str) -> Dict[str, Dict[int, float]]:
    """Per approach and run, the accuracy on the (dataset, future) split."""
    raw = load_arrays_active_learning(case_study, dataset, by_id=True)
    return {
        approach: {
            run: accs[(dataset, "future")]
            for run, accs in raw.get(approach, {}).items()
            if run < utils.NUM_RUNS
        }
        for approach in _EXTENDED
    }


def _warn_missing(cs: str, ds: str, values) -> None:
    missing = utils.identify_incomplete_values(values, has_dropout=cs != "cifar10")
    if missing:
        logger.warning("Missing values %s - %s: %s", cs, ds, missing)


def run(case_studies=("mnist", "fmnist", "cifar10", "imdb"), plot: bool = False
        ) -> Dict[str, np.ndarray]:
    """Pool the future-split AL accuracies of ``case_studies`` and write the
    two CSVs; returns the p, effect-size and sample-count grids. The heatmap
    (``plot``) is not ported."""
    if plot:
        raise NotImplementedError("the heatmap needs matplotlib and seaborn, which the port "
                                  "does not use; the CSVs hold its numbers")
    pooled: Dict[str, Dict[str, float]] = {a: {} for a in _EXTENDED}
    for cs in case_studies:
        for ds in ("nominal", "ood"):
            values = _future_split_accuracies(cs, ds)
            _warn_missing(cs, ds, values)
            named = utils.named_tuples(cs, values, None, _EXTENDED)
            for approach, samples in named.items():
                pooled[approach].update(samples)
    return pooled_statistics(pooled, utils.APPROACHES, "active_correlation")


if __name__ == "__main__":
    run()
