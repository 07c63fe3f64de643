"""APFD statistics (the paper's Fig 3): Wilcoxon p-values and A12 effect
sizes over the APFD values of every (case study, dataset), pooled, written
as ``results/apfd_correlation_{p,eff}.csv``.

Own copy of the JAX package's ``plotters/eval_apfd_correlation.py`` on the
port's APFD reader (``eval_apfd_table.load_apfd_values``, runs below 100),
without the heatmap. The pooling is the reference's: a sample is
``{cs}_{run}``, so the OOD pass replaces the nominal value of the same run.
"""

import logging
from typing import Dict

import numpy as np

from simple_tip_tpu_torch.plotters import utils
from simple_tip_tpu_torch.plotters.correlation_plot import pooled_statistics
from simple_tip_tpu_torch.plotters.eval_apfd_table import load_apfd_values

logger = logging.getLogger(__name__)


def _warn_missing(cs: str, ds: str, values) -> None:
    missing = utils.identify_incomplete_values(values, has_dropout=cs != "cifar10")
    if missing:
        logger.warning("Missing values %s - %s: %s", cs, ds, missing)


def run(case_studies=("mnist", "fmnist", "cifar10", "imdb"), plot: bool = False
        ) -> Dict[str, np.ndarray]:
    """Pool the APFD values of ``case_studies`` and write the two CSVs;
    returns the p, effect-size and sample-count grids. The heatmap
    (``plot``) is not ported."""
    if plot:
        raise NotImplementedError("the heatmap needs matplotlib and seaborn, which the port "
                                  "does not use; the CSVs hold its numbers")
    pooled: Dict[str, Dict[str, float]] = {a: {} for a in utils.APPROACHES}
    for cs in case_studies:
        for ds in ("nominal", "ood"):
            values = load_apfd_values(cs, ds)
            _warn_missing(cs, ds, values)
            named = utils.named_tuples(cs, values, None, utils.APPROACHES)
            for approach, samples in named.items():
                pooled[approach].update(samples)
    return pooled_statistics(pooled, utils.APPROACHES, "apfd_correlation")


if __name__ == "__main__":
    run()
