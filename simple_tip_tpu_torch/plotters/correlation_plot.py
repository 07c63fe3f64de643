"""Pairwise Wilcoxon p-values and Vargha-Delaney effect sizes (the numbers
behind the paper's Figs 3 and 4), with scipy and without pandas.

Own copy of the JAX package's ``plotters/correlation_plot.py`` without its
heatmap figure (matplotlib and seaborn are not ported): grids are
[approach x approach] with only the upper triangle tested; untested cells
hold sentinels (10000 for p, -10000 for the effect size, -1000 for the
sample count), which the CSV writer blanks. A pair is compared on its
common sample ids; a pair without any, or with equal value lists, is NaN.
``pooled_statistics`` writes ``results/{prefix}_{p,eff}.csv`` with the
human approach labels, byte for byte as the JAX package's
``DataFrame.to_csv`` writes them.
"""

import csv
import os
from itertools import combinations
from math import comb
from typing import Dict, Hashable, List, Sequence, Tuple

import numpy as np
from scipy import stats

from simple_tip_tpu_torch.config import subdir
from simple_tip_tpu_torch.plotters.utils import human_approach_names

P_UNTESTED = 10_000.0
E_UNTESTED = -10_000.0
N_UNTESTED = -1_000


def paired_vargha_delaney_a12(x: List[float], y: List[float], paired: bool = True) -> float:
    """Scaled paired A12 effect size, ``2 * |A12 - 0.5|`` in [0, 1]."""
    assert len(x) == len(y)
    x, y = np.array(x), np.array(y)
    if not paired:
        y = np.expand_dims(y, axis=1)
    wins = np.sum(x > y) + 0.5 * np.sum(x == y)
    return 2 * abs(wins / (x == y).size - 0.5)


def wilcoxon_p(x: List[float], y: List[float]) -> float:
    """Two-sided Wilcoxon signed-rank p-value (NaN where scipy refuses)."""
    try:
        return float(stats.wilcoxon(np.asarray(x), np.asarray(y), alternative="two-sided").pvalue)
    except ValueError:
        return np.nan


class WilcoxonCorrelationPlot:
    """Pairwise significance grid over pooled per-run measurements,
    Bonferroni factor C(``num_tested_approaches``, 2)."""

    def __init__(self, approaches: Sequence[str], num_tested_approaches: int):
        assert len(set(approaches)) == len(approaches), "Approach names must be unique"
        self.approaches = list(approaches)
        self.bonferroni_factor = comb(num_tested_approaches, 2)
        self._samples: Dict[str, Dict[Hashable, float]] = {a: {} for a in self.approaches}

    def add_measurement(self, approach, sample, value, unique: bool = True) -> None:
        """Register one observation; approaches outside the grid are ignored."""
        pool = self._samples.get(approach)
        if pool is None:
            return
        if unique and sample in pool:
            raise AssertionError(
                f"Sample key name must be unique for a given array. Duplicate: "
                f"{sample}. Pass `unique=False` to overwrite value."
            )
        pool[sample] = value

    @property
    def measurements(self) -> Dict[str, Dict[Hashable, float]]:
        return self._samples

    def _paired(self, a: str, b: str) -> Tuple[List[float], List[float]]:
        """Both approaches' values on their shared sample ids, sorted."""
        pool_a, pool_b = self._samples[a], self._samples[b]
        shared = sorted(pool_a.keys() & pool_b.keys())
        return [pool_a[k] for k in shared], [pool_b[k] for k in shared]

    def calc_values(self) -> Dict[str, np.ndarray]:
        """Upper-triangle p, effect-size and sample-count grids."""
        n = len(self.approaches)
        grids = {
            "p": np.full((n, n), P_UNTESTED, dtype=np.float64),
            "e": np.full((n, n), E_UNTESTED, dtype=np.float64),
            "num_samples": np.full((n, n), N_UNTESTED, dtype=np.int64),
        }
        for i, j in combinations(range(n), 2):
            vals_i, vals_j = self._paired(self.approaches[i], self.approaches[j])
            grids["num_samples"][i, j] = len(vals_i)
            if not vals_i or vals_i == vals_j:
                grids["p"][i, j] = grids["e"][i, j] = np.nan
            else:
                grids["p"][i, j] = wilcoxon_p(vals_i, vals_j)
                grids["e"][i, j] = paired_vargha_delaney_a12(vals_i, vals_j)
        return grids


def _cell(value: float, sentinel: float) -> str:
    """A grid cell as pandas writes it: blank for the sentinel and NaN,
    else the float's repr."""
    if value == sentinel or np.isnan(value):
        return ""
    return repr(float(value))


def write_grid_csv(path: str, grid: np.ndarray, labels: Sequence[str], sentinel: float) -> None:
    """``grid`` with ``labels`` on both axes, as pandas' ``to_csv`` of the
    frame with the sentinel replaced by an empty string."""
    with open(path, "w", newline="") as f:
        out = csv.writer(f, lineterminator="\n")
        out.writerow(["", *labels])
        for label, row in zip(labels, grid):
            out.writerow([label, *(_cell(v, sentinel) for v in row)])


def pooled_statistics(
    pooled: Dict[str, Dict[Hashable, float]], full_approaches: Sequence[str], csv_prefix: str
) -> Dict[str, np.ndarray]:
    """The full grid's statistics over the pooled samples, written as
    ``results/{csv_prefix}_{p,eff}.csv``; returns the grids."""
    grid = WilcoxonCorrelationPlot(approaches=list(full_approaches), num_tested_approaches=39)
    for approach, samples in pooled.items():
        for sample, value in samples.items():
            grid.add_measurement(approach, sample, value)
    grids = grid.calc_values()
    labels = human_approach_names(list(full_approaches))
    for key, sentinel, suffix in (("p", P_UNTESTED, "p"), ("e", E_UNTESTED, "eff")):
        write_grid_csv(os.path.join(subdir("results"), f"{csv_prefix}_{suffix}.csv"),
                       grids[key], labels, sentinel)
    return grids
