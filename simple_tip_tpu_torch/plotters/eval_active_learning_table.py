"""The active-learning table (the paper's Table 2), without pandas.

Own copy of the JAX package's ``plotters/eval_active_learning_table.py``:
it reads the ``active_learning/`` pickles
(``{cs}_{run}_{approach}_{observed split}.pickle``, each the four-split
accuracy dict), averages each approach over its runs, and reports the
``original`` model and the ``random`` baseline as accuracies and every
other approach as its gain over ``random``, formatted ``{:.2%}``; an
approach with no results is "n.a." (and warned about, but for VR on
cifar10, which has no dropout). ``run`` writes ``results/active.csv`` with
the rows and columns of the JAX package's ``build_data_frame``. The table
is a dict ``{(category, approach): {(cs, observed split, "split:part"):
cell}}``, a cell None where the JAX frame holds NaN. ``run`` also writes the paper
subset's future-split columns as ``results/active_paper_table.tex`` (the JAX
package's pandas ``to_latex``, rendered by hand).
"""

import csv
import os
import re
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

from simple_tip_tpu_torch.config import subdir
from simple_tip_tpu_torch.plotters.utils import (
    APPROACHES,
    PAPER_APPROACHES,
    _row,
    human_approach_name,
    load_all_for_regex,
    paper_latex_table,
)

BASELINE = "random"
RANDOM = "random"

SPLITS = ("nominal:observed", "nominal:future", "ood:observed", "ood:future")
OBSERVED = ("nominal", "ood")
ROWS = ("original", "random", *APPROACHES)

Accuracies = Dict[Tuple[str, str], float]
Row = Tuple[Optional[str], str]
Table = Dict[Row, Dict[Tuple[str, str, str], Optional[str]]]


def _load_approach(case_study: str, approach: str, ds_name: str):
    """(accuracy dicts, run ids) of one approach's AL pickles, one per run."""
    pattern = re.compile(f"{re.escape(case_study)}_\\d*_{re.escape(approach)}_{ds_name}\\.")
    values, names = load_all_for_regex("active_learning", pattern, with_names=True)
    return values, [int(name.split("_")[1]) for name in names]


def load_arrays_active_learning(case_study: str, ds_name: str, by_id: bool = False) -> Dict:
    """Per approach, the runs' AL results for one (case study, observed
    split), the ``random`` baseline and the ``original`` model (whose
    pickles carry the split 'na') included: a list, or with ``by_id`` a
    dict by run id."""
    res = {}
    for entry in [*APPROACHES, RANDOM, ("original", "na")]:
        approach, split = entry if isinstance(entry, tuple) else (entry, ds_name)
        values, run_ids = _load_approach(case_study, approach, split)
        res[approach] = dict(zip(run_ids, values)) if by_id else values
    return res


def _reduce_active_learning(cs: str, active_learning_files) -> Dict[str, Accuracies]:
    """Run-average each approach's per-split accuracies."""
    reduced = {}
    for approach, runs in active_learning_files.items():
        if not runs:
            if approach != "VR" or cs != "cifar10":
                warnings.warn(f"missing AL results for {approach} on {cs}")
            continue
        splits = runs[0].keys()
        assert all(r.keys() == splits for r in runs[1:]), approach
        reduced[approach] = {split: sum(r[split] for r in runs) / len(runs) for split in splits}
    return reduced


def _relative_active_learning_gains(reduced, baseline: str) -> Dict[str, Accuracies]:
    """Accuracy delta against the baseline selection, per approach and split."""
    assert baseline in ("random", "original") and baseline in reduced
    base = reduced[baseline]
    return {
        approach: {split: acc - base[split] for split, acc in performance.items()}
        for approach, performance in reduced.items()
        if approach != baseline
    }


def _forma(x: float) -> str:
    return "{:.2%}".format(x)


def columns(case_studies: Sequence[str]) -> List[Tuple[str, str, str]]:
    """(case study, observed split, "split:part") in the table's order."""
    return [(cs, obs, split) for cs in case_studies for obs in OBSERVED for split in SPLITS]


def active_learning_table(case_studies: Sequence[str]) -> Table:
    """The run-averaged AL results: accuracies for ``original`` and
    ``random``, gains over ``random`` for the rest ("n.a." where an
    approach has no results); a case study's observed split without a
    ``random`` baseline stays empty (None)."""
    table: Table = {_row(r): dict.fromkeys(columns(case_studies)) for r in ROWS}
    for cs in case_studies:
        for obs in OBSERVED:
            reduced = _reduce_active_learning(cs, load_arrays_active_learning(cs, obs))
            if BASELINE not in reduced:
                continue
            gains = _relative_active_learning_gains(reduced, BASELINE)
            for approach in ("original", "random"):
                for split, acc in reduced.get(approach, {}).items():
                    table[_row(approach)][cs, obs, f"{split[0]}:{split[1]}"] = _forma(acc)
            for approach in APPROACHES:
                per_split = gains.get(approach)
                if per_split is None:
                    for split in SPLITS:
                        table[_row(approach)][cs, obs, split] = "n.a."
                else:
                    for split, delta in per_split.items():
                        table[_row(approach)][cs, obs, f"{split[0]}:{split[1]}"] = _forma(delta)
    return table


def write_csv(table: Table, case_studies: Sequence[str], path: str) -> None:
    """The table as pandas writes the JAX frame: one header row per column
    level, a row of the index names, then one row per approach; an empty
    cell for None."""
    cols = columns(case_studies)
    with open(path, "w", newline="") as f:
        out = csv.writer(f, lineterminator="\n")
        for level in range(3):
            out.writerow(["", ""] + [c[level] for c in cols])
        out.writerow(["category", "approach"] + [""] * len(cols))
        for (cat, approach), cells in table.items():
            values = [cells[c] for c in cols]
            out.writerow(["" if cat is None else cat, approach]
                         + ["" if v is None else v for v in values])


def write_latex(table: Table, case_studies: Sequence[str], path: str) -> None:
    """The paper subset (its approaches, ``original`` and ``random``) on the
    future-split columns of each observed split, as LaTeX (``latex_table``
    of the JAX package, byte for byte)."""
    keep = [*PAPER_APPROACHES, "original", "random"]
    paper_columns = [c for c in columns(case_studies)
                     if c[2].startswith(c[1]) and c[2].endswith("future")]
    rows = [row for row in table if row[1] in keep]
    named = {row: (human_approach_name(row[0]), human_approach_name(row[1])) for row in rows}
    text = {(named[row], c): "NaN" if table[row][c] is None else table[row][c]
            for row in rows for c in paper_columns}
    with open(path, "w") as f:
        f.write(paper_latex_table([named[r] for r in rows], paper_columns, text, "llcccccccc"))


def run(case_studies: List[str] = ("mnist", "fmnist", "cifar10", "imdb")) -> Table:
    """Build the table from the bus and write ``results/active.csv`` and
    ``results/active_paper_table.tex``."""
    table = active_learning_table(list(case_studies))
    write_csv(table, list(case_studies), os.path.join(subdir("results"), "active.csv"))
    write_latex(table, list(case_studies), os.path.join(subdir("results"),
                                                        "active_paper_table.tex"))
    return table


if __name__ == "__main__":
    run()
