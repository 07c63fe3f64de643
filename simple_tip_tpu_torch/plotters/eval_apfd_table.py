"""The APFD table (the paper's Table 1), without pandas.

Own copy of the JAX package's ``plotters/eval_apfd_table.py``: it reads the
``priorities/`` artifacts (the masks ``{cs}_{ds}_{run}_is_misclassified``,
the scores ``..._{approach}_scores`` and the CAM orders
``..._{approach}_cam_order``), orders each (approach, run) by descending
score or takes its CAM order as written, scores APFD, averages the first 100
runs, adds the reported times of the first ten runs, and writes
``results/apfds.csv``. The table is a dict ``{(category, approach): {(cs,
column): value}}`` with the columns ``nominal``, ``ood`` (mean APFD, or
"n.a.") and ``time`` (a string such as "12s", or None). The JAX package's
paper-subset LaTeX table is not ported.
"""

import csv
import os
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from simple_tip_tpu_torch.config import output_folder, subdir
from simple_tip_tpu_torch.ops.apfd import apfd_from_order
from simple_tip_tpu_torch.plotters import times_collector
from simple_tip_tpu_torch.plotters.utils import APPROACHES, _row

TIME_COL = "time"
COLUMNS = ("nominal", "ood", TIME_COL)

FIRST_K_MODELS_CONSIDERED = 100

_MASK_SUFFIX = "is_misclassified"
_SCORE_SUFFIX = "_scores"
_CAM_SUFFIX = "_cam_order"

Row = Tuple[Optional[str], str]
Table = Dict[Row, Dict[Tuple[str, str], object]]


def _parse_artifact(stem: str) -> Optional[Tuple[str, Optional[str]]]:
    """``{run}_{rest}`` -> (run id, approach), the approach None for the mask."""
    run_id, _, rest = stem.partition("_")
    if not run_id.isdigit():
        return None
    if rest == _MASK_SUFFIX:
        return run_id, None
    if rest.endswith(_CAM_SUFFIX):
        return run_id, rest[: -len(_CAM_SUFFIX)] + "-cam"
    if rest.endswith(_SCORE_SUFFIX):
        return run_id, rest[: -len(_SCORE_SUFFIX)]
    if rest.startswith("uncertainty_"):
        return run_id, rest[len("uncertainty_"):]
    return None


def load_apfd_values(case_study: str, ds_name: str) -> Dict[str, Dict[int, float]]:
    """``{approach: {run: apfd}}`` for one (case study, dataset)."""
    folder = Path(output_folder()) / "priorities"
    prefix = f"{case_study}_{ds_name}_"
    masks: Dict[int, np.ndarray] = {}
    orders: Dict[Tuple[str, int], np.ndarray] = {}
    if folder.is_dir():
        for path in sorted(folder.rglob("*.npy")):
            if not path.name.startswith(prefix):
                continue
            parsed = _parse_artifact(path.name[len(prefix):-len(".npy")])
            if parsed is None:
                continue
            run_id, approach = parsed
            run = int(run_id)
            if run >= FIRST_K_MODELS_CONSIDERED:
                continue
            arr = np.load(path)
            if approach is None:
                masks[run] = arr
            elif approach.endswith("-cam"):
                orders[approach, run] = arr
            else:
                orders[approach, run] = np.argsort(-arr)
    apfds: Dict[str, Dict[int, float]] = {}
    for (approach, run), order in orders.items():
        if approach not in APPROACHES or run not in masks:
            continue
        apfds.setdefault(approach, {})[run] = apfd_from_order(masks[run], order)
    return apfds


def apfd_table(case_studies: Sequence[str]) -> Table:
    """Run-averaged APFD per (approach, case study, dataset), "n.a." where
    no run has the approach; every time cell None."""
    table: Table = {_row(a): {} for a in APPROACHES}
    for cs in case_studies:
        for ds in ("nominal", "ood"):
            per_approach = load_apfd_values(cs, ds)
            for row, cells in table.items():
                runs = per_approach.get(row[1])
                cells[cs, ds] = float(np.mean(list(runs.values()))) if runs else "n.a."
            for cells in table.values():
                cells.setdefault((cs, TIME_COL), None)
    return table


# Reverse of times_collector's filename aliases.
_METRIC_OF_ALIAS = {"SM": "softmax", "SE": "softmax_entropy", "PCS": "pcs", "DeepGini": "deep_gini"}


def add_reported_times(table: Table, times: Dict) -> None:
    """Fill the time cells from the first-10-runs records: setup + 2*(pred +
    quant), both datasets sharing one setup, plus 2*cam for the -cam form of
    a scored approach."""
    if not times:
        return
    assert all(
        int(run) < times_collector.N_FIRST_MODELS_CONSIDERED for _, _, run, _, _ in times
    ), "Should only consider first 10 runs"
    pooled = defaultdict(list)
    for (cs, _ds, _run, metric, param), record in times.items():
        stages = (list(record) + [0.0] * 4)[:4]  # uncertainty records have no cam
        pooled[cs, metric, param].append(stages)
    case_studies = {cs for cells in table.values() for cs, col in cells if col == TIME_COL}
    for (cs, metric, param), records in pooled.items():
        if cs not in case_studies:
            continue
        setup_s, pred_s, quant_s, cam_s = np.mean(records, axis=0)
        base = _METRIC_OF_ALIAS.get(metric, metric)
        row = _row(base + (f"_{param}" if param else ""))
        if row[0] is None:
            continue
        plain_s = setup_s + 2 * (pred_s + quant_s)
        if row in table:
            table[row][cs, TIME_COL] = f"{round(plain_s)}s"
        cam_row = (row[0], f"{row[1]}-cam")
        if row[0] in ("surprise", "neuron coverage") and cam_row in table:
            table[cam_row][cs, TIME_COL] = f"{round(plain_s + 2 * cam_s)}s"


def write_csv(table: Table, case_studies: Sequence[str], path: str) -> None:
    """The table as CSV: two header rows (case study, column), then one row
    per approach; an empty cell for a time never recorded."""
    with open(path, "w", newline="") as f:
        out = csv.writer(f)
        out.writerow(["", ""] + [cs for cs in case_studies for _ in COLUMNS])
        out.writerow(["category", "approach"] + [c for _ in case_studies for c in COLUMNS])
        for (cat, approach), cells in table.items():
            values = [cells[cs, c] for cs in case_studies for c in COLUMNS]
            out.writerow([cat, approach] + ["" if v is None else v for v in values])


def run(case_studies: List[str] = ("mnist", "fmnist", "cifar10", "imdb")) -> Table:
    """Build the table from the bus and write ``results/apfds.csv``."""
    table = apfd_table(list(case_studies))
    add_reported_times(table, times_collector.load_times())
    write_csv(table, list(case_studies), os.path.join(subdir("results"), "apfds.csv"))
    return table


if __name__ == "__main__":
    run()
