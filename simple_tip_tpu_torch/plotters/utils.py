"""The approach vocabulary of the result tables (own copy of the JAX
package's ``plotters/utils.py`` canon): all 39 tested approaches in the
published row order, the paper tables' and the correlation figures'
subsets, the category and the printed name of each, the LaTeX helper that
rotates the category cells; the reader of the artifact bus's pickles by
file-name pattern, and the pooling of per-run values for the statistics."""

import logging
import pickle
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from simple_tip_tpu_torch.config import output_folder

logger = logging.getLogger(__name__)

NUM_RUNS = 100

VERTI_DEF = (
    "\\newcommand{\\verti}[1]{\\begin{tabular}{@{}c@{}}"
    "\\rotatebox[origin=c]{90}{\\centering #1}\\end{tabular}}"
)

_NC_GRID = (
    ("NAC", "0.75"),
    ("NAC", "0"),
    ("NBC", "0.5"),
    ("NBC", "0"),
    ("NBC", "1"),
    ("SNAC", "0.5"),
    ("SNAC", "0"),
    ("SNAC", "1"),
    ("TKNC", "1"),
    ("TKNC", "2"),
    ("TKNC", "3"),
    ("KMNC", "2"),
)
_SA_NAMES = ("dsa", "pc-lsa", "pc-mdsa", "pc-mlsa", "pc-mmdsa")
_UNCERTAINTY = ("deep_gini", "softmax", "pcs", "softmax_entropy", "VR")

# Every scored approach as its CAM form first, then its plain form; the
# uncertainty quantifiers have no CAM form.
APPROACHES = [
    name
    for stem in [f"{m}_{p}" for m, p in _NC_GRID] + list(_SA_NAMES)
    for name in (f"{stem}-cam", stem)
] + list(_UNCERTAINTY)

# The subset shown in the paper tables.
PAPER_APPROACHES = [
    "NAC_0.75-cam",
    "NAC_0.75",
    "NBC_0-cam",
    "NBC_0",
    "SNAC_0-cam",
    "SNAC_0",
    "TKNC_1-cam",
    "KMNC_2",
    "dsa",
    "pc-lsa",
    "pc-mdsa",
    "pc-mlsa",
    "pc-mmdsa",
    "deep_gini",
    "softmax",
    "pcs",
    "softmax_entropy",
    "VR",
]

# The subset of the correlation figures.
CORRELATION_PLOT_APPROACHES = [
    "SNAC_0",
    "SNAC_0-cam",
    "NBC_0-cam",
    "dsa",
    "pc-mdsa",
    "pc-mlsa",
    "deep_gini",
    "softmax",
    "softmax_entropy",
]

_NC_PREFIXES = tuple(dict.fromkeys(m for m, _ in _NC_GRID))
_CATEGORIES = ("uncertainty", "surprise", "baseline", "neuron coverage")

# Printed names that the upper-case rule does not give.
_PAPER_NAME_OF = {
    "softmax_entropy": "Entropy",
    "VR": "MC-Dropout",
    "softmax": "Vanilla SM",
    "deep_gini": "DeepGini",
}


def human_approach_name(approach: str) -> str:
    """The name the paper tables print for an approach (a category passes
    through unchanged)."""
    special = _PAPER_NAME_OF.get(approach)
    if special is not None:
        return special
    if approach in _CATEGORIES:
        return approach
    return approach.replace("_", "-").upper()


def human_approach_names(approaches: List[str]) -> List[str]:
    return [human_approach_name(a) for a in approaches]


def category(approach: str) -> Optional[str]:
    """TIP category of an approach name (None for unknown names)."""
    if approach in _UNCERTAINTY:
        return "uncertainty"
    base = approach[:-4] if approach.endswith("-cam") else approach
    if base in _SA_NAMES:
        return "surprise"
    if approach in ("original", "random"):
        return "baseline"
    if approach.startswith(_NC_PREFIXES):
        return "neuron coverage"
    return None


def _row(approach: str) -> Tuple[Optional[str], str]:
    """(category, approach): the two-level row key of the tables."""
    return category(approach), approach


def vertical_categories(latex: str) -> str:
    """Rotate the first cell of each category in a LaTeX table."""
    out = VERTI_DEF + latex
    for cat in _CATEGORIES:
        out = out.replace(cat, "\\verti{" + cat + "}", 1)
    return out


def _header_cells(columns: Sequence[Tuple[str, ...]], level: int) -> List[str]:
    """One header row of a LaTeX table: each run of columns that agree on
    their first ``level + 1`` keys is one cell, centred over the run."""
    cells, start = [], 0
    for end in range(1, len(columns) + 1):
        if end == len(columns) or columns[end][: level + 1] != columns[start][: level + 1]:
            name, span = columns[start][level], end - start
            cells.append(name if span == 1 else f"\\multicolumn{{{span}}}{{c}}{{{name}}}")
            start = end
    return cells


def paper_latex_table(
    rows: Sequence[Tuple[str, str]],
    columns: Sequence[Tuple[str, ...]],
    text: Dict[Tuple[Tuple[str, str], Tuple[str, ...]], str],
    column_format: str,
) -> str:
    """A paper table in LaTeX, as the JAX package writes it: pandas'
    ``to_latex(multicolumn_format="c", multirow=True)`` of the frame with
    the rows ``(category, approach)`` (their printed names) and the column
    keys ``columns``, ``text[row, column]`` each cell's text; then the
    category cells rotated (``vertical_categories``) and the header
    "category" removed."""
    lines = [f"\\begin{{tabular}}{{{column_format}}}", "\\toprule"]
    for level in range(len(columns[0])):
        lines.append(" & ".join(["", "", *_header_cells(columns, level)]) + " \\\\")
    lines.append(" & ".join(["category", "approach", *[""] * len(columns)]) + " \\\\")
    lines.append("\\midrule")
    start = 0
    for end in range(1, len(rows) + 1):
        if end < len(rows) and rows[end][0] == rows[start][0]:
            continue
        for i in range(start, end):
            first = (f"\\multirow[t]{{{end - start}}}{{*}}{{{rows[i][0]}}}"
                     if i == start else "")
            cells = [text[rows[i], c] for c in columns]
            lines.append(" & ".join([first, rows[i][1], *cells]) + " \\\\")
        lines.append(f"\\cline{{1-{2 + len(columns)}}}")
        start = end
    lines += ["\\bottomrule", "\\end{tabular}", ""]
    return vertical_categories("\n".join(lines)).replace("category", "", 1)


def load_all_for_regex(research_question: str, regex: re.Pattern, with_names: bool = False):
    """The unpickled contents of every artifact in the bus subfolder
    ``research_question`` whose name ``regex`` matches at its start, sorted
    by path, as the JAX package's reader returns them (it also memoizes
    them and loads ``.npy`` files as arrays; no reader of the port needs
    either); with ``with_names``, ``(contents, file names)``."""
    folder = Path(output_folder()) / research_question
    hits = (sorted(p for p in folder.rglob("*") if p.is_file() and regex.match(p.name, pos=0))
            if folder.is_dir() else [])
    contents = [pickle.loads(p.read_bytes()) for p in hits]
    return (contents, [p.name for p in hits]) if with_names else contents


def identify_incomplete_values(data: Dict[str, Dict[int, float]], has_dropout: bool) -> Set[int]:
    """Run ids below ``NUM_RUNS`` that lack an approach's value (VR is not
    expected without dropout)."""
    return {
        run
        for approach, runs in data.items()
        if approach != "VR" or has_dropout
        for run in range(NUM_RUNS)
        if run not in runs
    }


def named_tuples(
    cs_data_id: str,
    data: Dict[str, Dict[int, float]],
    collection: Optional[Dict[str, Dict[str, float]]],
    approaches: List[str],
) -> Dict[str, Dict[str, float]]:
    """Pool per-run values under the sample ids ``{cs_data_id}_{run}``, into
    ``collection`` (a new one per approach when None); a sample id already
    pooled keeps its value, with a warning."""
    if collection is None:
        collection = {approach: {} for approach in approaches}
    else:
        missing = [a for a in approaches if a not in collection]
        assert not missing, f"collection lacks approaches {missing}"
    for approach, runs in data.items():
        pooled = collection.get(approach)
        if pooled is None:
            continue
        for run_id, value in runs.items():
            sample_id = f"{cs_data_id}_{run_id}"
            if sample_id in pooled:
                logger.warning("%s: run %s already pooled", cs_data_id, sample_id)
            else:
                pooled[sample_id] = value
    return collection
