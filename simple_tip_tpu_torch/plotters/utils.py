"""The approach vocabulary of the result tables (own copy of the JAX
package's ``plotters/utils.py`` canon): all 39 tested approaches in the
published row order, and the category of each; and the reader of the
artifact bus's pickles by file-name pattern."""

import pickle
import re
from pathlib import Path
from typing import List, Optional, Tuple

from simple_tip_tpu_torch.config import output_folder

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

_NC_PREFIXES = tuple(dict.fromkeys(m for m, _ in _NC_GRID))


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


def load_all_for_regex(research_question: str, regex: re.Pattern) -> List:
    """The unpickled contents of every artifact in the bus subfolder
    ``research_question`` whose name ``regex`` matches at its start, sorted
    by path, as the JAX package's reader returns them (it also memoizes
    them and loads ``.npy`` files as arrays; no reader of the port needs
    either)."""
    folder = Path(output_folder()) / research_question
    if not folder.is_dir():
        return []
    hits = sorted(p for p in folder.rglob("*") if p.is_file() and regex.match(p.name, pos=0))
    return [pickle.loads(p.read_bytes()) for p in hits]
