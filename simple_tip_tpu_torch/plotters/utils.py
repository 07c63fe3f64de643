"""The approach vocabulary of the result tables (own copy of the JAX
package's ``plotters/utils.py`` canon): all 39 tested approaches in the
published row order, and the category of each."""

from typing import Optional, Tuple

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
