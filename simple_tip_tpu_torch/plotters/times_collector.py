"""Reader of the timing artifacts (own copy of the JAX package's
``plotters/times_collector.py``).

One pickle per (case study, dataset, model, approach) under
``<assets>/times/``, holding ``[setup, pred, quant, cam]``. Names are
``{cs}_{ds}_{model}_{metric}[_{param}]``; approach names that contain
underscores are read as their display aliases before the split. Only the
first ten model runs count toward the reported times.
"""

import pickle
from pathlib import Path
from typing import Dict, Optional, Tuple

from simple_tip_tpu_torch.config import output_folder

N_FIRST_MODELS_CONSIDERED = 10

# longest first, so "softmax_entropy" never half-matches as "softmax"
_ALIASES = (
    ("softmax_entropy", "SE"),
    ("deep_gini", "DeepGini"),
    ("softmax", "SM"),
    ("pcs", "PCS"),
)

TimesKey = Tuple[str, str, str, str, str]


def _parse_name(name: str) -> Optional[TimesKey]:
    """``{cs}_{ds}_{model}_{metric}[_{param}]`` -> 5-tuple key, or None."""
    for needle, alias in _ALIASES:
        name = name.replace(needle, alias)
    fields = name.split("_")
    if len(fields) == 4:
        fields.append("")  # approaches without a parameter
    if len(fields) != 5:
        return None
    return tuple(fields)


def load_times() -> Dict[TimesKey, list]:
    """Every timing record on the bus, keyed (cs, ds, model, metric, param)."""
    times: Dict[TimesKey, list] = {}
    folder = Path(output_folder()) / "times"
    if not folder.is_dir():
        return times
    for path in sorted(p for p in folder.rglob("*") if p.is_file()):
        key = _parse_name(path.name)
        if key is None or int(key[2]) >= N_FIRST_MODELS_CONSIDERED:
            continue
        times[key] = pickle.loads(path.read_bytes())
    return times
