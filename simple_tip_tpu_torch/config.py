"""The filesystem artifact bus (own copy of the JAX package's naming contract).

The root is ``TIP_ASSETS`` (default ``./assets``), exactly as in the JAX
package, so the plotters read the port's artifacts unchanged:

- ``priorities/{cs}_{ds}_{model}_{type}.npy``   scores / orders / masks
- ``times/{cs}_{ds}_{model}_{metric}``          pickled [setup, pred, quant, cam]

Raw datasets are read from ``TIP_DATA_DIR`` (default ``./datasets``), the
JAX package's folder, so both packages read and write the same caches.

``scoring_compute_dtype`` reads ``TIP_COMPUTE_DTYPE``, the JAX package's
knob for the scoring forwards' compute dtype.
"""

import os
from typing import Optional


def output_folder() -> str:
    """Root of the filesystem artifact bus."""
    return os.environ.get("TIP_ASSETS", os.path.join(os.getcwd(), "assets"))


def data_folder() -> str:
    """Directory with raw dataset files (npy/npz caches)."""
    return os.environ.get("TIP_DATA_DIR", os.path.join(os.getcwd(), "datasets"))


def subdir(name: str) -> str:
    """Path of (and ensure) an artifact-bus subdirectory."""
    path = os.path.join(output_folder(), name)
    os.makedirs(path, exist_ok=True)
    return path


def scoring_compute_dtype() -> Optional[str]:
    """Compute dtype of the *scoring* forwards (prioritization and the
    active-learning selection), from ``TIP_COMPUTE_DTYPE``: unset,
    ``float32`` or ``f32`` is float32 (None); ``bfloat16`` or ``bf16`` is
    ``"bfloat16"``; anything else raises ``ValueError``, as in the JAX
    package. Training and ``at_collection`` always run float32. Stdlib
    only: the models turn the name into a torch dtype.
    """
    value = os.environ.get("TIP_COMPUTE_DTYPE", "").strip().lower()
    if value in ("", "float32", "f32"):
        return None
    if value in ("bfloat16", "bf16"):
        return "bfloat16"
    raise ValueError(
        f"TIP_COMPUTE_DTYPE={value!r} not understood; use 'float32' or 'bfloat16'"
    )
