"""The filesystem artifact bus (own copy of the JAX package's naming contract).

The root is ``TIP_ASSETS`` (default ``./assets``), exactly as in the JAX
package, so the plotters read the port's artifacts unchanged:

- ``priorities/{cs}_{ds}_{model}_{type}.npy``   scores / orders / masks
- ``times/{cs}_{ds}_{model}_{metric}``          pickled [setup, pred, quant, cam]
"""

import os


def output_folder() -> str:
    """Root of the filesystem artifact bus."""
    return os.environ.get("TIP_ASSETS", os.path.join(os.getcwd(), "assets"))


def subdir(name: str) -> str:
    """Path of (and ensure) an artifact-bus subdirectory."""
    path = os.path.join(output_folder(), name)
    os.makedirs(path, exist_ok=True)
    return path
