"""The filesystem artifact bus (own copy of the JAX package's naming contract).

The root is ``TIP_ASSETS`` (default ``./assets``), exactly as in the JAX
package, so the plotters read the port's artifacts unchanged:

- ``priorities/{cs}_{ds}_{model}_{type}.npy``   scores / orders / masks
- ``times/{cs}_{ds}_{model}_{metric}``          pickled [setup, pred, quant, cam]

Raw datasets are read from ``TIP_DATA_DIR`` (default ``./datasets``), the
JAX package's folder, so both packages read and write the same caches.
"""

import os


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
