"""Dataset loading for the four case studies (the port's ``data`` package).

Each loader reads cached arrays under ``TIP_DATA_DIR`` (the JAX package's
file names); when a nominal archive is present but its corrupted companion
is not, it generates an MNIST-C / CIFAR-10-C style set with
``image_corruptor`` on the device and caches it; otherwise it falls back to
the deterministic synthetic stand-ins of ``synthetic`` (loudly warned).
"""

from simple_tip_tpu_torch.data.loaders import (
    load_cifar10,
    load_fmnist,
    load_imdb,
    load_mnist,
)

__all__ = ["load_mnist", "load_fmnist", "load_cifar10", "load_imdb"]
