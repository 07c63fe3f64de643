"""Device choice for every entry point of the port.

``device=None`` means the CUDA card and raises when there is none: nothing
falls back to the CPU quietly. ``device="cpu"`` is the only way onto the
CPU (the tests use it); there every kernel wrapper runs its plain PyTorch
version because the tensors it is given lie on the CPU.
"""

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def _exact_f32() -> None:
    """Keep float32 exact on the card.

    cuDNN runs float32 convolutions in TF32 by default (about three decimal
    digits), which flips neuron-coverage threshold bits against the JAX
    reference; matmuls are exact by default but are pinned too, so the
    choice is stated in one place.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve(device: DeviceLike = None) -> torch.device:
    """The torch device for an entry point's ``device`` argument.

    Raises ``RuntimeError`` for ``None`` or a CUDA device when no card is
    visible.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        _exact_f32()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
