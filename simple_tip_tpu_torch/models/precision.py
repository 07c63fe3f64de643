"""The compute dtype of a module, as flax's ``dtype=`` argument gives it.

The JAX package's models take ``compute_dtype`` (``None`` or bfloat16).
In bfloat16 the parameters stay float32 and are cast at each use; the
input is cast once; each convolution, dense layer and embedding returns
bfloat16, its bias added in bfloat16 after the product's rounding (flax's
``promote_dtype`` then ``y + bias``); layer norms take their statistics in
float32 and return bfloat16; taps are cast to float32 and the softmax runs
on float32 logits. With ``None`` every helper is the float32 layer call
itself.
"""

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

DtypeLike = Optional[Union[str, torch.dtype]]
_NAMES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16, "float32": None, "f32": None}


def as_compute_dtype(dtype: DtypeLike) -> Optional[torch.dtype]:
    """None (float32) or ``torch.bfloat16`` from a dtype or its name
    (``config.scoring_compute_dtype``'s values)."""
    if dtype is None or dtype == torch.float32:
        return None
    if isinstance(dtype, str):
        if dtype not in _NAMES:
            raise ValueError(f"unknown compute dtype {dtype!r}; use 'float32' or 'bfloat16'")
        return _NAMES[dtype]
    if dtype != torch.bfloat16:
        raise ValueError(f"unsupported compute dtype {dtype}; use float32 or bfloat16")
    return dtype


def conv2d(conv: nn.Conv2d, x: torch.Tensor, cdt: Optional[torch.dtype]) -> torch.Tensor:
    """``conv(x)``; in ``cdt`` the product of the cast input and kernel,
    then the cast bias added."""
    if cdt is None:
        return conv(x)
    return F.conv2d(x, conv.weight.to(cdt)) + conv.bias.to(cdt)[:, None, None]


def linear(layer: nn.Linear, x: torch.Tensor, cdt: Optional[torch.dtype]) -> torch.Tensor:
    """``layer(x)``; in ``cdt`` the product, then the cast bias added."""
    if cdt is None:
        return layer(x)
    return F.linear(x.to(cdt), layer.weight.to(cdt)) + layer.bias.to(cdt)


def embedding(layer: nn.Embedding, ids: torch.Tensor, cdt: Optional[torch.dtype]) -> torch.Tensor:
    """``layer(ids)``; in ``cdt`` the rows of the cast table."""
    if cdt is None:
        return layer(ids)
    return F.embedding(ids, layer.weight.to(cdt))


def repr_suffix(cdt: Optional[torch.dtype]) -> str:
    """A module's ``extra_repr``: empty in float32, so that float32 reprs
    (which the run programs' fingerprints hash) stay as they were."""
    return "" if cdt is None else f"compute_dtype={cdt}"
