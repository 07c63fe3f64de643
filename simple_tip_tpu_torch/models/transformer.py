"""The IMDB sentiment transformer of the JAX package's ``models/transformer.py``.

token + position embedding (vocab 2000, maxlen 100, dim 32) ->
TransformerBlock (self-attention, 2 heads of dim 32, FFN 32, dropout 0.1,
post-LN) -> mean over the sequence -> Dropout 0.1 -> Dense 20 relu ->
Dropout 0.1 -> Dense 2 softmax. Inputs are int64 token ids ``[B, T]``; taps
1-7 follow the Keras layer numbering (1 embedding, 2 block output, 3 pooled,
4 pooled after dropout, 5 dense 20, 6 after dropout, 7 probabilities).

The attention core is ``ops/flash_attention.flash_attention``, a
``torch.autograd.Function``: kernel B4 forward and kernels B5/B6 backward
on the card, their plain versions on the CPU. It is the one core on one
rank: the JAX package's dense core (``nn.MultiHeadDotProductAttention``)
computes the same function, scaling q by 1/sqrt(dh) before the product
where the flash core scales the scores after it, which agrees to float32
rounding. ``attention_impl`` is the JAX switch: ``"dense"`` and
``"flash"`` run the flash core; ``"ring"`` and ``"ulysses"`` with
``sp_group`` (a ``torch.distributed`` group) run that sequence-parallel
core over the group's ranks (``parallel/ring_attention.py``,
``parallel/ulysses_attention.py``; B4-B6 on every rank's shard), and
without a group the flash core. Outside the core every rank computes on
the full, replicated batch, and the core's autograd gives every rank the
full gradients. As in the JAX package, ``"flash"`` with a group, ulysses
with heads not divisible by the ranks and a sequence not divisible by
them raise ``ValueError``; ``"dense"`` ignores a group. Every parameter
tree of the JAX model (dense, flash, ring, ulysses) bridges to this module.
Layer norms follow flax's ``LayerNorm(epsilon=1e-6)``: variance as
E[x^2] - E[x]^2.

Dropout is active only with ``train=True`` and draws from an explicit
``torch.Generator``; ``vote_prefix``/``vote_probs`` split a stochastic
forward at the first dropout site (after the attention output), so the
deterministic prefix can run once for many samples.

``compute_dtype="bfloat16"`` is the JAX model's bf16 scoring mode
(``models/precision.py``): embeddings, projections, the FFN and the dense
head in bfloat16 with biases added in bfloat16; q, k and v reach the flash
core in bfloat16 (B4's bf16 forward), as the JAX flash core gets them; the
layer norms take float32 statistics and return bfloat16; the mean over the
sequence sums in float32 and returns bfloat16; taps are float32 and the
softmax runs on float32 logits. It runs on one rank: a ring or ulysses
group raises.
"""

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from simple_tip_tpu_torch.models.convnet import dropout
from simple_tip_tpu_torch.models.precision import (
    DtypeLike,
    as_compute_dtype,
    embedding,
    linear,
    repr_suffix,
)
from simple_tip_tpu_torch.ops.flash_attention import flash_attention
from simple_tip_tpu_torch.parallel.ring_attention import ring_attention_sharded
from simple_tip_tpu_torch.parallel.ulysses_attention import ulysses_attention_sharded

ATTENTION_IMPLS = ("dense", "ring", "ulysses", "flash")


class FlaxLayerNorm(nn.Module):
    """Flax ``nn.LayerNorm`` over the last axis (fast-variance form). A
    bfloat16 input is normalised in float32 and returned in bfloat16, as
    flax's ``LayerNorm(dtype=bfloat16)`` does."""

    def __init__(self, dim: int, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.float32:
            return self.forward(x.float()).to(x.dtype)
        mu = x.mean(dim=-1, keepdim=True)
        mu2 = (x * x).mean(dim=-1, keepdim=True)
        var = torch.clamp_min(mu2 - mu * mu, 0.0)
        return (x - mu) * (torch.rsqrt(var + self.epsilon) * self.weight) + self.bias


class TokenAndPositionEmbedding(nn.Module):
    """Token embedding plus learned position embedding (positions ``arange(T)``)."""

    def __init__(self, maxlen: int, vocab_size: int, embed_dim: int,
                 compute_dtype: DtypeLike = None):
        super().__init__()
        self.compute_dtype = as_compute_dtype(compute_dtype)
        self.token = nn.Embedding(vocab_size, embed_dim)
        self.position = nn.Embedding(maxlen, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        positions = torch.arange(x.shape[-1], device=x.device)
        cdt = self.compute_dtype
        return embedding(self.token, x, cdt) + embedding(self.position, positions, cdt)


class SelfAttention(nn.Module):
    """q/k/v projections ``[E -> (H, dh)]``, the attention core of
    ``impl`` (over ``group`` for ring and ulysses), and the output
    projection ``[(H, dh) -> E]``. No padding mask: every token attends to
    every token, token 0 included, as in the reference."""

    def __init__(self, embed_dim: int, num_heads: int, head_dim: int,
                 impl: str = "dense", group=None, compute_dtype: DtypeLike = None):
        super().__init__()
        if impl not in ATTENTION_IMPLS:
            raise ValueError(f"unknown attention_impl {impl!r}; "
                             "use 'dense', 'ring', 'ulysses' or 'flash'")
        if impl == "flash" and group is not None:
            raise ValueError(
                "impl='flash' is the single-device core; combine long sequences "
                "with a group via impl='ring' or 'ulysses' (ulysses uses the flash "
                "kernel as its local core on the card)")
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.impl = impl
        self.group = group if impl in ("ring", "ulysses") else None
        self.compute_dtype = as_compute_dtype(compute_dtype)
        if self.group is not None and self.compute_dtype is not None:
            raise ValueError("the bf16 scoring mode runs the one-rank flash core; "
                             "ring and ulysses groups run float32")
        width = num_heads * head_dim
        self.query = nn.Linear(embed_dim, width)
        self.key = nn.Linear(embed_dim, width)
        self.value = nn.Linear(embed_dim, width)
        self.out = nn.Linear(width, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape

        cdt = self.compute_dtype

        def heads(proj):
            return linear(proj, x, cdt).reshape(b, t, self.num_heads, self.head_dim)

        q, k, v = heads(self.query), heads(self.key), heads(self.value)
        if self.group is None:
            core = flash_attention(q, k, v)
        elif self.impl == "ring":
            core = ring_attention_sharded(q, k, v, self.group)
        else:
            core = ulysses_attention_sharded(q, k, v, self.group)
        return linear(self.out, core.reshape(b, t, -1), cdt)


class TransformerBlock(nn.Module):
    """Post-LN encoder block: x + dropout(attn) -> LN -> FFN relu -> dropout -> LN."""

    def __init__(self, embed_dim: int, num_heads: int, ff_dim: int, rate: float = 0.1,
                 attention_impl: str = "dense", sp_group=None, compute_dtype: DtypeLike = None):
        super().__init__()
        self.rate = rate
        self.compute_dtype = as_compute_dtype(compute_dtype)
        # Keras MultiHeadAttention(key_dim=embed_dim): per-head dim embed_dim.
        self.attention = SelfAttention(embed_dim, num_heads, embed_dim, attention_impl, sp_group,
                                       compute_dtype)
        self.norm1 = FlaxLayerNorm(embed_dim)
        self.ffn1 = nn.Linear(embed_dim, ff_dim)
        self.ffn2 = nn.Linear(ff_dim, embed_dim)
        self.norm2 = FlaxLayerNorm(embed_dim)

    def residual(
        self,
        x: torch.Tensor,
        attn: torch.Tensor,
        train: bool,
        generator: Optional[torch.Generator],
    ) -> torch.Tensor:
        """The block after its attention output ``attn``."""
        if train:
            attn = dropout(attn, self.rate, generator)
        cdt = self.compute_dtype
        out1 = self.norm1(x + attn)
        ffn = linear(self.ffn2, F.relu(linear(self.ffn1, out1, cdt)), cdt)
        if train:
            ffn = dropout(ffn, self.rate, generator)
        return self.norm2(out1 + ffn)


class ImdbTransformer(nn.Module):
    """2-class IMDB sentiment classifier with Keras-index taps 1-7."""

    family = "imdb"
    has_dropout = True
    sa_layers = (5,)
    # The reference's tuple-form NC taps are ignored there; ints 3 and 5 remain.
    nc_layers = (3, 5)
    all_layers = (1, 2, 3, 4, 5, 6, 7)

    def __init__(
        self,
        vocab_size: int = 2000,
        maxlen: int = 100,
        embed_dim: int = 32,
        num_heads: int = 2,
        ff_dim: int = 32,
        num_classes: int = 2,
        dropout_rate: float = 0.1,
        attention_impl: str = "dense",
        sp_group=None,
        compute_dtype: DtypeLike = None,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.dropout_rate = dropout_rate
        self.compute_dtype = as_compute_dtype(compute_dtype)
        self.embedding = TokenAndPositionEmbedding(maxlen, vocab_size, embed_dim, compute_dtype)
        self.block = TransformerBlock(embed_dim, num_heads, ff_dim, dropout_rate,
                                      attention_impl, sp_group, compute_dtype)
        self.dense1 = nn.Linear(embed_dim, 20)
        self.dense2 = nn.Linear(20, num_classes)

    def vote_prefix(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(embedding, attention output): the forward up to the first dropout."""
        emb = self.embedding(x)
        return emb, self.block.attention(emb)

    def suffix(
        self,
        prefix: Tuple[torch.Tensor, torch.Tensor],
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Dict[int, torch.Tensor]]:
        """``(probs, taps)`` from ``vote_prefix``'s output."""
        if train and generator is None:
            raise ValueError("train=True needs an explicit torch.Generator")
        cdt = self.compute_dtype
        emb, attn = prefix
        taps: Dict[int, torch.Tensor] = {1: emb.float()}
        h = self.block.residual(emb, attn, train, generator)
        taps[2] = h.float()
        # jnp.mean sums a bfloat16 array in float32 and returns bfloat16
        h = h.mean(dim=1) if cdt is None else h.float().mean(dim=1).to(cdt)
        taps[3] = h.float()
        if train:
            h = dropout(h, self.dropout_rate, generator)
        taps[4] = h.float()
        h = F.relu(linear(self.dense1, h, cdt))
        taps[5] = h.float()
        if train:
            h = dropout(h, self.dropout_rate, generator)
        taps[6] = h.float()
        probs = torch.softmax(linear(self.dense2, h, cdt).float(), dim=-1)
        taps[7] = probs
        return probs, taps

    def extra_repr(self) -> str:
        return repr_suffix(self.compute_dtype)

    def vote_probs(
        self, prefix: Tuple[torch.Tensor, torch.Tensor], generator: torch.Generator
    ) -> torch.Tensor:
        """Probabilities of one stochastic forward from ``vote_prefix``'s output."""
        return self.suffix(prefix, train=True, generator=generator)[0]

    def forward(
        self,
        x: torch.Tensor,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Dict[int, torch.Tensor]]:
        """``(probs, taps)`` for int64 token ids ``x`` ``[B, T]``."""
        return self.suffix(self.vote_prefix(x), train=train, generator=generator)
