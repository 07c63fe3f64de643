"""The IMDB sentiment transformer of the JAX package's ``models/transformer.py``.

token + position embedding (vocab 2000, maxlen 100, dim 32) ->
TransformerBlock (self-attention, 2 heads of dim 32, FFN 32, dropout 0.1,
post-LN) -> mean over the sequence -> Dropout 0.1 -> Dense 20 relu ->
Dropout 0.1 -> Dense 2 softmax. Inputs are int64 token ids ``[B, T]``; taps
1-7 follow the Keras layer numbering (1 embedding, 2 block output, 3 pooled,
4 pooled after dropout, 5 dense 20, 6 after dropout, 7 probabilities).

The attention core is ``ops/flash_attention.flash_attention``, a
``torch.autograd.Function``: kernel B4 forward and kernels B5/B6 backward
on the card, their plain versions on the CPU. It is the only core: the JAX
package's dense core (``nn.MultiHeadDotProductAttention``) computes the same
function, scaling q by 1/sqrt(dh) before the product where the flash core
scales the scores after it, which agrees to float32 rounding. Both of its
parameter trees (dense and flash) bridge to this module. Layer norms follow
flax's ``LayerNorm(epsilon=1e-6)``: variance as E[x^2] - E[x]^2.

Dropout is active only with ``train=True`` and draws from an explicit
``torch.Generator``; ``vote_prefix``/``vote_probs`` split a stochastic
forward at the first dropout site (after the attention output), so the
deterministic prefix can run once for many samples.
"""

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from simple_tip_tpu_torch.models.convnet import dropout
from simple_tip_tpu_torch.ops.flash_attention import flash_attention


class FlaxLayerNorm(nn.Module):
    """Flax ``nn.LayerNorm`` over the last axis (fast-variance form)."""

    def __init__(self, dim: int, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = x.mean(dim=-1, keepdim=True)
        mu2 = (x * x).mean(dim=-1, keepdim=True)
        var = torch.clamp_min(mu2 - mu * mu, 0.0)
        return (x - mu) * (torch.rsqrt(var + self.epsilon) * self.weight) + self.bias


class TokenAndPositionEmbedding(nn.Module):
    """Token embedding plus learned position embedding (positions ``arange(T)``)."""

    def __init__(self, maxlen: int, vocab_size: int, embed_dim: int):
        super().__init__()
        self.token = nn.Embedding(vocab_size, embed_dim)
        self.position = nn.Embedding(maxlen, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        positions = torch.arange(x.shape[-1], device=x.device)
        return self.token(x) + self.position(positions)


class SelfAttention(nn.Module):
    """q/k/v projections ``[E -> (H, dh)]``, the flash core, and the output
    projection ``[(H, dh) -> E]``. No padding mask: every token attends to
    every token, token 0 included, as in the reference."""

    def __init__(self, embed_dim: int, num_heads: int, head_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = head_dim
        width = num_heads * head_dim
        self.query = nn.Linear(embed_dim, width)
        self.key = nn.Linear(embed_dim, width)
        self.value = nn.Linear(embed_dim, width)
        self.out = nn.Linear(width, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape

        def heads(proj):
            return proj(x).reshape(b, t, self.num_heads, self.head_dim)

        core = flash_attention(heads(self.query), heads(self.key), heads(self.value))
        return self.out(core.reshape(b, t, -1))


class TransformerBlock(nn.Module):
    """Post-LN encoder block: x + dropout(attn) -> LN -> FFN relu -> dropout -> LN."""

    def __init__(self, embed_dim: int, num_heads: int, ff_dim: int, rate: float = 0.1):
        super().__init__()
        self.rate = rate
        # Keras MultiHeadAttention(key_dim=embed_dim): per-head dim embed_dim.
        self.attention = SelfAttention(embed_dim, num_heads, embed_dim)
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
        out1 = self.norm1(x + attn)
        ffn = self.ffn2(F.relu(self.ffn1(out1)))
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
    ):
        super().__init__()
        self.num_classes = num_classes
        self.dropout_rate = dropout_rate
        self.embedding = TokenAndPositionEmbedding(maxlen, vocab_size, embed_dim)
        self.block = TransformerBlock(embed_dim, num_heads, ff_dim, dropout_rate)
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
        emb, attn = prefix
        taps: Dict[int, torch.Tensor] = {1: emb}
        h = self.block.residual(emb, attn, train, generator)
        taps[2] = h
        h = h.mean(dim=1)
        taps[3] = h
        if train:
            h = dropout(h, self.dropout_rate, generator)
        taps[4] = h
        h = F.relu(self.dense1(h))
        taps[5] = h
        if train:
            h = dropout(h, self.dropout_rate, generator)
        taps[6] = h
        probs = torch.softmax(self.dense2(h), dim=-1)
        taps[7] = probs
        return probs, taps

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
