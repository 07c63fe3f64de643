"""Ring attention: exact attention with the sequence axis sharded over the
ranks of a ``torch.distributed`` group.

Counterpart of the JAX package's ``parallel/ring_attention.py``. Every rank
holds its ``[B, T/n, H, dh]`` block of q, k and v. K/V blocks travel round
the ring (``exchange.ring_shift``: rank r sends to r+1), so at step i rank r
holds block (r - i) mod n, as under the JAX permutation ``j -> j+1``.

- Forward: on each block the flash forward (kernel B4 on the card, its
  plain version on the CPU) gives the block's output and log-sum-exp, and
  the running pair folds it in float32:
  ``lse' = logaddexp(lse, lse_blk)``,
  ``o' = o e^(lse - lse') + o_blk e^(lse_blk - lse')``:
  the streaming softmax of JAX's ``_block_update``, one block at a time.
- Backward (``RingAttention``, a ``torch.autograd.Function``): ``D =
  rowsum(dO o)`` locally, then K/V go round again, and on each block B5
  gives dq and B6 dk, dv from the rank's *global* lse and D (so ``p =
  exp(s - lse)`` is the true probability). dq accumulates at home; dk and
  dv accumulate in buffers that travel with their block and come home
  after n shifts.

``sharded_attention`` is the scaffolding shared with ulysses: the full
q/k/v in on every rank, each rank's slice through a core, the output
gathered, behind one autograd Function whose backward slices dO, runs the
core's backward and gathers dq, dk and dv, so that every rank holds the
full gradients (a sum over ranks, as ``torch.distributed.nn``'s gather
would take, would give n times them). ``dense_attention_f32_softmax`` is
the plain oracle of the tests.
"""

import math
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from simple_tip_tpu_torch.ops.flash_attention import (
    attention_delta,
    flash_attention_fwd,
    flash_bwd_dkv,
    flash_bwd_dq,
)
from simple_tip_tpu_torch.parallel.exchange import all_gather_seq, group_size_rank, ring_shift


def _weights(lse: torch.Tensor) -> torch.Tensor:
    """``[B, H, T]`` -> ``[B, T, H, 1]``, to scale a ``[B, T, H, dh]`` output."""
    return lse.permute(0, 2, 1).unsqueeze(-1)


def ring_forward(q, k, v, group) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out ``[B, T/n, H, dh]``, lse ``[B, H, T/n]``) of this rank's queries
    against every rank's keys."""
    n, _ = group_size_rank(group)
    out, lse = flash_attention_fwd(q, k, v)
    for _ in range(n - 1):
        k, v = ring_shift((k, v), group)
        o_blk, lse_blk = flash_attention_fwd(q, k, v)
        merged = torch.logaddexp(lse, lse_blk)
        out = (out * _weights(torch.exp(lse - merged))
               + o_blk * _weights(torch.exp(lse_blk - merged)))
        lse = merged
    return out.contiguous(), lse.contiguous()


def ring_backward(q, k, v, out, lse, dout, group):
    """(dq, dk, dv) of this rank's blocks, given its global ``out`` and
    ``lse`` and the gradient ``dout`` of its output."""
    n, _ = group_size_rank(group)
    dout = dout.contiguous()
    dvec = attention_delta(out, dout)
    dq = torch.zeros_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for step in range(n):
        dq += flash_bwd_dq(q, k, v, dout, lse, dvec)
        dk_blk, dv_blk = flash_bwd_dkv(q, k, v, dout, lse, dvec)
        dk += dk_blk
        dv += dv_blk
        if step < n - 1:
            k, v, dk, dv = ring_shift((k, v, dk, dv), group)
        else:  # the accumulators' last hop home
            dk, dv = ring_shift((dk, dv), group)
    return dq, dk, dv


class RingAttention(torch.autograd.Function):
    """Ring attention over ``group`` on this rank's blocks, with the ring
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, group):
        out, lse = ring_forward(q, k, v, group)
        ctx.group = group
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        return (*ring_backward(*ctx.saved_tensors, dout, ctx.group), None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Exact attention with K/V ring-rotated over ``group``: this rank's
    q/k/v ``[batch, seq/n, heads, head_dim]`` in, its output out."""
    return RingAttention.apply(q, k, v, group)


def dense_attention_f32_softmax(q, k, v) -> torch.Tensor:
    """Dense attention, ``[batch, seq, heads, head_dim]`` in and out, the
    softmax in float32: the plain oracle (and ulysses' dense local core)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v.float()).to(q.dtype)


def check_ring_divisibility(seq_len: int, n_dev: int) -> None:
    """Reject sequence lengths that do not shard evenly (uneven shards
    would need padded keys, which leak weight into the softmax)."""
    if seq_len % n_dev != 0:
        raise ValueError(
            f"ring attention requires the sequence length ({seq_len}) to be "
            f"divisible by the sequence-parallel mesh size ({n_dev}); pad the "
            f"sequence or choose a different mesh"
        )


def _shard(seq_len: int, group) -> slice:
    n, r = group_size_rank(group)
    step = seq_len // n
    return slice(r * step, (r + 1) * step)


class _ShardedCore(torch.autograd.Function):
    """The full q/k/v in on every rank; this rank's sequence slice through
    ``forward(q, k, v, group) -> (out, saved)``; the gathered output out.
    Backward: dO sliced, ``backward(saved, dout, group) -> (dq, dk, dv)``,
    each gathered, in that order on every rank."""

    @staticmethod
    def forward(ctx, q, k, v, group, forward: Callable, backward: Callable):
        shard = _shard(q.shape[1], group)
        out, saved = forward(*(x[:, shard].contiguous() for x in (q, k, v)), group)
        ctx.group, ctx.shard, ctx.core_backward = group, shard, backward
        ctx.save_for_backward(*saved)
        return all_gather_seq(out, ctx.group)

    @staticmethod
    def backward(ctx, dout):
        grads = ctx.core_backward(ctx.saved_tensors, dout[:, ctx.shard].contiguous(), ctx.group)
        return (*(all_gather_seq(g, ctx.group) for g in grads), None, None, None)


def _ring_core_forward(q, k, v, group):
    out, lse = ring_forward(q, k, v, group)
    return out, (q, k, v, out, lse)


def _ring_core_backward(saved, dout, group):
    return ring_backward(*saved, dout, group)


def sharded_attention(q, k, v, group, forward: Callable, backward: Callable) -> torch.Tensor:
    """The full q/k/v ``[B, T, H, dh]`` (the same on every rank) through a
    sequence-parallel core over ``group``; the full output on every rank,
    differentiable (see ``_ShardedCore``)."""
    return _ShardedCore.apply(q, k, v, group, forward, backward)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Ring attention over ``group`` on the full q/k/v: each rank takes its
    slice of the sequence; the gathered output on every rank."""
    check_ring_divisibility(q.shape[1], group_size_rank(group)[0])
    return sharded_attention(q, k, v, group, _ring_core_forward, _ring_core_backward)


def sequence_parallel_group(n_ranks: Optional[int] = None) -> dist.ProcessGroup:
    """The group of the first ``n_ranks`` ranks of the default group (all of
    them for None). Every rank of the default group must call it."""
    world = dist.get_world_size()
    n = world if n_ranks is None else n_ranks
    if not 1 <= n <= world:
        raise ValueError(f"a sequence-parallel group of {n} ranks in a world of {world}")
    return dist.group.WORLD if n == world else dist.new_group(list(range(n)))
