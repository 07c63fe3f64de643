"""Ulysses attention: exact attention with the sequence axis sharded over
a ``torch.distributed`` group, by two all-to-alls.

Counterpart of the JAX package's ``parallel/ulysses_attention.py``: each
rank holds ``[B, T/n, H, dh]``; an all-to-all scatters the heads and gathers
the sequence, so each rank holds the full sequence for ``H/n`` heads
(heads are independent, so this is exact); the local core runs on
``[B, T, H/n, dh]``; the inverse all-to-all restores the sequence-sharded
layout. Needs ``H % n == 0`` and ``T % n == 0``.

Local cores: ``"flash"`` is kernel B4 forward and B5/B6 backward on the
card (their plain versions on the CPU), ``"dense"`` the plain oracle
(``dense_attention_f32_softmax``, differentiated by autograd), ``"auto"``
flash for CUDA tensors and dense on the CPU, as the JAX package takes its
Pallas kernel on a TPU only. The backward of each all-to-all is the
inverse all-to-all (``UlyssesAttention``).
"""

import functools
from typing import Optional

import torch
import torch.distributed as dist

from simple_tip_tpu_torch.ops.flash_attention import (
    attention_delta,
    flash_attention_fwd,
    flash_bwd_dkv,
    flash_bwd_dq,
)
from simple_tip_tpu_torch.parallel.exchange import all_to_all, group_size_rank
from simple_tip_tpu_torch.parallel.ring_attention import (
    dense_attention_f32_softmax,
    sharded_attention,
)

LOCAL_CORES = ("auto", "flash", "dense")


def check_ulysses_divisibility(seq_len: int, num_heads: int, n_dev: int) -> None:
    """Reject shapes the head scatter / sequence gather cannot split evenly."""
    if seq_len % n_dev != 0:
        raise ValueError(
            f"ulysses attention requires the sequence length ({seq_len}) to be "
            f"divisible by the sequence-parallel mesh size ({n_dev})"
        )
    if num_heads % n_dev != 0:
        raise ValueError(
            f"ulysses attention requires the head count ({num_heads}) to be "
            f"divisible by the sequence-parallel mesh size ({n_dev}); use ring "
            f"attention (no head constraint) for this mesh"
        )


def seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    """``[B, T/n, H, dh]`` sequence-sharded -> ``[B, T, H/n, dh]`` head-sharded."""
    n, _ = group_size_rank(group)
    b, t, h, dh = x.shape
    chunks = x.reshape(b, t, n, h // n, dh).permute(2, 0, 1, 3, 4).contiguous()
    got = all_to_all(chunks, group)  # [n (source rank), B, T/n, H/n, dh]
    return got.permute(1, 0, 2, 3, 4).reshape(b, n * t, h // n, dh)


def heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    """``[B, T, H/n, dh]`` head-sharded -> ``[B, T/n, H, dh]`` sequence-sharded."""
    n, _ = group_size_rank(group)
    b, t, h, dh = x.shape
    chunks = x.reshape(b, n, t // n, h, dh).permute(1, 0, 2, 3, 4).contiguous()
    got = all_to_all(chunks, group)  # [n (source rank = head group), B, T/n, H/n, dh]
    return got.permute(1, 2, 0, 3, 4).reshape(b, t // n, n * h, dh)


def _local_core(local_core: str, q: torch.Tensor) -> str:
    if local_core not in LOCAL_CORES:
        raise ValueError(f"unknown local_core {local_core!r}; use 'auto', 'flash' or 'dense'")
    if local_core == "auto":
        return "flash" if q.is_cuda else "dense"
    return local_core


def ulysses_forward(q, k, v, group, local_core: str = "auto"):
    """(out ``[B, T/n, H, dh]``, saved tensors) of this rank's blocks."""
    core = _local_core(local_core, q)
    qh, kh, vh = (seq_to_heads(x, group) for x in (q, k, v))
    if core == "flash":
        out_h, lse_h = flash_attention_fwd(qh, kh, vh)
        return heads_to_seq(out_h, group), (qh, kh, vh, out_h, lse_h)
    out_h = dense_attention_f32_softmax(qh, kh, vh)
    return heads_to_seq(out_h, group), (qh, kh, vh)


def ulysses_backward(saved, dout, group):
    """(dq, dk, dv) of this rank's blocks from ``ulysses_forward``'s saved
    tensors and the gradient of its output."""
    dout_h = seq_to_heads(dout.contiguous(), group)
    if len(saved) == 5:  # the flash core
        qh, kh, vh, out_h, lse_h = saved
        dvec = attention_delta(out_h, dout_h)
        dq = flash_bwd_dq(qh, kh, vh, dout_h, lse_h, dvec)
        dk, dv = flash_bwd_dkv(qh, kh, vh, dout_h, lse_h, dvec)
    else:
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in saved]
            dq, dk, dv = torch.autograd.grad(dense_attention_f32_softmax(*leaves), leaves, dout_h)
    return tuple(heads_to_seq(g.contiguous(), group) for g in (dq, dk, dv))


class UlyssesAttention(torch.autograd.Function):
    """Ulysses attention over ``group`` on this rank's blocks."""

    @staticmethod
    def forward(ctx, q, k, v, group, local_core):
        out, saved = ulysses_forward(q, k, v, group, local_core)
        ctx.group = group
        ctx.save_for_backward(*saved)
        return out

    @staticmethod
    def backward(ctx, dout):
        return (*ulysses_backward(ctx.saved_tensors, dout, ctx.group), None, None)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group: Optional[dist.ProcessGroup] = None,
                      local_core: str = "auto") -> torch.Tensor:
    """Exact attention over ``group`` by two all-to-alls: this rank's q/k/v
    ``[batch, seq/n, heads, head_dim]`` in, its output out."""
    return UlyssesAttention.apply(q, k, v, group, local_core)


def ulysses_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              group: Optional[dist.ProcessGroup] = None,
                              local_core: str = "auto") -> torch.Tensor:
    """Ulysses attention over ``group`` on the full q/k/v: each rank takes
    its slice of the sequence; the gathered output on every rank."""
    check_ulysses_divisibility(q.shape[1], q.shape[2], group_size_rank(group)[0])
    return sharded_attention(q, k, v, group,
                             functools.partial(ulysses_forward, local_core=local_core),
                             ulysses_backward)
