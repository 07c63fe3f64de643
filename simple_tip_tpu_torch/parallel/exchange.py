"""The data plane of sequence parallelism: what crosses ranks, and how.

Three exchanges over a ``torch.distributed`` group, each the counterpart of
a JAX collective inside ``shard_map``:

- ``ring_shift``: every rank sends its tensors to rank r+1 and receives rank
  r-1's (``jax.lax.ppermute`` with ``j -> j+1``), one message a shift (the
  tensors stacked);
- ``all_to_all``: chunk j of dim 0 goes to rank j (``jax.lax.all_to_all``);
- ``all_gather_seq``: the ranks' shards concatenated along the sequence
  axis, dim 1, in rank order.

A group of one rank exchanges nothing. NCCL takes CUDA tensors for all
three. Gloo, the transport of several ranks on one card (NCCL refuses two
ranks on one GPU), takes them only for the operations in
``GLOO_CUDA_OPS``; for the others ``exchange`` stages through host memory
explicitly: the inputs copied to the host, the operation run there, the
outputs copied back to the inputs' card. ``STAGED`` counts the staged
calls by operation. Nothing else moves work between devices: every
attention kernel stays on the card.
"""

import collections
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

#: The gloo operations that take CUDA tensors, as
#: ``scripts/torch_gloo_cuda_probe.py`` found them on torch 2.11 (CUDA 12.8):
#: all-gather and all-to-all do (as do all-reduce and broadcast, unused
#: here); point-to-point sends do not: gloo's TCP transport hands the card's
#: pointer to ``writev``, which fails with "Bad address" and ends the group.
GLOO_CUDA_OPS = frozenset({"all_gather", "all_to_all"})
#: Staged calls by operation in this process.
STAGED = collections.Counter()


def group_size_rank(group: Optional[dist.ProcessGroup]) -> Tuple[int, int]:
    """(ranks in ``group``, this process's rank in it); ``group=None`` is the
    default group."""
    return dist.get_world_size(group), dist.get_rank(group)


def exchange(op: str, tensors: Sequence[torch.Tensor], group,
             run: Callable[[List[torch.Tensor]], List[torch.Tensor]]) -> List[torch.Tensor]:
    """``run(tensors)`` (which calls the collective named ``op`` and returns
    its outputs, allocated like its inputs), staged through host memory when
    ``group`` is gloo, the tensors lie on a card and gloo cannot take CUDA
    tensors for ``op``."""
    device = tensors[0].device
    if device.type != "cuda" or dist.get_backend(group) != "gloo" or op in GLOO_CUDA_OPS:
        return run(list(tensors))
    STAGED[op] += 1
    outs = run([t.cpu() for t in tensors])
    return [o.to(device) for o in outs]


def ring_shift(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Rank r's ``tensors`` (all of one shape) on rank r+1, rank r-1's here."""
    n, r = group_size_rank(group)
    if n == 1:
        return list(tensors)
    to = dist.get_global_rank(group, (r + 1) % n) if group is not None else (r + 1) % n
    frm = dist.get_global_rank(group, (r - 1) % n) if group is not None else (r - 1) % n

    def run(ts):
        send = torch.stack(ts)
        recv = torch.empty_like(send)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, send, to, group),
                                           dist.P2POp(dist.irecv, recv, frm, group)]):
            req.wait()
        return list(recv.unbind(0))

    return exchange("ring_shift", tensors, group, run)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` ``[n, ...]``: chunk j goes to rank j; chunk j of the result came
    from rank j."""
    if group_size_rank(group)[0] == 1:
        return x

    def run(ts):
        out = torch.empty_like(ts[0])
        dist.all_to_all_single(out, ts[0].contiguous(), group=group)
        return [out]

    return exchange("all_to_all", [x], group, run)[0]


def all_gather_seq(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` ``[B, T/n, ...]`` concatenated along dim 1 in rank
    order, on every rank."""
    n, _ = group_size_rank(group)
    if n == 1:
        return x

    def run(ts):
        parts = [torch.empty_like(ts[0]) for _ in range(n)]
        dist.all_gather(parts, ts[0].contiguous(), group=group)
        return [torch.cat(parts, dim=1)]

    return exchange("all_gather", [x], group, run)[0]
