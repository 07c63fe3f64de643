"""Several processes on ``torch.distributed``: the study's control plane and
the launcher of sequence-parallel ranks.

Counterpart of the JAX package's ``parallel/distributed.py``:

- ``initialize`` forms the default process group over a ``tcp://``
  coordinator (gloo: the control plane moves no tensors); a no-op for a
  single process;
- ``barrier`` is a rendezvous on the group's store, not a collective, for
  the JAX package's reason: hosts reach it minutes apart (they carry
  different run shards, and process 0 alone aggregates), and a rendezvous
  waits out that skew with its own timeout;
- ``host_local_model_ids`` is this host's contiguous share of the run ids,
  the remainder to the leading ranks.

The JAX ``global_ensemble_mesh`` is not ported: the port trains ensemble
members one after another on one card.

``run_ranks`` starts ``world`` spawned processes that form one process
group and runs a function in each (the tests' gloo groups on the CPU,
``chip_smoke.py``'s ranks on the card); ``sp_backend`` picks the
transport of sequence-parallel ranks: NCCL where each rank has a card of
its own, gloo where several share one.
"""

import collections
import datetime
import logging
import multiprocessing
import queue as queue_mod
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from simple_tip_tpu_torch import obs

logger = logging.getLogger(__name__)

_BARRIERS = collections.Counter()  # barrier name -> times this process reached it
POLL_S = 0.05


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Form the default process group over ``tcp://coordinator_address``
    (no-op when single-process or already up)."""
    if dist.is_initialized():
        return
    if coordinator_address is None:
        logger.info("single-process run; torch.distributed not initialized")
        return
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    logger.info("torch.distributed up: process %d/%d", dist.get_rank(), dist.get_world_size())


def process_index() -> int:
    """This process's rank (0 when single-process)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """Processes in the default group (1 when single-process)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier(name: str, timeout_s: float = 1800.0) -> None:
    """Wait until every process of the default group has reached the
    barrier ``name`` (a rendezvous on the group's store: counters, no
    collective); raise ``TimeoutError`` naming it after ``timeout_s``.

    Rank 0 hosts the store, so it leaves only after every rank has seen
    the rendezvous complete. No-op in single-process runs.
    """
    n = process_count()
    if n <= 1:
        return
    store = dist.distributed_c10d._get_default_store()
    _BARRIERS[name] += 1
    key = f"tip_barrier/{name}/{_BARRIERS[name]}"
    t0 = time.monotonic()

    def wait(counter: str, what: str) -> None:
        while (arrived := store.add(counter, 0)) < n:
            if time.monotonic() - t0 > timeout_s:
                raise TimeoutError(f"barrier {name!r}: {arrived}/{n} processes {what} "
                                   f"within {timeout_s} s")
            time.sleep(POLL_S)

    store.add(f"{key}/arrived", 1)
    wait(f"{key}/arrived", "arrived")
    store.add(f"{key}/left", 1)
    if dist.get_rank() == 0:
        wait(f"{key}/left", "left")
    obs.event("barrier", barrier=name, rank=dist.get_rank(), waited_s=time.monotonic() - t0)


def host_local_model_ids(model_ids: Sequence[int]) -> List[int]:
    """The subset of run ids this host is responsible for (contiguous split,
    remainder to the leading hosts)."""
    ids = list(model_ids)
    n_proc = process_count()
    if n_proc == 1:
        return ids
    rank = process_index()
    base, rem = divmod(len(ids), n_proc)
    start = rank * base + min(rank, rem)
    size = base + (1 if rank < rem else 0)
    return ids[start : start + size]


def sp_backend(device_type: str, world: int) -> str:
    """The transport of ``world`` sequence-parallel ranks: NCCL when each
    has a card of its own, gloo on the CPU or when several share a card
    (NCCL refuses two ranks on one GPU)."""
    if device_type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def _rank_main(fn, rank, world, init_method, backend, timeout_s, threads, args, results):
    torch.set_num_threads(threads)
    try:
        dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_s))
        results.put((rank, True, fn(rank, world, *args)))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, init_method: str, backend: str = "gloo",
              args: tuple = (), timeout_s: float = 600.0, threads: int = 1) -> list:
    """``fn(rank, world, *args)`` in ``world`` spawned processes that form
    one process group (``backend`` over ``init_method``: ``file://`` or
    ``tcp://``), each with ``threads`` torch threads; returns their results
    in rank order. ``fn`` must be importable (a module's function) and its
    results picklable. A rank that raises, or a group not done within
    ``timeout_s``, raises here after every process is stopped."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, rank, world, init_method, backend, timeout_s, threads, args,
                               results))
             for rank in range(world)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout_s
    try:
        while len(out) < world:
            try:
                wait_s = max(0.1, min(1.0, deadline - time.monotonic()))
                rank, ok, value = results.get(timeout=wait_s)
            except queue_mod.Empty:
                dead = [rank for rank, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and rank not in out]
                if dead or time.monotonic() > deadline:
                    raise RuntimeError(f"{world} ranks: {len(out)} reported within "
                                       f"{timeout_s} s; exit codes {[p.exitcode for p in procs]}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [out[rank] for rank in range(world)]
