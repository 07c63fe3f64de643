"""Which gloo operations take CUDA tensors on this machine's torch, and the
sequence-parallel cores over two gloo ranks on one card.

    python scripts/torch_gloo_cuda_probe.py [--out gloo_probe.json]

Needs one CUDA card. Two spawned ranks form a gloo group (every rank on
card 0) and try, each on CUDA tensors and with a known answer, the
operations that ``parallel/exchange.py`` runs: ``all_gather``,
``all_to_all_single`` and ``batch_isend_irecv`` (a ring shift), plus
``all_reduce`` and ``broadcast``; each in a group of its own, since an
operation that hands a card's pointer to gloo's TCP transport can abort
the process. Each outcome is ``ok``, ``wrong``, the error, or the failed
group's report. Then, with the kernels built, ``ring_attention_sharded`` and
``ulysses_attention_sharded`` (forward and backward, B4-B6 on each rank)
at [2, 256, 4, 32] against one-rank flash attention, with the exchanges
staged where ``exchange.GLOO_CUDA_OPS`` says. Prints one JSON line and
``OK`` last.
"""

import argparse
import json
import os
import socket
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from simple_tip_tpu_torch import _build  # noqa: E402
from simple_tip_tpu_torch.parallel.distributed import run_ranks  # noqa: E402

SHAPE = (2, 256, 4, 32)
OPS = ("all_gather", "all_to_all", "all_reduce", "broadcast", "ring_shift")


def _try(fn):
    try:
        return "ok" if fn() else "wrong"
    except Exception as e:  # noqa: BLE001 - the outcome is the error
        return f"{type(e).__name__}: {str(e)[:300]}"


def probe_rank(rank: int, world: int, op: str) -> str:
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    def all_gather():
        parts = [torch.empty(4, device=dev) for _ in range(world)]
        dist.all_gather(parts, torch.full((4,), float(rank), device=dev))
        return all(float(p[0]) == i for i, p in enumerate(parts))

    def all_to_all():
        inp = torch.arange(world, device=dev, dtype=torch.float32) + 10 * rank
        got = torch.empty_like(inp)
        dist.all_to_all_single(got, inp)
        return got.tolist() == [10.0 * j + rank for j in range(world)]

    def all_reduce():
        x = torch.full((4,), 1.0, device=dev)
        dist.all_reduce(x)
        return float(x[0]) == world

    def broadcast():
        x = torch.full((4,), float(rank), device=dev)
        dist.broadcast(x, 0)
        return float(x[0]) == 0.0

    def ring_shift():
        send = torch.full((4,), float(rank), device=dev)
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, (rank + 1) % world),
               dist.P2POp(dist.irecv, recv, (rank - 1) % world)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        torch.cuda.synchronize()
        return float(recv[0]) == (rank - 1) % world

    ops = {"all_gather": all_gather, "all_to_all": all_to_all, "all_reduce": all_reduce,
           "broadcast": broadcast, "ring_shift": ring_shift}
    return _try(ops[op])


def cores_rank(rank: int, world: int, seed: int) -> dict:
    import numpy as np

    from simple_tip_tpu_torch.device import resolve
    from simple_tip_tpu_torch.ops import flash_attention as fa
    from simple_tip_tpu_torch.parallel import exchange
    from simple_tip_tpu_torch.parallel.ring_attention import ring_attention_sharded
    from simple_tip_tpu_torch.parallel.ulysses_attention import ulysses_attention_sharded

    dev = resolve("cuda:0")
    torch.cuda.set_device(dev)
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=SHAPE).astype(np.float32) for _ in range(4)]
    q, k, v, dout = (torch.from_numpy(a).to(dev) for a in arrays)

    def run(core):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = core(*leaves)
        grads = torch.autograd.grad(out, leaves, dout)
        return [out.detach(), *grads]

    want = run(fa.flash_attention)
    res = {}
    for name, core in (("ring", lambda a, b, c: ring_attention_sharded(a, b, c, None)),
                       ("ulysses", lambda a, b, c: ulysses_attention_sharded(a, b, c, None))):
        before = (fa.LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES)
        got = run(core)
        torch.cuda.synchronize()
        after = (fa.LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES)
        res[name] = {"max_abs_err": [float((g - w).abs().max()) for g, w in zip(got, want)],
                     "launches": [a - b for a, b in zip(after, before)]}
    res["staged"] = dict(exchange.STAGED)
    return res


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    record = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "gloo": torch.distributed.is_gloo_available(),
              "nccl": torch.distributed.is_nccl_available()}
    _build.build()

    def port():
        with socket.socket() as s:
            s.bind(("localhost", 0))
            return s.getsockname()[1]

    record["gloo_cuda"] = {}
    for op in OPS:
        try:
            got = run_ranks(probe_rank, 2, f"tcp://localhost:{port()}", "gloo", args=(op,),
                            timeout_s=60)
            record["gloo_cuda"][op] = got[0] if got[0] == got[1] else got
        except RuntimeError as e:
            record["gloo_cuda"][op] = f"group failed: {str(e)[-400:]}"
    print(json.dumps(record), flush=True)
    record["cores"] = run_ranks(cores_rank, 2, f"tcp://localhost:{port()}", "gloo",
                                args=(args.seed,), timeout_s=300)
    print(json.dumps(record))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
