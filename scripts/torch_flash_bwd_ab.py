"""Time the port's flash-attention backward kernels (B5 dq, B6 dk/dv) of one
or more checkouts on one card, in turns, beside the SDPA backward.

    python scripts/torch_flash_bwd_ab.py --root /path/to/parent --root . \\
        --root . --root /path/to/parent [--out chiprun_out/bwd_ab.json]

Each ``--root`` runs in its own process (the package of that checkout on
``sys.path``, its kernels built from its own ``csrc/``), in the order
given, so that two versions compare on one card within one call (parent,
change, change, parent). Per root and shape ([32, 100, 2, 32], an IMDB
training step, and [8192, 100, 2, 32]) it prints one JSON line: the
kernels' eager time (CUDA events over back-to-back launches), their time
replayed from a CUDA graph (the card alone), their max |error| against
the plain versions, and the same two times of
``scaled_dot_product_attention``'s backward (dq, dk, dv together) on the
same inputs, made from ``--seed`` with numpy. Needs a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys

SHAPES = ((32, 100, 2, 32), (8192, 100, 2, 32))


def _events_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` launches, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(torch, fn, reps: int, stream=None) -> float:
    """Mean milliseconds of ``fn()`` replayed from one CUDA graph of ``reps``
    calls, captured on ``stream`` (a new one by default)."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def measure(root: str, seed: int) -> list:
    """The records of one checkout, one per shape."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    import torch.nn.functional as F

    from simple_tip_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda", 0)
    records = []
    for shape in SHAPES:
        rng = np.random.default_rng(seed)
        q, k, v, dout = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
                         for _ in range(4))
        out, lse = fa.flash_attention_fwd(q, k, v)
        args = (q, k, v, dout, lse, fa.attention_delta(out, dout))
        err = {"dq": float((fa.flash_bwd_dq(*args) - fa.flash_bwd_dq_plain(*args)).abs().max())}
        for name, got, want in zip(("dk", "dv"), fa.flash_bwd_dkv(*args),
                                   fa.flash_bwd_dkv_plain(*args)):
            err[name] = float((got - want).abs().max())
        reps = 200 if shape[0] <= 32 else 20
        record = {
            "root": root,
            "shape": list(shape),
            "gpu": torch.cuda.get_device_name(0),
            "max_abs_err": err,
            "dq_ms": _events_ms(torch, lambda: fa.flash_bwd_dq(*args), reps),
            "dkv_ms": _events_ms(torch, lambda: fa.flash_bwd_dkv(*args), reps),
            "dq_device_ms": _graph_ms(torch, lambda: fa.flash_bwd_dq(*args), reps),
            "dkv_device_ms": _graph_ms(torch, lambda: fa.flash_bwd_dkv(*args), reps),
        }
        # The backward runs on its forward's stream: both on `side`.
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            qh, kh, vh = (x.permute(0, 2, 1, 3).contiguous().requires_grad_() for x in (q, k, v))
            sdpa = F.scaled_dot_product_attention(qh, kh, vh)
            doh = dout.permute(0, 2, 1, 3).contiguous()

            def library():
                return torch.autograd.grad(sdpa, (qh, kh, vh), doh, retain_graph=True)

            record["library_ms"] = _events_ms(torch, library, reps)
            try:
                record["library_device_ms"] = _graph_ms(torch, library, reps, side)
            except RuntimeError as exc:  # recorded, not dropped
                record["library_device_ms"] = None
                record["library_device_error"] = str(exc)[:300]
        torch.cuda.current_stream().wait_stream(side)
        records.append(record)
    return records


def main() -> int:
    """Run each root in its own process, or (``--child``) measure one."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", action="append", required=True)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None)
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        for record in measure(args.root[0], args.seed):
            print(json.dumps(record), flush=True)
        return 0
    records = []
    for root in args.root:
        done = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", "--root", root,
             "--seed", str(args.seed)], capture_output=True, text=True, check=False)
        sys.stderr.write(done.stderr)
        if done.returncode != 0:
            print(f"{root}: exit {done.returncode}", file=sys.stderr)
            return done.returncode
        for line in done.stdout.splitlines():
            print(line, flush=True)
            records.append(json.loads(line))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
