"""Time the port's fused convnet forwards (B1 MNIST, B3 CIFAR-10) of one or
more checkouts on one card, in turns, beside the cuDNN module forward.

    python scripts/torch_fused_forward_ab.py --root /path/to/parent --root . \\
        --root . --root /path/to/parent [--out fused_ab.json]

Each ``--root`` runs in its own process (the package of that checkout on
``sys.path``, its kernels built from its own ``csrc/``), in the order
given, so that two versions compare on one card within one call (parent,
change, change, parent). Per root and family it prints one JSON line: the
kernel's eager time over ``--batch`` images (CUDA events over back-to-back
launches), its time replayed from a CUDA graph (the card alone), its max
|error| against the plain version, and the eager time of the family's
module forward (cuDNN convolutions; TF32 off, as ``device.resolve`` sets
it for the port) on the same inputs. Weights are the bridge's
``glorot_params`` and images U(0, 1), both from ``--seed`` with numpy.
Needs a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys

FAMILIES = (("mnist", (28, 28, 1)), ("cifar10", (32, 32, 3)))


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


def _graph_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` replayed from one CUDA graph of ``reps``
    calls (captured on a side stream)."""
    side = torch.cuda.Stream()
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


def measure(root: str, seed: int, batch: int) -> list:
    """The records of one checkout, one per family."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from simple_tip_tpu_torch.bridge import family_model, glorot_params, params_from_jax
    from simple_tip_tpu_torch.device import resolve
    from simple_tip_tpu_torch.ops import fused_forward

    dev = resolve(None)  # the port's card settings: cuDNN and matmuls in float32, TF32 off
    kernels = {"mnist": (fused_forward.fused_mnist_probs, fused_forward.fused_mnist_probs_plain),
               "cifar10": (fused_forward.fused_cifar10_probs,
                           fused_forward.fused_cifar10_probs_plain)}
    records = []
    for family, shape in FAMILIES:
        bridged = params_from_jax(glorot_params(seed, family))
        fused = {k: v.to(dev) for k, v in bridged["fused"].items()}
        net = family_model(family)().to(dev).eval()
        net.load_state_dict(bridged["module"])
        rng = np.random.default_rng(seed)
        x = torch.from_numpy(rng.uniform(0, 1, size=(batch, *shape)).astype(np.float32)).to(dev)
        kernel, plain = kernels[family]
        with torch.no_grad():
            err = float((kernel(fused, x) - plain(fused, x)).abs().max())
            records.append({
                "root": root,
                "family": family,
                "batch": batch,
                "gpu": torch.cuda.get_device_name(0),
                "max_abs_err": err,
                "ms": _events_ms(torch, lambda: kernel(fused, x), 20),
                "device_ms": _graph_ms(torch, lambda: kernel(fused, x), 20),
                "library_ms": _events_ms(torch, lambda: net(x), 20),
            })
    return records


def main() -> int:
    """Run each root in its own process, or (``--child``) measure one."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", action="append", required=True)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--batch", type=int, default=10_000)
    parser.add_argument("--out", default=None)
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        for record in measure(args.root[0], args.seed, args.batch):
            print(json.dumps(record), flush=True)
        return 0
    records = []
    for root in args.root:
        done = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", "--root", root,
             "--seed", str(args.seed), "--batch", str(args.batch)],
            capture_output=True, text=True, check=False)
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
