"""The bf16 scoring mode's kernels (B1, B3 and B4 in bf16) alone on one card:
errors against their plain versions and against the float32 kernels, times,
and an A/B of checkouts.

    python scripts/torch_bf16_kernels.py [--seed 0] [--batch 10000]
    python scripts/torch_bf16_kernels.py --root PARENT --root . --root . --root PARENT

Each builds the kernels from a checkout's ``csrc/`` and prints one JSON line
per case, then the card's name and power limit.

With no ``--root``, on this checkout:

- ``fused_mnist_forward_bf16`` / ``fused_cifar10_forward_bf16`` on U(0, 1)
  images at ragged batches and at ``--batch``: max |dp| against the plain
  version, the float32 kernel and the bf16 module (cuDNN bf16), and at
  ``--batch`` the eager and CUDA-graph times beside the float32 kernel's
  and the bf16 module's;
- ``flash_attention_fwd_bf16`` on N(0, 1) q, k, v: out (in bf16 ulps of
  the plain version's output; elements apart counted) and lse against the
  plain version and the route taken, at IMDB's [B, 100, 2, 32], ragged
  [3, 37, 2, 32] with Tkv 53, several key tiles [1, 1100, 1, 16] and dh
  64 / 128; times at [8192, 100, 2, 32] beside the float32 kernel and SDPA
  on bfloat16.

With ``--root`` (repeated), the A/B: each root runs in its own process (the
package of that checkout on ``sys.path``, its kernels built from its own
``csrc/``), in the order given, so that two versions compare on one card
within one call (parent, change, change, parent). Per root it prints B1 and
B3 in bf16 over ``--batch`` images and B4 in bf16 at [8192, 100, 2, 32]
and at the fused chain's 512-row badge [512, 100, 2, 32]: eager ms (CUDA
events over back-to-back launches), CUDA-graph ms (the card alone), max
error against the plain version, the bound (``chip_smoke.py``'s: bytes at
3.35 TB/s or operations at the units' peaks, whichever is larger) and the
library yardstick (the bf16 module forward on cuDNN; SDPA on bf16).

Weights are the bridge's ``glorot_params`` from ``--seed``; inputs are made
with numpy from ``--seed``. Needs a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
RATES = {"f32": 67e12, "bf16": 989.4e12}  # float32 FMAs; bf16 on the tensor cores (dense)
B4_SHAPES = ((8192, 100, 2, 32), (512, 100, 2, 32))


def events_ms(torch, fn, reps: int) -> float:
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


def graph_ms(torch, fn, reps: int) -> float:
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


def bf16_ulps(got, want):
    """|got - want| in units of the bfloat16 ulp at max(|got|, |want|)."""
    import torch

    got, want = got.float(), want.float()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return (got - want).abs() / ulp


def bound_ms(work, nbytes: float) -> tuple:
    """(least milliseconds, what bounds them): ``work`` is (FLOPs, key of
    RATES) pairs done one after another, ``nbytes`` each input read and
    each output written once."""
    t_ops = sum(flops / RATES[unit] for flops, unit in work) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def fused_bound(family: str, fused: dict, b: int) -> tuple:
    """``chip_smoke.check_fused_forward_bf16``'s bound for ``b`` images."""
    if family == "mnist":  # conv2 at the 10x10 the floor pool needs, so conv1 at 24x24
        work = [(b * 2 * 24 * 24 * 32 * 9, "f32"), (b * 2 * 10 * 10 * 64 * 288, "bf16"),
                (b * 2 * 1600 * 10, "f32")]
        names, pixels = ("w1", "b1", "b2", "wd", "bd", "w2_bf"), 784
    else:  # the convs at the positions the floor pools need: 28x28, 12x12, 4x4
        work = [(b * 2 * (28 * 28 * 32 * 27 + 12 * 12 * 64 * 288 + 4 * 4 * 64 * 576), "bf16"),
                (b * 2 * (1024 * 64 + 64 * 10), "f32")]
        names = ("b1", "b2", "b3", "wd1", "bd1", "wd2", "bd2", "w1_bf", "w2_bf", "w3_bf")
        pixels = 3072
    nbytes = b * (pixels + 10) * 4 + sum(fused[k].numel() * fused[k].element_size() for k in names)
    return bound_ms(work, nbytes)


def flash_bound(b: int, t: int, h: int, dh: int) -> tuple:
    """Two products of 2 dh FLOPs per (query, key) pair at the bf16 rate;
    q, k, v read and out written once in bf16, lse written in float32."""
    return bound_ms([(4 * b * h * t * t * dh, "bf16")], 2 * 4 * b * t * h * dh + 4 * b * h * t)


def time_root(root: str, seed: int, batch: int) -> list:
    """The A/B records of one checkout (imported from ``root``)."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    import torch.nn.functional as F

    from simple_tip_tpu_torch import _build
    from simple_tip_tpu_torch.bridge import glorot_params, params_from_jax
    from simple_tip_tpu_torch.device import resolve
    from simple_tip_tpu_torch.models import Cifar10ConvNet, MnistConvNet
    from simple_tip_tpu_torch.ops import flash_attention as fa
    from simple_tip_tpu_torch.ops import fused_forward as ff

    dev = resolve(None)
    _build.library()
    gpu = torch.cuda.get_device_name(0)
    records = []
    for family, shape, model, kernel, plain in (
            ("mnist", (28, 28, 1), MnistConvNet, ff.fused_mnist_probs_bf16,
             ff.fused_mnist_probs_bf16_plain),
            ("cifar10", (32, 32, 3), Cifar10ConvNet, ff.fused_cifar10_probs_bf16,
             ff.fused_cifar10_probs_bf16_plain)):
        bridged = params_from_jax(glorot_params(seed, family))
        fused = {k: v.to(dev) for k, v in bridged["fused"].items()}
        net = model(compute_dtype="bfloat16").to(dev).eval()
        net.load_state_dict(bridged["module"])
        rng = np.random.default_rng(seed)
        x = torch.from_numpy(rng.uniform(0, 1, size=(batch, *shape)).astype(np.float32)).to(dev)
        bound, by = fused_bound(family, fused, batch)
        with torch.no_grad():
            records.append({
                "root": root, "name": f"fused_{family}_forward_bf16", "batch": batch, "gpu": gpu,
                "max_abs_err": float((kernel(fused, x) - plain(fused, x)).abs().max()),
                "ms": events_ms(torch, lambda: kernel(fused, x), 20),
                "device_ms": graph_ms(torch, lambda: kernel(fused, x), 20),
                "bound_ms": bound, "bound_by": by,
                "library_ms": events_ms(torch, lambda: net(x), 20),
                "library": "the bf16 module forward (cuDNN bf16)",
            })
    rng = np.random.default_rng(seed)
    for b, t, h, dh in B4_SHAPES:
        q, k, v = (torch.from_numpy(rng.normal(size=(b, t, h, dh)).astype(np.float32)).to(dev)
                   .bfloat16() for _ in range(3))
        qh, kh, vh = (a.permute(0, 2, 1, 3).contiguous() for a in (q, k, v))
        out, _ = fa.flash_attention_fwd(q, k, v)
        want, _ = fa.flash_attention_bf16_plain(q, k, v)
        route = getattr(fa, "bf16_route", None)
        bound, by = flash_bound(b, t, h, dh)
        with torch.no_grad():
            records.append({
                "root": root, "name": "flash_attention_fwd_bf16", "shape": [b, t, h, dh],
                "gpu": gpu, "route": route(t, t, dh) if route else "two_pass",
                "max_ulps": float(bf16_ulps(out, want).max()),
                "ms": events_ms(torch, lambda: fa.flash_attention_fwd(q, k, v), 20),
                "device_ms": graph_ms(torch, lambda: fa.flash_attention_fwd(q, k, v), 20),
                "bound_ms": bound, "bound_by": by,
                "library_ms": events_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh),
                                        20),
                "library": "scaled_dot_product_attention on bf16",
            })
    return records


def check(seed: int, batch: int) -> None:
    """Errors and times of this checkout's bf16 kernels (no ``--root``)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from simple_tip_tpu_torch import _build
    from simple_tip_tpu_torch.bridge import glorot_params, params_from_jax
    from simple_tip_tpu_torch.device import resolve
    from simple_tip_tpu_torch.models import Cifar10ConvNet, MnistConvNet
    from simple_tip_tpu_torch.ops import flash_attention as fa
    from simple_tip_tpu_torch.ops import fused_forward as ff

    dev = resolve(None)
    _build.library()
    rng = np.random.default_rng(seed)
    families = (
        ("mnist", (28, 28, 1), MnistConvNet, ff.fused_mnist_probs_bf16,
         ff.fused_mnist_probs_bf16_plain, ff.fused_mnist_probs),
        ("cifar10", (32, 32, 3), Cifar10ConvNet, ff.fused_cifar10_probs_bf16,
         ff.fused_cifar10_probs_bf16_plain, ff.fused_cifar10_probs),
    )
    for family, shape, model, kernel, plain, f32_kernel in families:
        bridged = params_from_jax(glorot_params(seed, family))
        fused = {k: v.to(dev) for k, v in bridged["fused"].items()}
        net = model(compute_dtype="bfloat16").to(dev).eval()
        net.load_state_dict(bridged["module"])
        for b in (1, 3, 7, 9, 300, 1001, batch):
            x = torch.from_numpy(rng.uniform(0, 1, size=(b,) + shape).astype(np.float32)).to(dev)
            with torch.no_grad():
                got = kernel(fused, x)
                want = plain(fused, x)
                module = net(x)[0]
                f32 = f32_kernel(fused, x)
            torch.cuda.synchronize()
            rec = {"name": f"fused_{family}_forward_bf16", "batch": b,
                   "max_abs_err": float((got - want).abs().max()),
                   "vs_module": float((got - module).abs().max()),
                   "vs_f32_kernel": float((got - f32).abs().max()),
                   "argmax_vs_plain": int((got.argmax(1) != want.argmax(1)).sum())}
            if b == batch:
                with torch.no_grad():
                    rec.update({
                        "ms": events_ms(torch, lambda: kernel(fused, x), 20),
                        "device_ms": graph_ms(torch, lambda: kernel(fused, x), 20),
                        "f32_kernel_ms": events_ms(torch, lambda: f32_kernel(fused, x), 20),
                        "module_ms": events_ms(torch, lambda: net(x), 20),
                        "plain_ms": events_ms(torch, lambda: plain(fused, x), 3),
                    })
            print(json.dumps(rec), flush=True)

    shapes = (((64, 100, 2, 32), 100), ((600, 100, 2, 32), 100), ((3, 37, 2, 32), 53),
              ((2, 130, 2, 32), 70), ((1, 1100, 1, 16), 1100), ((2, 200, 2, 64), 200),
              ((2, 150, 1, 128), 150), ((8192, 100, 2, 32), 100))
    for (b, t, h, dh), t_kv in shapes:
        q = torch.from_numpy(rng.normal(size=(b, t, h, dh)).astype(np.float32))
        k, v = (torch.from_numpy(rng.normal(size=(b, t_kv, h, dh)).astype(np.float32))
                for _ in range(2))
        q, k, v = (a.to(dev).to(torch.bfloat16) for a in (q, k, v))
        got, lse = fa.flash_attention_fwd(q, k, v)
        want, want_lse = fa.flash_attention_bf16_plain(q, k, v)
        torch.cuda.synchronize()
        ulps = bf16_ulps(got, want)
        rec = {"name": "flash_attention_fwd_bf16", "shape": [b, t, h, dh], "t_kv": t_kv,
               "route": fa.bf16_route(t, t_kv, dh),
               "max_ulps": float(ulps.max()), "apart": int((ulps > 0).sum()),
               "elements": got.numel(), "max_abs_err": float((got.float() - want.float()).abs().max()),
               "lse_err": float((lse - want_lse).abs().max())}
        if b == 8192:
            qh, kh, vh = (a.permute(0, 2, 1, 3).contiguous() for a in (q, k, v))
            q32, k32, v32 = (a.float() for a in (q, k, v))
            with torch.no_grad():
                rec.update({
                    "ms": events_ms(torch, lambda: fa.flash_attention_fwd(q, k, v), 20),
                    "device_ms": graph_ms(torch, lambda: fa.flash_attention_fwd(q, k, v), 20),
                    "f32_kernel_ms": events_ms(torch, lambda: fa.flash_attention_fwd(q32, k32, v32),
                                               20),
                    "sdpa_bf16_ms": events_ms(
                        torch, lambda: F.scaled_dot_product_attention(qh, kh, vh), 20),
                    "plain_ms": events_ms(torch, lambda: fa.flash_attention_bf16_plain(q, k, v), 3),
                })
        print(json.dumps(rec), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--batch", type=int, default=10_000)
    parser.add_argument("--root", action="append", default=[],
                        help="a checkout to time (repeat, in turns); none: check this one")
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    if args.child:
        for record in time_root(args.root[0], args.seed, args.batch):
            print(json.dumps(record), flush=True)
        return 0
    sys.path.insert(0, ROOT)
    for root in args.root:
        done = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", "--root", root,
             "--seed", str(args.seed), "--batch", str(args.batch)],
            capture_output=True, text=True, check=False)
        sys.stderr.write(done.stderr)
        if done.returncode != 0:
            print(f"{root}: exit {done.returncode}", file=sys.stderr)
            return done.returncode
        sys.stdout.write(done.stdout)
        sys.stdout.flush()
    if not args.root:
        check(args.seed, args.batch)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
