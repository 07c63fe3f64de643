"""The bf16 scoring mode's kernels (B1, B3 and B4 in bf16) alone on one card:
errors against their plain versions and against the float32 kernels, and
times.

    python scripts/torch_bf16_kernels.py [--seed 0] [--batch 10000]

Builds the kernels from this checkout's ``csrc/`` and prints one JSON line
per case, then the card's name and power limit:

- ``fused_mnist_forward_bf16`` / ``fused_cifar10_forward_bf16`` on U(0, 1)
  images at ragged batches and at ``--batch``: max |dp| against the plain
  version, the float32 kernel and the bf16 module (cuDNN bf16), and at
  ``--batch`` the eager and CUDA-graph times beside the float32 kernel's
  and the bf16 module's;
- ``flash_attention_fwd_bf16`` on N(0, 1) q, k, v: out (in bf16 ulps of
  the plain version's output; elements apart counted) and lse against the
  plain version, at IMDB's [B, 100, 2, 32], ragged [3, 37, 2, 32] with
  Tkv 53, several key tiles [1, 1100, 1, 16] and dh 64 / 128; times at
  [8192, 100, 2, 32] beside the float32 kernel and SDPA on bfloat16.

Weights are the bridge's ``glorot_params`` from ``--seed``; inputs are made
with numpy from ``--seed``. Needs a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402


def events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
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


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| in units of the bfloat16 ulp at max(|got|, |want|)."""
    got, want = got.float(), want.float()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return (got - want).abs() / ulp


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--batch", type=int, default=10_000)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from simple_tip_tpu_torch import _build
    from simple_tip_tpu_torch.bridge import glorot_params, params_from_jax
    from simple_tip_tpu_torch.device import resolve
    from simple_tip_tpu_torch.models import Cifar10ConvNet, MnistConvNet
    from simple_tip_tpu_torch.ops import flash_attention as fa
    from simple_tip_tpu_torch.ops import fused_forward as ff

    dev = resolve(None)
    _build.library()
    rng = np.random.default_rng(args.seed)
    families = (
        ("mnist", (28, 28, 1), MnistConvNet, ff.fused_mnist_probs_bf16,
         ff.fused_mnist_probs_bf16_plain, ff.fused_mnist_probs),
        ("cifar10", (32, 32, 3), Cifar10ConvNet, ff.fused_cifar10_probs_bf16,
         ff.fused_cifar10_probs_bf16_plain, ff.fused_cifar10_probs),
    )
    for family, shape, model, kernel, plain, f32_kernel in families:
        bridged = params_from_jax(glorot_params(args.seed, family))
        fused = {k: v.to(dev) for k, v in bridged["fused"].items()}
        net = model(compute_dtype="bfloat16").to(dev).eval()
        net.load_state_dict(bridged["module"])
        for batch in (1, 3, 7, 9, 300, 1001, args.batch):
            x = torch.from_numpy(rng.uniform(0, 1, size=(batch,) + shape).astype(np.float32)).to(dev)
            with torch.no_grad():
                got = kernel(fused, x)
                want = plain(fused, x)
                module = net(x)[0]
                f32 = f32_kernel(fused, x)
            torch.cuda.synchronize()
            rec = {"name": f"fused_{family}_forward_bf16", "batch": batch,
                   "max_abs_err": float((got - want).abs().max()),
                   "vs_module": float((got - module).abs().max()),
                   "vs_f32_kernel": float((got - f32).abs().max()),
                   "argmax_vs_plain": int((got.argmax(1) != want.argmax(1)).sum())}
            if batch == args.batch:
                with torch.no_grad():
                    rec.update({
                        "ms": events_ms(lambda: kernel(fused, x), 20),
                        "device_ms": graph_ms(lambda: kernel(fused, x), 20),
                        "f32_kernel_ms": events_ms(lambda: f32_kernel(fused, x), 20),
                        "module_ms": events_ms(lambda: net(x), 20),
                        "plain_ms": events_ms(lambda: plain(fused, x), 3),
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
               "max_ulps": float(ulps.max()), "apart": int((ulps > 0).sum()),
               "elements": got.numel(), "max_abs_err": float((got.float() - want.float()).abs().max()),
               "lse_err": float((lse - want_lse).abs().max())}
        if b == 8192:
            qh, kh, vh = (a.permute(0, 2, 1, 3).contiguous() for a in (q, k, v))
            q32, k32, v32 = (a.float() for a in (q, k, v))
            with torch.no_grad():
                rec.update({
                    "ms": events_ms(lambda: fa.flash_attention_fwd(q, k, v), 20),
                    "device_ms": graph_ms(lambda: fa.flash_attention_fwd(q, k, v), 20),
                    "f32_kernel_ms": events_ms(lambda: fa.flash_attention_fwd(q32, k32, v32), 20),
                    "sdpa_bf16_ms": events_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), 20),
                    "plain_ms": events_ms(lambda: fa.flash_attention_bf16_plain(q, k, v), 3),
                })
        print(json.dumps(rec), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
