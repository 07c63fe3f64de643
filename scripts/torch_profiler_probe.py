"""Does ``torch.profiler`` see the card's kernels on this machine?

Builds the kernels, then traces, under ``torch.profiler.profile`` with CPU
and CUDA activities: kernel B1 (``fused_mnist_probs``) launched eagerly on
seeded random weights, the MNIST module's forward captured as a CUDA graph
and replayed, and a plain matmul. Writes the Chrome trace and prints, per
event category, how many events it holds, the device kernel names, whether
B1's kernel is among them, and ``key_averages()``' device time of B1.

    python scripts/torch_profiler_probe.py [--out chiprun_out/profiler_probe]

Last line: one JSON object ``{"device_events": N, "b1_events": N,
"graph_kernel_events": N, ...}``. Exits 1 when no device event was traced.
"""

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from simple_tip_tpu_torch import _build  # noqa: E402
from simple_tip_tpu_torch.bridge import glorot_params, params_from_jax  # noqa: E402
from simple_tip_tpu_torch.models import MnistConvNet  # noqa: E402
from simple_tip_tpu_torch.ops import fused_forward  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default="chiprun_out/profiler_probe")
    args = parser.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    _build.build()
    _build.library()
    dev = torch.device("cuda", 0)
    params = params_from_jax(glorot_params(0, "mnist"))
    fused = {k: v.to(dev) for k, v in params["fused"].items()}
    net = MnistConvNet().to(dev).eval()
    net.load_state_dict(params["module"])
    x = torch.rand(2048, 28, 28, 1, generator=torch.Generator().manual_seed(0)).to(dev)
    with torch.no_grad():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                net(x)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = net(x)[0]
        fused_forward.fused_mnist_probs(fused, x)
        torch.cuda.synchronize()
        os.makedirs(args.out, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.time()
            for _ in range(5):
                fused_forward.fused_mnist_probs(fused, x)
            for _ in range(5):
                graph.replay()
            y = x.reshape(2048, 784) @ x.reshape(2048, 784).T
            torch.cuda.synchronize()
            t1 = time.time()
    del out, y
    path = os.path.join(args.out, "probe.pt.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents", doc) if isinstance(doc, dict) else doc
    cats = collections.Counter(str(e.get("cat")) for e in events if isinstance(e, dict))
    device = [e for e in events if isinstance(e, dict) and e.get("cat") in DEVICE_CATS]
    names = collections.Counter(str(e.get("name"))[:80] for e in device)
    b1 = [e for e in device if "mnist_forward_kernel" in str(e.get("name"))]
    graph_kernels = [e for e in device if (e.get("args") or {}).get("graph id") is not None
                     or "graph" in json.dumps(e.get("args") or {}).lower()]
    print(json.dumps({"categories": dict(cats)}))
    print(json.dumps({"device_kernel_names": dict(names.most_common(30))}))
    if device:
        print(json.dumps({"first_device_event": device[0]}))
    print(json.dumps({"top_keys": [k for k in doc if k != "traceEvents"]
                      if isinstance(doc, dict) else []}))
    ts = [e["ts"] for e in events if isinstance(e, dict) and isinstance(e.get("ts"), (int, float))]
    print(json.dumps({"min_ts": min(ts) if ts else None, "max_ts": max(ts) if ts else None,
                      "host_window_s": t1 - t0}))
    b1_avg = [a for a in prof.key_averages() if "mnist_forward_kernel" in a.key]
    dev_time = None
    if b1_avg:
        a = b1_avg[0]
        dev_time = getattr(a, "device_time_total", None) or getattr(a, "cuda_time_total", None)
    print(json.dumps({"device_events": len(device), "b1_events": len(b1),
                      "graph_kernel_events": len(graph_kernels),
                      "b1_key_averages_device_us": dev_time}))
    return 0 if device else 1


if __name__ == "__main__":
    sys.exit(main())
