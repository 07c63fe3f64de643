"""Two cold kernel builds at once on the card, as two run-scheduler workers
on a fresh checkout would start them.

Two spawned processes, started together, each find no kernel library in
one fresh build directory (``_build.BUILD_ROOT`` set to a temporary
directory), so each compiles the six sources with ``nvcc`` in its own
temporary directory and renames the library into place; each then loads
it and runs B1 (``fused_mnist_probs``) on 2,048 seeded images with seeded
glorot weights on the card. Checks: both builds succeed, end with the same
library path and bytes, and give byte-equal probabilities within 1e-5 of
the plain version.

    python scripts/torch_cold_build_race.py

Needs one CUDA card and ``nvcc``; its last line is ``OK`` when the checks
pass. Each process prints its build seconds.
"""

import hashlib
import json
import multiprocessing as mp
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROWS = 2_048


def _worker(root: str, start, queue) -> None:
    import numpy as np
    import torch

    from simple_tip_tpu_torch import _build, bridge
    from simple_tip_tpu_torch.bridge import params_from_jax
    from simple_tip_tpu_torch.ops import fused_forward

    _build.BUILD_ROOT = root
    start.wait()
    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    build_s = time.perf_counter() - t0
    params = params_from_jax(bridge.glorot_params(0, "mnist"))
    fused = {k: v.to("cuda") for k, v in params["fused"].items()}
    x = torch.from_numpy(np.random.default_rng(0).random((ROWS, 28, 28, 1), dtype=np.float32))
    probs = fused_forward.fused_mnist_probs(fused, x.to("cuda")).cpu()
    plain = fused_forward.fused_mnist_probs_plain({k: v.cpu() for k, v in fused.items()}, x)
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    queue.put({"pid": os.getpid(), "path": path, "sha256": digest, "build_s": build_s,
               "max_abs_err": float((probs - plain).abs().max()),
               "probs_sha256": hashlib.sha256(probs.numpy().tobytes()).hexdigest()})


def main() -> int:
    root = tempfile.mkdtemp(prefix="tip_cold_build_")
    ctx = mp.get_context("spawn")
    start, queue = ctx.Event(), ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(root, start, queue)) for _ in range(2)]
    for p in procs:
        p.start()
    time.sleep(5.0)  # both imported and waiting: release them together
    start.set()
    results = [queue.get(timeout=900) for _ in procs]
    for p in procs:
        p.join(timeout=60)
    print(json.dumps({"cold_builds": results}))
    faults = []
    if len({r["path"] for r in results}) != 1 or len({r["sha256"] for r in results}) != 1:
        faults.append("the two builds ended with different libraries")
    if len({r["probs_sha256"] for r in results}) != 1:
        faults.append("the two processes' B1 outputs differ")
    faults += [f"pid {r['pid']}: B1 max |dp| {r['max_abs_err']}" for r in results
               if not r["max_abs_err"] <= 1e-5]
    if faults or any(p.exitcode != 0 for p in procs):
        print("FAILED", faults, [p.exitcode for p in procs])
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
