"""Phase 7f of ``chip_smoke.py`` alone, on random weights: the
observability and planning plane on the card without the study before it.

Builds the kernels, makes MNIST-shaped data (60,000 training and 10,000
test images, uniform in [0, 1) from ``--seed``) and seeded glorot weights
(``bridge.glorot_params``), writes real event streams for the store to read
(the run scheduler's synthetic ``_test_sleep`` phase over two workers under
``TIP_OBS_DIR``, in the directories phases 7d and 7e use), then runs
``chip_smoke.run_obs_phase``: the device meter over the chain walk and B1,
the traced walk spliced under its span, the feature store, ``obs predict``,
``plan suggest`` twice and one alert tick.

    python scripts/torch_obs_phase.py [--seed 0]

Prints the card's name and power limit, the phase's roofline and its
``{"obs": ...}`` record; the last line is ``OK`` when every gate passed.
"""

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from simple_tip_tpu_torch import _build  # noqa: E402
from simple_tip_tpu_torch.bridge import glorot_params, params_from_jax  # noqa: E402
from simple_tip_tpu_torch.device import resolve  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_obs_phase: no CUDA device is visible", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    print(f"build_s {time.perf_counter() - t0:.3f}")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dev = resolve(None)
    rng = np.random.default_rng(args.seed)
    data = ((rng.random((60_000, 28, 28, 1), dtype=np.float32), rng.integers(0, 10, 60_000)),
            (rng.random((10_000, 28, 28, 1), dtype=np.float32), rng.integers(0, 10, 10_000)))
    params = params_from_jax(glorot_params(args.seed, "mnist"))
    root = tempfile.mkdtemp(prefix="tip_obs_phase_")
    try:
        from simple_tip_tpu_torch.parallel.run_scheduler import run_phase_parallel

        for name in ("sched_obs", "study_obs"):
            with chip_smoke.patched_env({"TIP_ASSETS": os.path.join(root, "assets_" + name),
                                         "TIP_OBS_DIR": os.path.join(root, name),
                                         "TIP_JOURNAL": "off",
                                         "TIP_WORKER_PLATFORMS": "default,default"}):
                chip_smoke.obs.reset()
                run_phase_parallel("mnist", "_test_sleep", model_ids=[0, 1, 2, 3], num_workers=2,
                                   phase_kwargs={"seconds": 0.2})
                chip_smoke.obs.reset()
        t0 = time.perf_counter()
        chip_smoke.run_obs_phase(params, data, dev, root, smi)
        print(f"obs_phase_s {time.perf_counter() - t0:.3f}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
