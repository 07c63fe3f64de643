"""Phase 7d of ``chip_smoke.py`` alone on the card, with what it needs
before it: MNIST's fixtures at full size (60,000 / 10,000), the MNIST-C set
generated by the loader on the card, runs 0 and 1 trained one epoch
(``registry_spec``, cuDNN deterministic), then ``chip_smoke.run_sched_phase``
(which scores its runs on the ``SCHED_DATA`` cut of those files).

    python scripts/torch_sched_phase.py

Needs one CUDA card; prints the phase's lines and ``OK`` last.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from simple_tip_tpu_torch import _build  # noqa: E402
from simple_tip_tpu_torch.casestudies import base  # noqa: E402
from simple_tip_tpu_torch.casestudies.base import CaseStudy  # noqa: E402
from simple_tip_tpu_torch.data import loaders, synthetic  # noqa: E402
from simple_tip_tpu_torch.device import resolve  # noqa: E402


def main() -> int:
    t_all = time.perf_counter()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = resolve(None)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    root = tempfile.mkdtemp(prefix="tip_sched_phase_")
    try:
        data = os.path.join(root, "datasets")
        os.makedirs(data)
        n_train, n_test, shape, offset = chip_smoke.IMAGE_FIXTURES["mnist"]
        (x_tr, y_tr), (x_te, y_te) = synthetic.image_classification(offset, n_train, n_test,
                                                                    shape)
        np.savez(os.path.join(data, "mnist.npz"),
                 x_train=np.round(x_tr[..., 0] * 255).astype(np.uint8), y_train=y_tr,
                 x_test=np.round(x_te[..., 0] * 255).astype(np.uint8), y_test=y_te)
        os.environ["TIP_DATA_DIR"] = data
        os.environ["TIP_ASSETS"] = os.path.join(root, "train")
        loaders.load_mnist(device=dev)
        base.CASE_STUDIES["mnist"] = chip_smoke.registry_spec("mnist")
        t0 = time.perf_counter()
        CaseStudy(base.CASE_STUDIES["mnist"]).train([0, 1], device=dev)
        print(json.dumps({"train_s": time.perf_counter() - t0}), flush=True)
        record = chip_smoke.run_sched_phase(data, dev, root, 0)
        print(json.dumps({"phase_s": record["phase_s"], "faults": record["faults"],
                          "command_s": time.perf_counter() - t_all}))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
