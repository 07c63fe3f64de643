"""Phase 7e of ``chip_smoke.py`` alone on the card, with what it needs
before it: IMDB's token caches at full size (25,000 / 25,000), runs 0 and 1
trained one epoch (``registry_spec``), run 0's ``cli.main --phase
test_prio`` as phase 7 runs it (its artifacts and both caches), then
``chip_smoke.run_sp_phase`` on a ``SpGroup`` spawned just before it (so
the phase's seconds include the ranks' start, which ``chip_smoke.py``
hides behind phase 7d) and ``chip_smoke.StudyHosts`` after it.

    python scripts/torch_sp_phase.py

Needs one CUDA card; prints the phase's lines and ``OK`` last. It takes
about 200 s on an H100.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from simple_tip_tpu_torch import _build  # noqa: E402
from simple_tip_tpu_torch.bridge import params_from_jax  # noqa: E402
from simple_tip_tpu_torch.casestudies import base  # noqa: E402
from simple_tip_tpu_torch.casestudies.base import CaseStudy  # noqa: E402
from simple_tip_tpu_torch.data import synthetic  # noqa: E402
from simple_tip_tpu_torch.device import resolve  # noqa: E402


def main() -> int:
    t_all = time.perf_counter()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = resolve(None)
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    root = tempfile.mkdtemp(prefix="tip_sp_phase_")
    try:
        data_dir = os.path.join(root, "datasets")
        os.makedirs(os.path.join(data_dir, "imdb"))
        n_train, n_test, offset = chip_smoke.IMDB_FIXTURE
        (x_tr, y_tr), (x_te, y_te) = synthetic.token_classification(offset, n_train, n_test)
        arrays = {"x_train": x_tr, "y_train": y_tr, "x_test": x_te, "y_test": y_te,
                  "x_corrupted": synthetic.corrupt_tokens(x_te, offset + 1)}
        for key, value in arrays.items():
            np.save(os.path.join(data_dir, "imdb", f"{key}.npy"), value)
        os.environ["TIP_DATA_DIR"] = data_dir
        os.environ["TIP_ASSETS"] = os.path.join(root, "train")
        data = base.get_case_study("imdb").spec.loader(device=dev)
        base.CASE_STUDIES["imdb"] = chip_smoke.registry_spec("imdb")
        cs = CaseStudy(base.CASE_STUDIES["imdb"])
        t0 = time.perf_counter()
        cs.train([0, 1], device=dev)
        print(json.dumps({"train_s": time.perf_counter() - t0}), flush=True)
        t0 = time.perf_counter()
        chip_smoke.run_cli("--phase", "test_prio", "--case-study", "imdb", "--runs", "0")
        print(json.dumps({"run0_s": time.perf_counter() - t0}), flush=True)
        state = params_from_jax(cs.load_params(0))["module"]
        t0 = time.perf_counter()
        group = chip_smoke.SpGroup(state, data, dev, root, 0)
        record = chip_smoke.run_sp_phase(group, dev)
        study = chip_smoke.StudyHosts(data_dir, dev, root).finish()
        print(json.dumps({"phase_s": time.perf_counter() - t0, "study_s": study["seconds"],
                          "command_s": time.perf_counter() - t_all}))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
