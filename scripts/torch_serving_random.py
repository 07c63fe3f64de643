"""Phase 7c of ``chip_smoke.py`` on seeded random weights, on the card.

Builds the kernels, makes the MNIST and IMDB stand-ins of
``data/synthetic.py`` at full size (60,000 / 10,000 images, 25,000 /
25,000 sequences), draws seeded glorot weights, fills the coverage
statistics cache with one ``FusedChainRunner`` a family, and runs
``chip_smoke.run_serving`` (its failure is printed, not raised, so the two
checks below still run). Then, on the card:

- two threads dispatch eight MNIST badges through one
  ``FusedChainExecutor`` program three times each, against the serial
  results byte for byte;
- a second tenant (IMDB) is registered while the loop thread serves
  MNIST's 10,000 rows at 8,000 rows/s; both tenants' answers against
  their offline walks byte for byte.

    python scripts/torch_serving_random.py

Needs one CUDA card; its last line is ``OK`` when the two checks pass.
It takes about 70 s of command time (most of it the build and the data).
"""

import json
import os
import sys
import tempfile
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from simple_tip_tpu_torch import _build, bridge  # noqa: E402
from simple_tip_tpu_torch.bridge import params_from_jax  # noqa: E402
from simple_tip_tpu_torch.data import synthetic  # noqa: E402
from simple_tip_tpu_torch.engine.run_program import FusedChainRunner  # noqa: E402
from simple_tip_tpu_torch.parallel import shared_loop  # noqa: E402
from simple_tip_tpu_torch.serving import (  # noqa: E402
    FusedChainExecutor,
    ScoringEngine,
    ServingKnobs,
    drive,
)


def main() -> int:
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    os.environ["TIP_ASSETS"] = tempfile.mkdtemp()
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    print("build_s", time.perf_counter() - t0, flush=True)
    dev = torch.device("cuda")
    (xm, ym), (xmt, ymt) = synthetic.image_classification(
        seed=0, n_train=60000, n_test=10000, shape=(28, 28, 1))
    (xi, yi), (xit, yit) = synthetic.token_classification(seed=0, n_train=25000, n_test=25000)
    print("layouts", xm.strides, xmt.strides, xi.dtype, xit.dtype, flush=True)
    data = {"mnist": ((xm, ym), (xmt, ymt), None), "imdb": ((xi, yi), (xit, yit), None)}
    params = {f: params_from_jax(bridge.glorot_params(0, f)) for f in data}
    for f in data:
        cfg = cs.PATHS[f]
        FusedChainRunner(cfg["model"](), params[f], data[f][0][0], cfg["nc"],
                         batch_size=cfg["batch"], device=dev)
    t0 = time.perf_counter()
    try:
        cs.run_serving(params, data, dev, late_params=params_from_jax(
            bridge.glorot_params(1, "mnist")))
    except AssertionError as e:
        print("PHASE FAILED", e, flush=True)
    print("phase_s", time.perf_counter() - t0, flush=True)

    # two threads dispatching MNIST badges at once against the serial bytes
    ex = FusedChainExecutor(device=dev)
    cfg = cs.PATHS["mnist"]
    spec = dict(model_def=cfg["model"](), params=params["mnist"], training_set=xm,
                nc_layers=cfg["nc"], batch_size=cfg["batch"], layout_like=xmt)
    ex.register_model("m", badge_size=512, **spec)
    badges = [[xmt[i * 300:i * 300 + 300], xmt[5000 + i * 100:5000 + i * 100 + 150]]
              for i in range(8)]
    serial = [ex.run_badge("m", b) for b in badges]
    out = {}

    def worker(t):
        out[t] = [ex.run_badge("m", b) for b in badges[t::2] * 3]

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    faults = [f for t in range(2) for got, want in zip(out[t], serial[t::2] * 3)
              for f in cs.tree_faults(got, want)]
    print("concurrent_faults", faults[:5], flush=True)

    # a second tenant registered while the first is served
    spec_i = dict(model_def=cs.PATHS["imdb"]["model"](), params=params["imdb"], training_set=xi,
                  nc_layers=cs.PATHS["imdb"]["nc"], batch_size=cs.PATHS["imdb"]["batch"],
                  layout_like=xit)
    ex2 = FusedChainExecutor(device=dev)
    ex2.register_model("m", badge_size=512, **spec)
    loop = shared_loop()
    eng = ScoringEngine(ex2, ServingKnobs(max_badge=512, flush_deadline_s=0.005))
    eng.register_model("m", **spec)
    loop.run(eng.start())
    cuts = cs.request_cuts(len(xmt), 5)
    resp = {}
    fut = loop.submit(drive(eng, "m", lambda i: xmt[cuts[i]:cuts[i + 1]], len(cuts) - 1, 350,
                            8000.0, on_response=resp.__setitem__))
    time.sleep(0.2)
    t0 = time.perf_counter()
    eng.register_model("i", **spec_i)
    reg_s = time.perf_counter() - t0
    report = fut.result(120)
    r2 = loop.run(eng.score("i", xit[:700]))
    loop.run(eng.close())
    ref = ex2.runner("m").score_dataset(xmt)
    reff = ex2.runner("i").score_dataset(xit[:700])
    f2 = (cs.serving_faults("m", resp, cuts, ref)
          + cs.serving_faults("i", {0: r2}, np.array([0, 700]), reff))
    print(json.dumps({"register_while_serving_s": reg_s, "report": report, "faults": f2[:5],
                      "inflight_at_register": report["elapsed_s"]}), flush=True)
    if faults or f2:
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
