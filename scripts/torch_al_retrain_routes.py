"""Time the two routes of the port's active-learning retrains on one device,
in turns, on the same selections.

    python scripts/torch_al_retrain_routes.py [--members 16] [--rows 12000]
        [--selected 1000] [--epochs 1] [--device cuda] [--out routes.json]

- ``host``: the JAX package's sequential route. Per retrain the base set
  and the selection are concatenated and shuffled with
  ``RandomState(seed)`` on the host, and ``models/train.train_model``
  uploads the training head and trains.
- ``ensemble``: ``parallel/al_ensemble.al_retrain_ensemble``. The base set
  goes up once, each member's selection alone, and its training rows are
  gathered on the device.

Both train MnistConvNet with MNIST's registry settings (batch 128, learning
rate 1e-3, validation split 0.1) on U(0, 1) images and uniform labels from
``--seed`` with numpy; member ``i`` has seed ``1000 + i``. After one
warm-up member per route, the routes run host, ensemble, ensemble, host.
Per turn one JSON line gives the wall seconds of all members, the mean
per member, and the seconds inside the members' epochs (the rest is the
route's preparation: concatenation, shuffle, upload, gather, init). The
last line gives the largest |difference| between the routes' parameters
for each member (0 on the CPU; cuDNN's training kernels may reorder sums
on a card).
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from simple_tip_tpu_torch.device import resolve, synchronize  # noqa: E402
from simple_tip_tpu_torch.models import MnistConvNet  # noqa: E402
from simple_tip_tpu_torch.models.train import TrainConfig, train_model  # noqa: E402
from simple_tip_tpu_torch.parallel.al_ensemble import al_retrain_ensemble  # noqa: E402


def host_route(model, cfg, train_x, train_y_onehot, selections, device):
    """The sequential route: shuffle base + selection on the host, then
    ``train_model``. Returns (tree, epoch records) per selection."""
    out = []
    for x_sel, y_sel, seed in selections:
        x = np.concatenate((train_x, x_sel))
        y = np.concatenate((train_y_onehot, y_sel))
        perm = np.random.RandomState(seed).permutation(len(x))
        history = []
        out.append((train_model(model, x[perm], y[perm], cfg, seed, device, history), history))
    return out


def ensemble_route(model, cfg, train_x, train_y_onehot, selections, device):
    return al_retrain_ensemble(model, cfg, train_x, train_y_onehot, selections, device)


ROUTES = {"host": host_route, "ensemble": ensemble_route}


def _max_diff(a, b) -> float:
    if isinstance(a, dict):
        return max(_max_diff(a[k], b[k]) for k in a)
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--members", type=int, default=16)
    parser.add_argument("--rows", type=int, default=12_000)
    parser.add_argument("--selected", type=int, default=1000)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None, help="default: the card")
    parser.add_argument("--out", default=None, help="also write the records as JSON here")
    args = parser.parse_args()
    dev = resolve(args.device)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip())
    rng = np.random.default_rng(args.seed)
    eye = np.eye(10, dtype=np.float32)
    train_x = rng.random((args.rows, 28, 28, 1), np.float32)
    train_y = eye[rng.integers(0, 10, args.rows)]
    selections = [(rng.random((args.selected, 28, 28, 1), np.float32),
                   eye[rng.integers(0, 10, args.selected)], 1000 + i)
                  for i in range(args.members)]
    model = MnistConvNet()
    cfg = TrainConfig(batch_size=128, epochs=args.epochs, learning_rate=1e-3,
                      validation_split=0.1)

    for route in ROUTES.values():  # warm-up: cuDNN's algorithm choice, allocator
        route(model, cfg, train_x, train_y, selections[:1], dev)
    records, trees = [], {}
    for name in ("host", "ensemble", "ensemble", "host"):
        synchronize(dev)
        t0 = time.perf_counter()
        out = ROUTES[name](model, cfg, train_x, train_y, selections, dev)
        synchronize(dev)
        seconds = time.perf_counter() - t0
        epoch_s = sum(r["seconds"] for _, history in out for r in history)
        record = {"route": name, "members": len(out), "seconds": seconds,
                  "per_member_s": seconds / len(out), "epochs_s": epoch_s,
                  "preparation_s": seconds - epoch_s,
                  "steps": out[0][1][0]["steps"], "device": str(dev)}
        print(json.dumps(record))
        records.append(record)
        trees.setdefault(name, [tree for tree, _ in out])
    diffs = [_max_diff(a, b) for a, b in zip(trees["host"], trees["ensemble"])]
    print(json.dumps({"max_abs_param_diff": max(diffs), "per_member": diffs}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"turns": records, "param_diffs": diffs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
