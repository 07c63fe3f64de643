"""Chip smoke test of the PyTorch/H100 port: builds the CUDA kernels, holds
each against its plain PyTorch version, and runs the MNIST ``test_prio``
slice end to end at full width and full MNIST sizes.

    python3 chip_smoke.py [--seed 0] [--out chiprun_out/chip_smoke.json]

Needs one CUDA card; exits non-zero without one (and without the
``simple_tip_tpu_torch`` package beside it). Phases:

1. build both kernels with ``nvcc`` for sm_90a (build seconds printed);
2. per kernel, at the main path's shapes: max error against the plain
   version (fused forward: max |dp| <= 1e-5 over 10,000 images; DSA nearest:
   min d2 within rtol 1e-4, argmins equal or, where they differ, the two
   rows' exact distances within rtol 1e-4), and the times of the kernel,
   the plain version and one library call used as a yardstick only (the
   module forward; ``torch.cdist`` with a masked min);
3. the slice (``engine.eval_prioritization.evaluate``) on 60,000 training
   and 10,000 + 10,000 test images with the launch counters set to 0 just
   before and read just after; every artifact is checked for the JAX
   package's name, dtype and shape, every CAM order for being a permutation;
4. the slice on a small subset on the card and on the CPU (the plain
   versions), compared artifact by artifact.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``. Inputs and weights are made
with numpy from ``--seed``: class prototypes (a bright 8x8 stamp per class)
plus noise, and glorot-uniform weights in the flax layout sent through the
bridge.
"""

import argparse
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from simple_tip_tpu_torch import _build
from simple_tip_tpu_torch.bridge import glorot_params, params_from_jax
from simple_tip_tpu_torch.config import subdir
from simple_tip_tpu_torch.engine import eval_prioritization
from simple_tip_tpu_torch.device import resolve
from simple_tip_tpu_torch.models import MnistConvNet
from simple_tip_tpu_torch.ops import dsa_cuda, fused_forward
from simple_tip_tpu_torch.ops.apfd import apfd_from_order

N_TRAIN, N_TEST = 60_000, 10_000
SMALL_TRAIN, SMALL_TEST = 2_000, 500
NC_LAYERS, SA_LAYERS = [0, 1, 2, 3], [3]
PEAK_F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
UNCERTAINTIES = ("softmax", "pcs", "softmax_entropy", "deep_gini")
NC_METRICS = (
    "NBC_0", "NBC_0.5", "NBC_1", "SNAC_0", "SNAC_0.5", "SNAC_1",
    "NAC_0", "NAC_0.75", "TKNC_1", "TKNC_2", "TKNC_3", "KMNC_2",
)
NEURONS = 26 * 26 * 32 + 13 * 13 * 32 + 11 * 11 * 64 + 5 * 5 * 64


def make_data(seed: int):
    """(train x, y), (nominal x, y), (ood x, y): stamp prototypes plus noise."""
    rng = np.random.default_rng(seed)
    protos = np.zeros((10, 28, 28, 1), np.float32)
    for c in range(10):
        r, col = rng.integers(0, 20, 2)
        protos[c, r : r + 8, col : col + 8] = 1.0

    def draw(n, noise):
        y = rng.integers(0, 10, size=n)
        x = protos[y] + rng.normal(0, noise, size=(n, 28, 28, 1)).astype(np.float32)
        return np.clip(x, 0, 1).astype(np.float32), y

    return draw(N_TRAIN, 0.2), draw(N_TEST, 0.2), draw(N_TEST, 0.45)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: float, nbytes: float):
    """(least milliseconds at the published peaks, what bounds them)."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_fused_forward(params, x_test: np.ndarray, dev) -> dict:
    """B1 against its plain version on the nominal test set."""
    fused = {k: v.to(dev) for k, v in params["fused"].items()}
    net = MnistConvNet().to(dev).eval()
    net.load_state_dict(params["module"])
    x = torch.from_numpy(x_test).to(dev)
    got = fused_forward.fused_mnist_probs(fused, x)
    want = fused_forward.fused_mnist_probs_plain(fused, x)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"fused forward disagrees with its plain version: {err}")
    with torch.no_grad():
        ms = cuda_ms(lambda: fused_forward.fused_mnist_probs(fused, x), 20)
        plain_ms = cuda_ms(lambda: fused_forward.fused_mnist_probs_plain(fused, x), 5)
        library_ms = cuda_ms(lambda: net(x), 20)
    b = x.shape[0]
    flops = b * 2 * (26 * 26 * 32 * 9 + 10 * 10 * 64 * 288 + 1600 * 10)
    nbytes = b * (784 + 10) * 4 + sum(t.numel() * 4 for t in fused.values())
    bound, by = bound_ms(flops, nbytes)
    return {
        "name": "fused_mnist_forward",
        "route": "cuda",
        "source": "simple_tip_tpu_torch/csrc/fused_mnist_forward.cu",
        "replaces": "simple_tip_tpu/ops/fused_forward.py:60",
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": library_ms,
    }


def _cdist_nearest(x, labels, train, train_labels, want_same):
    d2 = torch.cdist(x, train).square_()
    same = labels[:, None] == train_labels[None, :]
    return torch.where(same if want_same else ~same, d2, torch.inf).min(dim=1)


def check_dsa_nearest(params, x_train, x_test, dev) -> dict:
    """B2 against its plain version: both searches of one DSA score call
    (same class from the test traces, other class from their nearest
    training traces) at the path's shapes."""
    from simple_tip_tpu_torch.engine.model_handler import BaseModel
    from simple_tip_tpu_torch.ops.surprise import DSA

    model = BaseModel(MnistConvNet(), params, SA_LAYERS, include_last_layer=True,
                      batch_size=1024, device=dev)
    train_ats, train_probs = model.get_activations(x_train)
    test_ats, test_probs = model.get_activations(x_test)
    train_pred = train_probs.argmax(1)
    classes = int(torch.unique(train_pred).numel())
    print(f"seeded model predicts {classes} classes on the training set")
    if classes < 2:
        raise AssertionError("DSA's other-class distance needs two predicted classes")
    dsa = DSA(train_ats, train_pred, subsampling=0.3)
    x = test_ats.reshape(test_ats.shape[0], -1).contiguous()
    labels = test_probs.argmax(1).to(torch.int32)
    closest = None
    worst = 0.0
    times = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    for want_same in (True, False):
        q = x if want_same else closest
        args = (q, labels, dsa.train, dsa.train_sq, dsa.train_labels, want_same)
        got_min, got_arg = dsa_cuda.masked_nearest(*args)
        want_min, want_arg = dsa_cuda.masked_nearest_plain(*args)
        finite = torch.isfinite(want_min)
        if not torch.equal(finite, torch.isfinite(got_min)):
            raise AssertionError("DSA nearest: masked rows differ")
        rel = ((got_min - want_min).abs() / want_min.abs().clamp_min(1e-30))[finite]
        if rel.numel() and float(rel.max()) > 1e-4:
            raise AssertionError(f"DSA nearest: min d2 off by {float(rel.max())} relative")
        worst = max(worst, float((got_min - want_min)[finite].abs().max()) if finite.any() else 0.0)
        differ = (got_arg != want_arg) & finite
        if differ.any():
            rows = q[differ].double()
            d_got = (rows - dsa.train[got_arg[differ].long()].double()).square().sum(1)
            d_want = (rows - dsa.train[want_arg[differ].long()].double()).square().sum(1)
            gap = float(((d_got - d_want).abs() / d_want.clamp_min(1e-30)).max())
            if gap > 1e-4:
                raise AssertionError(f"DSA nearest: differing argmins {gap} apart")
        print(f"dsa_nearest want_same={want_same}: {int(differ.sum())} argmins differ "
              "(near ties within rtol 1e-4)")
        times["ms"] += cuda_ms(lambda: dsa_cuda.masked_nearest(*args), 3)
        times["plain_ms"] += cuda_ms(lambda: dsa_cuda.masked_nearest_plain(*args), 2)
        times["library_ms"] += cuda_ms(
            lambda: _cdist_nearest(q, labels, dsa.train, dsa.train_labels, want_same), 2)
        if want_same:
            closest = dsa.train.index_select(0, want_arg.long())
    c, d = x.shape
    n = dsa.train.shape[0]
    # The two searches together need every (query, training row) pair once:
    # the same-class pairs in the first, the other-class pairs in the second.
    flops = 2 * c * n * d
    nbytes = 2 * ((c + n) * d * 4 + (c + n) * 8 + c * 8)
    bound, by = bound_ms(flops, nbytes)
    return {
        "name": "dsa_nearest",
        "route": "cuda",
        "source": "simple_tip_tpu_torch/csrc/dsa_nearest.cu",
        "replaces": "simple_tip_tpu/ops/dsa_pallas.py:42",
        "max_abs_err": worst,
        **times,
        "bound_ms": bound,
        "bound_by": by,
    }


def expected_artifacts(n: int):
    """{file suffix: (dtype, shape)} the JAX package writes per dataset."""
    def score_dtype(bits):  # sum_score's smallest integer type for the max
        return np.dtype(np.int16 if bits <= np.iinfo(np.int16).max else np.int32)

    nc_dtype = {m: score_dtype(NEURONS * (2 if m[:3] in ("NBC", "KMN") else 1))
                for m in NC_METRICS}
    out = {"is_misclassified": (np.dtype(bool), (n,))}
    for u in UNCERTAINTIES:
        out[f"uncertainty_{u}"] = (np.dtype(np.float32), (n,))
    out["uncertainty_VR"] = (np.dtype(np.float64), (n,))
    for m in NC_METRICS:
        out[f"{m}_scores"] = (nc_dtype[m], (n,))
        out[f"{m}_cam_order"] = (np.dtype(np.int64), (n,))
    out["dsa_scores"] = (np.dtype(np.float64), (n,))
    out["dsa_cam_order"] = (np.dtype(np.int64), (n,))
    return out


def read_artifacts(n: int):
    """Load and check every artifact and time record of model 0.

    Returns ``({(ds, suffix): array}, {ds: {metric: [setup, pred, quant, cam]}})``.
    """
    found, records = {}, {}
    for ds in ("nominal", "ood"):
        for suffix, (dtype, shape) in expected_artifacts(n).items():
            path = os.path.join(subdir("priorities"), f"mnist_{ds}_0_{suffix}.npy")
            a = np.load(path)
            if a.dtype != dtype or a.shape != shape:
                raise AssertionError(f"{path}: {a.dtype}{a.shape}, want {dtype}{shape}")
            if suffix.endswith("cam_order") and not np.array_equal(np.sort(a), np.arange(n)):
                raise AssertionError(f"{path} is not a permutation")
            if a.dtype.kind == "f" and not suffix.startswith("dsa") and not np.isfinite(a).all():
                raise AssertionError(f"{path} has non-finite values")
            found[(ds, suffix)] = a
        records[ds] = {}
        for metric in (*UNCERTAINTIES, "VR", *NC_METRICS, "dsa"):
            path = os.path.join(subdir("times"), f"mnist_{ds}_0_{metric}")
            with open(path, "rb") as f:
                rec = [float(v) for v in pickle.load(f)]
            if len(rec) != 4:
                raise AssertionError(f"{path}: time record {rec} is not [setup, pred, quant, cam]")
            records[ds][metric] = rec
    return found, records


def run_slice(params, data, dev, root: str):
    """evaluate() into ``root``; returns (phase seconds, artifacts, time records)."""
    (x_tr, _), (x_nom, y_nom), (x_ood, y_ood) = data
    os.environ["TIP_ASSETS"] = root
    phases = eval_prioritization.evaluate(
        model_id=0, case_study="mnist", model_def=MnistConvNet(), params=params,
        training_dataset=x_tr, nominal_test_dataset=x_nom, nominal_test_labels=y_nom,
        ood_test_dataset=x_ood, ood_test_labels=y_ood,
        nc_activation_layers=NC_LAYERS, sa_activation_layers=SA_LAYERS,
        batch_size=128, device=dev,
    )
    return (phases, *read_artifacts(x_nom.shape[0]))


def compare_small(card: dict, cpu: dict) -> dict:
    """Card against CPU (plain versions) on the small subset."""
    report = {}
    for (ds, suffix), a in card.items():
        b = cpu[(ds, suffix)]
        if suffix == "is_misclassified":
            if not np.array_equal(a, b):
                raise AssertionError(f"{ds} predictions differ between card and CPU")
        elif suffix.startswith("uncertainty_") and suffix != "uncertainty_VR":
            err = float(np.abs(a - b).max())
            if err > 1e-5:
                raise AssertionError(f"{ds} {suffix}: card vs CPU {err} > 1e-5")
        elif suffix == "dsa_scores":
            fin = np.isfinite(b)
            if not np.array_equal(fin, np.isfinite(a)):
                raise AssertionError(f"{ds} dsa: non-finite entries differ")
            rel = float((np.abs(a[fin] - b[fin]) / np.abs(b[fin]).clip(1e-30)).max())
            if rel > 1e-4:
                raise AssertionError(f"{ds} dsa: card vs CPU rtol {rel} > 1e-4")
        elif suffix.endswith("_scores"):
            # cuDNN and the CPU sum the convolutions in other orders; an
            # activation within float32 rounding of a threshold can flip
            # one coverage bit, and with it a score by 1.
            diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
            report[f"{ds}_{suffix}_rows_differing"] = int((diff > 0).sum())
            if diff.max() > 2 or (diff > 0).mean() > 0.01:
                raise AssertionError(f"{ds} {suffix}: card vs CPU {int(diff.max())} apart")
    return report


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None, help="also write the full record as JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = resolve(None)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.build()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"build_s {build_s:.3f}")
    print(_build.build_log())

    params = params_from_jax(glorot_params(args.seed))
    t0 = time.perf_counter()
    data = make_data(args.seed)
    print(f"data_s {time.perf_counter() - t0:.3f}")
    (x_tr, _), (x_nom, _), _ = data

    kernels = [check_fused_forward(params, x_nom, dev), check_dsa_nearest(params, x_tr, x_nom, dev)]

    root = tempfile.mkdtemp(prefix="tip_chip_smoke_")
    try:
        fused_forward.LAUNCHES = 0
        dsa_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        phases, art, records = run_slice(params, data, dev, os.path.join(root, "full"))
        slice_s = time.perf_counter() - t0
        launches = {"fused_mnist_forward": fused_forward.LAUNCHES, "dsa_nearest": dsa_cuda.LAUNCHES}
        for k in kernels:
            k["launches"] = launches[k["name"]]
            if k["launches"] <= 0:
                raise AssertionError(f"{k['name']} was not launched on the main path")
        print(json.dumps({"slice_s": slice_s, "phases_s": phases}))
        print(json.dumps({"time_records": records}))
        apfd = {}
        for ds in ("nominal", "ood"):
            faults = art[(ds, "is_misclassified")]
            apfd[f"{ds}_deep_gini"] = apfd_from_order(
                faults, np.argsort(-art[(ds, "uncertainty_deep_gini")], kind="stable"))
            apfd[f"{ds}_dsa"] = apfd_from_order(faults, art[(ds, "dsa_cam_order")])
            apfd[f"{ds}_NAC_0.75"] = apfd_from_order(faults, art[(ds, "NAC_0.75_cam_order")])
        print(json.dumps({"apfd": apfd}))

        small = (
            (data[0][0][:SMALL_TRAIN], data[0][1][:SMALL_TRAIN]),
            (data[1][0][:SMALL_TEST], data[1][1][:SMALL_TEST]),
            (data[2][0][:SMALL_TEST], data[2][1][:SMALL_TEST]),
        )
        _, card_art, _ = run_slice(params, small, dev, os.path.join(root, "small_card"))
        _, cpu_art, _ = run_slice(params, small, torch.device("cpu"), os.path.join(root, "small_cpu"))
        small_report = compare_small(card_art, cpu_art)
        print(json.dumps({"small_card_vs_cpu": small_report}))
    finally:
        shutil.rmtree(root, ignore_errors=True)

    print(json.dumps({"kernels": kernels}))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"gpu": smi, "build_s": build_s, "kernels": kernels, "slice_s": slice_s,
                       "phases_s": phases, "time_records": records, "apfd": apfd,
                       "small": small_report},
                      f, indent=1)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
