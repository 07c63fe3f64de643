"""Chip smoke test of the PyTorch/H100 port: builds the CUDA kernels, holds
each against its plain PyTorch version, and runs the ``test_prio`` slice end
to end for the three model families at full width and full dataset sizes.

    python3 chip_smoke.py [--seed 0] [--out chiprun_out/chip_smoke.json]

Needs one CUDA card; exits non-zero without one (and without the
``simple_tip_tpu_torch`` package beside it). Phases:

1. build the four kernels with ``nvcc`` for sm_90a (one process per source,
   all started together; build seconds printed);
2. per kernel, at its main path's shapes: max error against the plain
   version, and the times of the kernel, the plain version and one library
   call used as a yardstick only:
   - B1 fused MNIST forward: max |dp| <= 1e-5 over 10,000 images (library:
     the module forward, cuDNN);
   - B2 DSA nearest, on each path's own DSA (its training subsample, its
     nominal test traces, its badges: MNIST 10,000 queries x 18,000 rows x
     1,600 features, CIFAR-10 10,000 x 15,000 x 2,304, IMDB 500-query
     badges x 7,500 x 20): min d2 within rtol 1e-4, argmins equal or, where
     they differ, the two rows' exact distances within rtol 1e-4 (library:
     ``torch.cdist`` with a masked min); timed per score call, and summed
     over the score calls the paths made;
   - B3 fused CIFAR-10 forward: max |dp| <= 1e-5 over 10,000 images
     (library: the module forward, cuDNN);
   - B4 flash attention: out and lse within atol 1e-5 + rtol 1e-5 on the
     q/k/v of a real IMDB forward over one prediction batch and on a ragged
     shape (T=300, dh=8) (library: ``scaled_dot_product_attention``);
3. per path (MNIST 60,000 / 10,000 / 10,000; CIFAR-10 50,000 / 10,000 /
   10,000; IMDB 25,000 / 25,000 / 25,000 with ``dsa_badge_size=500``), the
   slice (``engine.eval_prioritization.evaluate``) with every launch counter
   set to 0 just before and read just after: each kernel of the path must
   have launched; every artifact is checked for the JAX package's name,
   dtype and shape, every CAM order for being a permutation; APFD of
   deep_gini, dsa and NAC_0.75 is printed;
4. per path, the slice on a small subset on the card and on the CPU (the
   plain versions), compared artifact by artifact.

Prints the card's name and power limit, per-path seconds, one
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": {...}}``.
Inputs and weights are made with numpy from ``--seed``: MNIST stamp
prototypes plus noise; the CIFAR-10 and IMDB stand-ins of
``data/synthetic.py`` (their OOD sets through its corruptors); glorot-uniform
weights in the flax layout sent through the bridge. The seeded IMDB head
predicts one class for some seeds, so its ``Dense_1`` bias is centred on the
median logit gap over training inputs (``centre_imdb_head``).
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
import torch.nn.functional as F

from simple_tip_tpu_torch import _build
from simple_tip_tpu_torch.bridge import glorot_params, params_from_jax
from simple_tip_tpu_torch.config import subdir
from simple_tip_tpu_torch.data import synthetic
from simple_tip_tpu_torch.device import resolve
from simple_tip_tpu_torch.engine import eval_prioritization
from simple_tip_tpu_torch.engine.model_handler import BaseModel
from simple_tip_tpu_torch.engine.surprise_handler import SA_VARIANTS
from simple_tip_tpu_torch.models import Cifar10ConvNet, ImdbTransformer, MnistConvNet
from simple_tip_tpu_torch.models.predict import PREDICT_BATCH, predict, to_device
from simple_tip_tpu_torch.ops import dsa_cuda, flash_attention, fused_forward
from simple_tip_tpu_torch.ops.apfd import apfd_from_order

SMALL_TRAIN, SMALL_TEST = 2_000, 500
PEAK_F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
UNCERTAINTIES = ("softmax", "pcs", "softmax_entropy", "deep_gini")
NC_METRICS = (
    "NBC_0", "NBC_0.5", "NBC_1", "SNAC_0", "SNAC_0.5", "SNAC_1",
    "NAC_0", "NAC_0.75", "TKNC_1", "TKNC_2", "TKNC_3", "KMNC_2",
)
# Per path: model, (train, nominal, ood) sizes, NC and SA taps, DSA badge,
# batch size (the JAX case study's prediction badge), coverage neurons of
# the NC taps, and the kernels the path must launch.
PATHS = {
    "mnist": dict(
        model=MnistConvNet, sizes=(60_000, 10_000, 10_000), nc=[0, 1, 2, 3], sa=[3],
        dsa_badge=None, batch=128,
        neurons=26 * 26 * 32 + 13 * 13 * 32 + 11 * 11 * 64 + 5 * 5 * 64,
        kernels=("fused_mnist_forward", "dsa_nearest"),
    ),
    "cifar10": dict(
        model=Cifar10ConvNet, sizes=(50_000, 10_000, 10_000), nc=[0, 1, 2, 3], sa=[3],
        dsa_badge=None, batch=32,
        neurons=30 * 30 * 32 + 15 * 15 * 32 + 13 * 13 * 64 + 6 * 6 * 64,
        kernels=("fused_cifar10_forward", "dsa_nearest"),
    ),
    "imdb": dict(
        model=ImdbTransformer, sizes=(25_000, 25_000, 25_000), nc=[3, 5], sa=[5],
        dsa_badge=500, batch=600, neurons=32 + 20,
        kernels=("flash_attention_fwd", "dsa_nearest"),
    ),
}
COUNTERS = {
    "fused_mnist_forward": (fused_forward, "LAUNCHES"),
    "fused_cifar10_forward": (fused_forward, "CIFAR_LAUNCHES"),
    "dsa_nearest": (dsa_cuda, "LAUNCHES"),
    "flash_attention_fwd": (flash_attention, "LAUNCHES"),
}


def zero_counters() -> None:
    for module, attr in COUNTERS.values():
        setattr(module, attr, 0)


def read_counters() -> dict:
    return {name: getattr(module, attr) for name, (module, attr) in COUNTERS.items()}


def make_mnist_data(seed: int, sizes):
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

    n_train, n_test, n_ood = sizes
    return draw(n_train, 0.2), draw(n_test, 0.2), draw(n_ood, 0.45)


def make_data(family: str, seed: int):
    """(train x, y), (nominal x, y), (ood x, y) for one path at its sizes."""
    n_train, n_test, n_ood = PATHS[family]["sizes"]
    if family == "mnist":
        return make_mnist_data(seed, (n_train, n_test, n_ood))
    if family == "cifar10":
        train, test = synthetic.image_classification(seed, n_train, n_test, (32, 32, 3))
        ood = synthetic.corrupt_images(test[0][:n_ood], seed + 1)
    else:
        train, test = synthetic.token_classification(seed, n_train, n_test)
        ood = synthetic.corrupt_tokens(test[0][:n_ood], seed + 1)
    return train, test, (ood, test[1][:n_ood])


def centre_imdb_head(params: dict, x_train: np.ndarray) -> float:
    """Centre the seeded IMDB ``Dense_1`` bias on the median logit gap.

    Random weights give every input nearly the same pooled features, so a
    seeded head can predict one class for everything, and DSA's
    other-class distance needs two predicted classes. A CPU forward (the
    plain versions) over up to 2,000 training inputs finds the median gap
    between the two logits; the bias is shifted by half of it each way, so
    about half the inputs go to each class. Returns the shift.
    """
    net = ImdbTransformer().eval()
    net.load_state_dict(params_from_jax(params)["module"])
    with torch.no_grad():
        _, taps = net(to_device(x_train[:2000], torch.device("cpu")))
    bias = params["Dense_1"]["bias"]
    logits = taps[6].numpy() @ params["Dense_1"]["kernel"] + bias
    gap = float(np.median(logits[:, 1] - logits[:, 0]))
    params["Dense_1"]["bias"] = (bias + np.float32(gap / 2) * np.array([1, -1], np.float32)).astype(np.float32)
    return gap


def predicted_classes(family: str, params, x: np.ndarray, dev) -> list:
    """Counts of each predicted class on ``x`` (DSA needs at least two)."""
    model = BaseModel(PATHS[family]["model"](), params, device=dev)
    probs = predict(model.net, model.fused, x, dev)
    counts = torch.bincount(probs.argmax(1), minlength=probs.shape[1]).tolist()
    print(f"{family}: seeded model predicts classes {counts} on {x.shape[0]} training inputs")
    if sum(1 for c in counts if c) < 2:
        raise AssertionError(f"{family}: DSA's other-class distance needs two predicted classes")
    return counts


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


def _module(family: str, params, dev):
    net = PATHS[family]["model"]().to(dev).eval()
    net.load_state_dict(params["module"])
    return net


def check_fused_forward(params, x_test: np.ndarray, dev) -> dict:
    """B1 against its plain version on the nominal test set."""
    fused = {k: v.to(dev) for k, v in params["fused"].items()}
    net = _module("mnist", params, dev)
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
        "timed": f"one launch over the {b} nominal test images",
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": library_ms,
    }


def check_cifar10_forward(params, x_test: np.ndarray, dev) -> dict:
    """B3 against its plain version on the nominal test set."""
    fused = {k: v.to(dev) for k, v in params["fused"].items()}
    net = _module("cifar10", params, dev)
    x = torch.from_numpy(x_test).to(dev)
    got = fused_forward.fused_cifar10_probs(fused, x)
    want = fused_forward.fused_cifar10_probs_plain(fused, x)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"CIFAR-10 fused forward disagrees with its plain version: {err}")
    with torch.no_grad():
        ms = cuda_ms(lambda: fused_forward.fused_cifar10_probs(fused, x), 10)
        plain_ms = cuda_ms(lambda: fused_forward.fused_cifar10_probs_plain(fused, x), 3)
        library_ms = cuda_ms(lambda: net(x), 10)
    b = x.shape[0]
    # FMAs at the positions the pools keep: conv1 30x30, conv2 12x12,
    # conv3 4x4, two dense layers.
    flops = b * 2 * (
        30 * 30 * 32 * 27 + 12 * 12 * 64 * 288 + 4 * 4 * 64 * 576 + 1024 * 64 + 64 * 10
    )
    nbytes = b * (3072 + 10) * 4 + sum(t.numel() * 4 for t in fused.values())
    bound, by = bound_ms(flops, nbytes)
    return {
        "name": "fused_cifar10_forward",
        "route": "cuda",
        "source": "simple_tip_tpu_torch/csrc/fused_cifar10_forward.cu",
        "replaces": "simple_tip_tpu/ops/fused_forward.py:153",
        "timed": f"one launch over the {b} nominal test images",
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


def check_dsa_nearest(family: str, params, x_train, x_test, dev) -> dict:
    """B2 against its plain version on one path's own DSA: the path's
    scorer (``SA_VARIANTS["dsa"]``, its subsample and badge) fitted on the
    path's training traces and run over its nominal test traces, every
    badge checked; both searches of one score call (same class from the
    test traces, other class from their nearest training traces) timed on
    the first badge. Returns the per-path record, times per score call."""
    cfg = PATHS[family]
    model = BaseModel(cfg["model"](), params, cfg["sa"], include_last_layer=True,
                      batch_size=1024, device=dev)
    train_outs = model.get_activations(x_train)
    test_outs = model.get_activations(x_test)
    dsa = SA_VARIANTS["dsa"](train_outs[:-1], train_outs[-1].argmax(1), cfg["dsa_badge"])
    x = dsa.traces(test_outs[:-1])
    labels = test_outs[-1].argmax(1).to(torch.int32)
    chunk = dsa.badge_size or x.shape[0]
    worst, differing = 0.0, 0
    times = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    for start in range(0, x.shape[0], chunk):
        xc, lc = x[start : start + chunk], labels[start : start + chunk]
        closest = None
        for want_same in (True, False):
            q = xc if want_same else closest
            args = (q, lc, dsa.rows, dsa.rows_sq, dsa.train_labels, want_same)
            got_min, got_arg = dsa_cuda.masked_nearest(*args)
            want_min, want_arg = dsa_cuda.masked_nearest_plain(*args)
            finite = torch.isfinite(want_min)
            if not torch.equal(finite, torch.isfinite(got_min)):
                raise AssertionError(f"DSA nearest ({family}): masked rows differ")
            rel = ((got_min - want_min).abs() / want_min.abs().clamp_min(1e-30))[finite]
            if rel.numel() and float(rel.max()) > 1e-4:
                raise AssertionError(
                    f"DSA nearest ({family}): min d2 off by {float(rel.max())} relative")
            if finite.any():
                worst = max(worst, float((got_min - want_min)[finite].abs().max()))
            differ = (got_arg != want_arg) & finite
            differing += int(differ.sum())
            if differ.any():
                rows = q[differ].double()
                d_got = (rows - dsa.rows[got_arg[differ].long()].double()).square().sum(1)
                d_want = (rows - dsa.rows[want_arg[differ].long()].double()).square().sum(1)
                gap = float(((d_got - d_want).abs() / d_want.clamp_min(1e-30)).max())
                if gap > 1e-4:
                    raise AssertionError(f"DSA nearest ({family}): differing argmins {gap} apart")
            if start == 0:
                times["ms"] += cuda_ms(lambda: dsa_cuda.masked_nearest(*args), 3)
                times["plain_ms"] += cuda_ms(lambda: dsa_cuda.masked_nearest_plain(*args), 2)
                times["library_ms"] += cuda_ms(
                    lambda: _cdist_nearest(q, lc, dsa.rows, dsa.train_labels, want_same), 2)
            if want_same:
                closest = dsa.rows.index_select(0, want_arg.long())
    c = min(chunk, x.shape[0])
    n, d = dsa.rows.shape
    print(f"dsa_nearest {family}: {differing} argmins differ over {x.shape[0]} queries "
          "(near ties within rtol 1e-4)")
    # The two searches together need every (query, training row) pair once:
    # the same-class pairs in the first, the other-class pairs in the second.
    flops = 2 * c * n * d
    nbytes = 2 * ((c + n) * d * 4 + (c + n) * 8 + c * 8)
    bound, by = bound_ms(flops, nbytes)
    return {"queries_per_call": c, "train_rows": n, "features": d,
            "max_abs_err": worst, **times, "bound_ms": bound, "bound_by": by}


def dsa_nearest_entry(by_path: dict, launches: dict) -> dict:
    """B2's kernels-line entry: per path, its record (times per score call,
    two launches each) beside its launches on the main path; at the top,
    the sums over the score calls that the main paths made, so ``ms`` and
    ``launches`` describe the same work."""
    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    ops_ms = 0.0
    for family, rec in by_path.items():
        rec["launches"] = launches[family]
        calls = launches[family] / 2
        for key in total:
            total[key] += calls * rec[key]
        ops_ms += calls * rec["bound_ms"] * (rec["bound_by"] == "operations")
    return {
        "name": "dsa_nearest",
        "route": "cuda",
        "source": "simple_tip_tpu_torch/csrc/dsa_nearest.cu",
        "replaces": "simple_tip_tpu/ops/dsa_pallas.py:42",
        "launches": sum(launches.values()),
        "max_abs_err": max(rec["max_abs_err"] for rec in by_path.values()),
        **total,
        "bound_by": "operations" if 2 * ops_ms >= total["bound_ms"] else "bytes",
        "timed": "sum over the main paths' DSA score calls of each path's time per call",
        "by_path": by_path,
    }


def _attention_close(got, want, what: str) -> float:
    """Max |got - want|; raises unless |got - want| <= 1e-5 + 1e-5 |want|."""
    excess = float(((got - want).abs() - 1e-5 * want.abs()).max())
    if excess > 1e-5:
        raise AssertionError(f"flash attention {what}: off by {excess} beyond rtol 1e-5")
    return float((got - want).abs().max())


def check_flash_attention(params, tokens: np.ndarray, dev, seed: int) -> dict:
    """B4 against its plain version: the q/k/v of a real IMDB forward over
    one prediction batch (timed), and a ragged shape (T=300, dh=8)."""
    net = _module("imdb", params, dev)
    attn = net.block.attention
    with torch.no_grad():
        emb = net.embedding(to_device(tokens[:PREDICT_BATCH], dev))
        b, t, _ = emb.shape
        q, k, v = (p(emb).reshape(b, t, attn.num_heads, attn.head_dim) for p in
                   (attn.query, attn.key, attn.value))
    rng = np.random.default_rng(seed)
    ragged = [torch.from_numpy(rng.normal(size=(4, 300, 2, 8)).astype(np.float32)).to(dev)
              for _ in range(3)]
    err = 0.0
    for name, (qq, kk, vv) in (("imdb", (q, k, v)), ("ragged", ragged)):
        out, lse = flash_attention.flash_attention_fwd(qq, kk, vv)
        want_out, want_lse = flash_attention.flash_attention_plain(qq, kk, vv)
        torch.cuda.synchronize()
        err = max(err, _attention_close(out, want_out, f"{name} out"),
                  _attention_close(lse, want_lse, f"{name} lse"))
    qh, kh, vh = (x.permute(0, 2, 1, 3).contiguous() for x in (q, k, v))
    with torch.no_grad():
        ms = cuda_ms(lambda: flash_attention.flash_attention_fwd(q, k, v), 20)
        plain_ms = cuda_ms(lambda: flash_attention.flash_attention_plain(q, k, v), 5)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), 20)
    h, dh = attn.num_heads, attn.head_dim
    # two products of 2*dh FLOPs per (query, key) pair
    flops = 4 * b * h * t * t * dh
    nbytes = 4 * (4 * b * t * h * dh + b * h * t)
    bound, by = bound_ms(flops, nbytes)
    print(f"flash_attention timed at q/k/v [{b}, {t}, {h}, {dh}]")
    return {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "simple_tip_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "simple_tip_tpu/ops/flash_attention.py:58",
        "timed": f"one launch at one prediction batch, q/k/v [{b}, {t}, {h}, {dh}]",
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": library_ms,
    }


def expected_artifacts(family: str, n: int):
    """{file suffix: (dtype, shape)} the JAX package writes per dataset."""
    neurons = PATHS[family]["neurons"]

    def score_dtype(bits):  # sum_score's smallest integer type for the max
        return np.dtype(np.int16 if bits <= np.iinfo(np.int16).max else np.int32)

    out = {"is_misclassified": (np.dtype(bool), (n,))}
    for u in UNCERTAINTIES:
        out[f"uncertainty_{u}"] = (np.dtype(np.float32), (n,))
    if PATHS[family]["model"].has_dropout:
        out["uncertainty_VR"] = (np.dtype(np.float64), (n,))
    for m in NC_METRICS:
        bits = neurons * (2 if m[:3] in ("NBC", "KMN") else 1)
        out[f"{m}_scores"] = (score_dtype(bits), (n,))
        out[f"{m}_cam_order"] = (np.dtype(np.int64), (n,))
    out["dsa_scores"] = (np.dtype(np.float64), (n,))
    out["dsa_cam_order"] = (np.dtype(np.int64), (n,))
    return out


def read_artifacts(family: str, n: int):
    """Load and check every artifact and time record of model 0.

    Returns ``({(ds, suffix): array}, {ds: {metric: [setup, pred, quant, cam]}})``.
    """
    found, records = {}, {}
    metrics = [*UNCERTAINTIES, *NC_METRICS, "dsa"]
    if PATHS[family]["model"].has_dropout:
        metrics.append("VR")
    for ds in ("nominal", "ood"):
        for suffix, (dtype, shape) in expected_artifacts(family, n).items():
            path = os.path.join(subdir("priorities"), f"{family}_{ds}_0_{suffix}.npy")
            a = np.load(path)
            if a.dtype != dtype or a.shape != shape:
                raise AssertionError(f"{path}: {a.dtype}{a.shape}, want {dtype}{shape}")
            if suffix.endswith("cam_order") and not np.array_equal(np.sort(a), np.arange(n)):
                raise AssertionError(f"{path} is not a permutation")
            if a.dtype.kind == "f" and not suffix.startswith("dsa") and not np.isfinite(a).all():
                raise AssertionError(f"{path} has non-finite values")
            found[(ds, suffix)] = a
        extra = {os.path.basename(p) for p in os.listdir(subdir("priorities"))} - {
            f"{family}_{d}_0_{s}.npy" for d in ("nominal", "ood")
            for s in expected_artifacts(family, n)
        }
        if extra:
            raise AssertionError(f"{family}: unexpected artifacts {sorted(extra)}")
        records[ds] = {}
        for metric in metrics:
            path = os.path.join(subdir("times"), f"{family}_{ds}_0_{metric}")
            with open(path, "rb") as f:
                rec = [float(v) for v in pickle.load(f)]
            if len(rec) != 4:
                raise AssertionError(f"{path}: time record {rec} is not [setup, pred, quant, cam]")
            records[ds][metric] = rec
    return found, records


def run_slice(family: str, params, data, dev, root: str):
    """evaluate() into ``root``; returns (phase seconds, artifacts, time records)."""
    cfg = PATHS[family]
    (x_tr, _), (x_nom, y_nom), (x_ood, y_ood) = data
    if x_ood.shape[0] != x_nom.shape[0]:
        raise AssertionError("the checks assume equal nominal and OOD sizes")
    os.environ["TIP_ASSETS"] = root
    phases = eval_prioritization.evaluate(
        model_id=0, case_study=family, model_def=cfg["model"](), params=params,
        training_dataset=x_tr, nominal_test_dataset=x_nom, nominal_test_labels=y_nom,
        ood_test_dataset=x_ood, ood_test_labels=y_ood,
        nc_activation_layers=cfg["nc"], sa_activation_layers=cfg["sa"],
        dsa_badge_size=cfg["dsa_badge"], batch_size=cfg["batch"], device=dev,
    )
    return (phases, *read_artifacts(family, x_nom.shape[0]))


def compare_small(family: str, card: dict, cpu: dict) -> dict:
    """Card against CPU (plain versions) on the small subset."""
    report = {}
    for (ds, suffix), a in card.items():
        b = cpu[(ds, suffix)]
        if suffix == "is_misclassified":
            if not np.array_equal(a, b):
                raise AssertionError(f"{family} {ds} predictions differ between card and CPU")
        elif suffix.startswith("uncertainty_") and suffix != "uncertainty_VR":
            err = float(np.abs(a - b).max())
            if err > 1e-5:
                raise AssertionError(f"{family} {ds} {suffix}: card vs CPU {err} > 1e-5")
        elif suffix == "dsa_scores":
            fin = np.isfinite(b)
            if not np.array_equal(fin, np.isfinite(a)):
                raise AssertionError(f"{family} {ds} dsa: non-finite entries differ")
            rel = float((np.abs(a[fin] - b[fin]) / np.abs(b[fin]).clip(1e-30)).max())
            if rel > 1e-4:
                raise AssertionError(f"{family} {ds} dsa: card vs CPU rtol {rel} > 1e-4")
        elif suffix.endswith("_scores"):
            # cuDNN (or the attention kernel) and the CPU sum in other
            # orders; an activation within float32 rounding of a threshold
            # can flip one coverage bit, and with it a score by 1.
            diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
            report[f"{ds}_{suffix}_rows_differing"] = int((diff > 0).sum())
            if diff.max() > 2 or (diff > 0).mean() > 0.01:
                raise AssertionError(f"{family} {ds} {suffix}: card vs CPU {int(diff.max())} apart")
    return report


def apfd_report(art: dict) -> dict:
    apfd = {}
    for ds in ("nominal", "ood"):
        faults = art[(ds, "is_misclassified")]
        apfd[f"{ds}_deep_gini"] = apfd_from_order(
            faults, np.argsort(-art[(ds, "uncertainty_deep_gini")], kind="stable"))
        apfd[f"{ds}_dsa"] = apfd_from_order(faults, art[(ds, "dsa_cam_order")])
        apfd[f"{ds}_NAC_0.75"] = apfd_from_order(faults, art[(ds, "NAC_0.75_cam_order")])
    return apfd


def run_path(family: str, params, data, dev, root: str) -> dict:
    """The path at full size with the counters read around it, then the
    small card-against-CPU comparison."""
    zero_counters()
    t0 = time.perf_counter()
    phases, art, records = run_slice(family, params, data, dev, os.path.join(root, family))
    seconds = time.perf_counter() - t0
    launches = read_counters()
    for name in PATHS[family]["kernels"]:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the {family} path")
    apfd = apfd_report(art)
    print(json.dumps({"path": family, "sizes": PATHS[family]["sizes"], "slice_s": seconds,
                      "phases_s": phases, "launches": launches, "apfd": apfd}))
    print(json.dumps({"path": family, "time_records": records}))
    small = (
        (data[0][0][:SMALL_TRAIN], data[0][1][:SMALL_TRAIN]),
        (data[1][0][:SMALL_TEST], data[1][1][:SMALL_TEST]),
        (data[2][0][:SMALL_TEST], data[2][1][:SMALL_TEST]),
    )
    _, card_art, _ = run_slice(family, params, small, dev, os.path.join(root, f"{family}_card"))
    _, cpu_art, _ = run_slice(family, params, small, torch.device("cpu"),
                              os.path.join(root, f"{family}_cpu"))
    small_report = compare_small(family, card_art, cpu_art)
    flips = {k: v for k, v in small_report.items() if v}
    print(json.dumps({"path": family, "small_card_vs_cpu_flips": flips}))
    return {"sizes": PATHS[family]["sizes"], "slice_s": seconds, "phases_s": phases,
            "launches": launches, "apfd": apfd, "time_records": records, "small": small_report}


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

    t0 = time.perf_counter()
    data = {family: make_data(family, args.seed) for family in PATHS}
    print(f"data_s {time.perf_counter() - t0:.3f}")
    flax_trees = {family: glorot_params(args.seed, family) for family in PATHS}
    imdb_gap = centre_imdb_head(flax_trees["imdb"], data["imdb"][0][0])
    print(f"imdb: Dense_1 bias centred on the median logit gap {imdb_gap}")
    params = {family: params_from_jax(tree) for family, tree in flax_trees.items()}
    classes = {family: predicted_classes(family, params[family], data[family][0][0], dev)
               for family in PATHS}

    kernels = [
        check_fused_forward(params["mnist"], data["mnist"][1][0], dev),
        check_cifar10_forward(params["cifar10"], data["cifar10"][1][0], dev),
        check_flash_attention(params["imdb"], data["imdb"][1][0], dev, args.seed),
    ]
    dsa_by_path = {family: check_dsa_nearest(family, params[family], data[family][0][0],
                                             data[family][1][0], dev)
                   for family in PATHS}

    root = tempfile.mkdtemp(prefix="tip_chip_smoke_")
    paths = {}
    try:
        for family in PATHS:
            paths[family] = run_path(family, params[family], data[family], dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"paths_s": {f: p["slice_s"] for f, p in paths.items()},
                      "total_s": sum(p["slice_s"] for p in paths.values())}))

    def launches_by_path(name):
        return {f: p["launches"][name] for f, p in paths.items() if name in PATHS[f]["kernels"]}

    for k in kernels:
        k["launches"] = sum(launches_by_path(k["name"]).values())
    kernels.insert(1, dsa_nearest_entry(dsa_by_path, launches_by_path("dsa_nearest")))
    print(json.dumps({"kernels": kernels}))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"gpu": smi, "build_s": build_s, "kernels": kernels,
                       "imdb_gap": imdb_gap, "classes": classes, "paths": paths}, f, indent=1)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
