"""Chip smoke test of the PyTorch/H100 port: builds the CUDA kernels, holds
each against its plain PyTorch version, trains the three model families at
full width through the port's ``CaseStudy.train``, and runs the
``test_prio`` slice end to end on the trained checkpoints at full dataset
sizes.

    python3 chip_smoke.py [--seed 0] [--out chiprun_out/chip_smoke.json]

Needs one CUDA card; exits non-zero without one (and without the
``simple_tip_tpu_torch`` package beside it). Phases:

1. build the six kernel sources with ``nvcc`` for sm_90a (one process per
   source, all started together; build seconds printed);
2. training (``casestudies.base.CaseStudy.train`` in a temp ``TIP_ASSETS``):
   each family at full width on its full training set (MNIST 60,000,
   CIFAR-10 50,000, IMDB 25,000) with the JAX registry's train configs
   (batch 128 / 32 / 32, lr 1e-3, validation split 0.1), **epochs cut to 1**
   (the registry trains 15 / 20 / 10); MNIST trains runs 0 and 1 (a
   two-member ``train_ensemble``), CIFAR-10 and IMDB run 0. Per run: epoch
   seconds and steps, first-step and mean epoch loss, accuracy on the
   held-out 10% and on the nominal test set; checks: the mean loss is below
   the first step's, accuracy clears its floor (``ACCURACY_FLOOR``), each
   checkpoint reads back byte-equal; the IMDB epoch must launch B4, B5 and
   B6 once a step (704 steps);
3. per kernel, at its main path's shapes and on the trained weights: max
   error against the plain version, and the times of the kernel, the plain
   version and one library call used as a yardstick only:
   - B1 fused MNIST forward: max |dp| <= 1e-5 over 10,000 images (library:
     the module forward, cuDNN), also replayed from a CUDA graph;
   - B2 DSA nearest, on each path's own DSA (its training subsample, its
     nominal test traces, its badges: MNIST 10,000 queries x 18,000 rows x
     1,600 features, CIFAR-10 10,000 x 15,000 x 2,304, IMDB 500-query
     badges x 7,500 x 20) through the DSA's class layout: min d2 within
     rtol 1e-4, argmins equal or, where they differ, the two rows' exact
     distances within rtol 1e-4 (library: ``torch.cdist`` with a masked
     min); timed per score call, and summed over the score calls the paths
     made; the training tiles the score call's two plans visit, against two
     full walks;
   - B3 fused CIFAR-10 forward: max |dp| <= 1e-5 over 10,000 images
     (library: the module forward, cuDNN), also replayed from a CUDA graph;
   - B4 flash attention: out and lse within atol 1e-5 + rtol 1e-5 on the
     q/k/v of a real IMDB forward over one prediction batch and on a ragged
     shape (T=300, dh=8); timed at that batch and at a training step's
     [32, 100, 2, 32] (library: ``scaled_dot_product_attention``'s forward),
     each also replayed from a CUDA graph (the card's time without the
     host's launch cost, which bounds both calls at the step's shape);
   - B5 and B6 flash backward: dq, dk and dv within atol 1e-5 + rtol 1e-4
     (atol cut to 1e-4 of the largest |want|, so that small gradients are
     held too) on the q, k, v and dO (scaled to unit RMS) of a real IMDB
     training step [32, 100, 2, 32], on
     a ragged [4, 300, 2, 8] and at dh=128 [4, 200, 2, 128]; timed at the
     training step and at [8192, 100, 2, 32] (library: the backward of
     ``scaled_dot_product_attention``, dq, dk and dv together), each also
     replayed from a CUDA graph (the card alone) and by the host's own time
     per eager call;
   - B4, B5 and B6 at wide heads, [64, 128, 2, 256] (their wide-head
     variants): out and lse against the plain version as above, dq, dk and
     dv with the backward's checks; timed beside the SDPA forward and
     backward;
   - the IMDB gradients through ``FlashAttention`` at full width (one batch
     of 32, every parameter, ``train=False``) on the card against the CPU
     within rtol 2e-4 / atol 2e-5 (atol cut per leaf to 2e-4 of its largest
     |gradient| plus the f32 rounding floor), with non-zero q/k/v kernel
     gradients;
4. per path (MNIST 60,000 / 10,000 / 10,000; CIFAR-10 50,000 / 10,000 /
   10,000; IMDB 25,000 / 25,000 / 25,000 with ``dsa_badge_size=500``), the
   slice (``engine.eval_prioritization.evaluate``, all 39 approaches with
   the five SA variants) on run 0's trained checkpoint
   (``CaseStudy.load_params`` through the bridge) with every launch counter
   set to 0 just before and read just after: each kernel of the path must
   have launched; every artifact is checked for the JAX package's name,
   dtype and shape, every CAM order for being a permutation, SA scores for
   NaN (and +inf outside dsa and pc-lsa); APFD of deep_gini, dsa and
   NAC_0.75 is printed, then per SA variant its setup and score seconds on
   both datasets and its +inf count, pc-mmdsa's chosen k, and the family's
   row of the APFD table (``plotters/eval_apfd_table``: all 39 approaches,
   nominal and OOD, with their reported times);
5. per path, the slice with DSA on a small subset on the card and on the
   CPU (the plain versions), compared artifact by artifact; then the four
   other SA variants fitted and scored on the card and on the CPU from the
   same traces (``SA_CHECK``: MNIST 20,000 training rows, CIFAR-10 25,000,
   IMDB 2,000; 500 test rows; pc-mlsa on MNIST and CIFAR-10 on 500
   training rows of one class at their 64 features of highest variance,
   since its EM at 1,600 or 2,304 features takes minutes on the CPU and is
   ill-conditioned on so few rows): the same chosen k and ``reg_covar``
   rungs, the same +inf rows, finite scores (and pc-lsa's log densities
   before the exp) within rtol 1e-3, SC-CAM orders equal in all but 5% of
   their positions; on MNIST and CIFAR-10 pc-mlsa is also read at full
   width on one class's rows (``mlsa_full_width``: finite scores and the
   APFD of both sides' SC-CAM orders within 0.02 gated; each side's
   ``reg_covar`` rung, the score gap and SC-CAM moves printed, and the rows
   that move in or out of its top-k and SC-CAM first-k at k = 20% of the
   class's rows, the share that active learning selects);
6. MNIST's active-learning phase (``CaseStudy.run_active_learning_eval``
   on run 0's checkpoint, the launch counters set to 0 just before and
   read just after: B1 and B2 must launch) at full width with the JAX
   registry's observed share 0.5 and 1,000 selected rows, its 80 retrains
   through ``parallel/al_ensemble.py``, with two cuts: **retrains run one
   epoch** (the registry trains 15) and **the AL training base is the
   first 12,000 of the 60,000 training rows**. Checks: the 81 pickles'
   names and layout, every accuracy in [0, 1], the selections' sanity
   checks (inside ``evaluate``), each retrain's one epoch, and the random
   baseline's retrain at ``AL_RANDOM_FLOOR`` on both nominal splits. Prints the seconds of scoring the original model, of
   each selection (FP / NC / SA), of all retrains and per retrain, and of
   scoring the retrained models, and MNIST's row of the AL table
   (``plotters/eval_active_learning_table``);
7. the four selection builders on a small subset (``AL_CHECK``) on the card
   and on the CPU, rows moved per selection counted: the random baseline
   equal; an uncertainty's top-k equal but for rows within 1e-5 of its
   edge; a coverage top-k or CAM first-k equal but where the metric's
   scores differ by the known flipped threshold bits (at most 2 per row,
   1% of rows); an SA top-k equal but for rows within ``SA_RTOL`` of its
   edge, an SC-CAM first-k within ``SA_ORDER_CAP`` of its rows; VR is
   counted only (other generators). The SA builder runs dsa, pc-lsa,
   pc-mdsa and pc-mmdsa: pc-mlsa's CPU fit at 1,600 features takes about
   a minute a class, and its known card/CPU gap is counted at full width
   in phase 5;
8. ``at_collection`` (``CaseStudy.collect_activations``) of MNIST run 0 on
   the first 1,000 rows of each set, on the card and on the CPU: the same
   files, dtypes and shapes, labels byte-equal, each tap within 1e-5 of its
   largest magnitude.

Each kernel's bound is the larger of its bytes at 3.35 TB/s and its FLOPs
at the rate of the unit that does each of its products (``UNITS``): 3xTF32
on the tensor cores (three TF32 products at 495 TF/s) for B2, B4, B5 and
B6, and for B1's conv2 and B3's three convs; float32 FMAs at 67 TF/s for
B1's conv1 and the dense layers of B1 and B3. B1 and B3 also report the
bound with every FMA at 67 TF/s (``f32_bound_ms``), the bound of earlier
kernels that ran on the FMAs alone.

Prints the card's name and power limit, per-run training records, per-path
seconds, one ``{"kernels": [...]}`` line, and last ``{"ok": true, "device":
{...}}``. Inputs are made with numpy from ``--seed``: the MNIST, CIFAR-10
and IMDB stand-ins of ``data/synthetic.py`` (their OOD sets through its
corruptors), whose ambiguous 8% keep a trained model's nominal faults, and
so nominal APFD, defined. Weights are the port's own training on them, from
flax's initializers drawn from the run id.
"""

import argparse
import dataclasses
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
from simple_tip_tpu_torch.bridge import params_from_jax
from simple_tip_tpu_torch.casestudies.base import CaseStudy, CaseStudySpec
from simple_tip_tpu_torch.config import subdir
from simple_tip_tpu_torch.data import synthetic
from simple_tip_tpu_torch.device import resolve
from simple_tip_tpu_torch.engine import eval_active_learning, eval_prioritization
from simple_tip_tpu_torch.engine.model_handler import BaseModel
from simple_tip_tpu_torch.engine.sa_prep import SharedTrainPrep, VariantFitter
from simple_tip_tpu_torch.engine.surprise_handler import SA_VARIANTS, _sc_cam_order
from simple_tip_tpu_torch.models import Cifar10ConvNet, ImdbTransformer, MnistConvNet
from simple_tip_tpu_torch.models.predict import PREDICT_BATCH, predict, to_device
from simple_tip_tpu_torch.models.train import (
    TrainConfig,
    categorical_crossentropy,
    evaluate_accuracy,
    training_rows,
)
from simple_tip_tpu_torch.ops import dsa_cuda, flash_attention, fused_forward
from simple_tip_tpu_torch.ops.apfd import apfd_from_order
from simple_tip_tpu_torch.plotters import eval_active_learning_table, eval_apfd_table, times_collector
from simple_tip_tpu_torch.plotters.utils import APPROACHES
from simple_tip_tpu_torch.utils import checkpoint

SMALL_TRAIN, SMALL_TEST = 2_000, 500
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# The unit that does each kernel's products, and its rate for them: float32
# FMAs outside the tensor cores (67 TF/s), or 3xTF32 on the tensor cores
# (three TF32 products at 495 TF/s, so 165 TF/s of float32-accurate work).
UNITS = {
    "f32": (67e12, "float32 FMAs on the CUDA cores, 67 TF/s"),
    "3xtf32": (495e12 / 3, "3xTF32 on the tensor cores, 3 TF32 products at 495 TF/s"),
}
UNCERTAINTIES = ("softmax", "pcs", "softmax_entropy", "deep_gini")
NC_METRICS = (
    "NBC_0", "NBC_0.5", "NBC_1", "SNAC_0", "SNAC_0.5", "SNAC_1",
    "NAC_0", "NAC_0.75", "TKNC_1", "TKNC_2", "TKNC_3", "KMNC_2",
)
SA_NAMES = tuple(SA_VARIANTS)
NEW_SA = ("pc-lsa", "pc-mdsa", "pc-mlsa", "pc-mmdsa")
# The card-against-CPU check of the four SA variants, on the same traces:
# training rows (more per class than the tap has features, so that MDSA's
# covariances are not singular), test rows, and for pc-mlsa on the convnets
# the rows and features of its one-class check. Its EM at 1,600 or 2,304
# features takes minutes a class on the CPU, and on 500 rows its covariances
# are singular but for the ridge (condition ~1e7), where float32 EM on an
# H100 and on its host's CPU differed by 2.1e-3 to 7.4e-2 over three runs
# on MNIST: so it is gated on one class's 500 training rows at their 64
# features of highest variance, and read at full width apart (below).
# Scores must agree within SA_RTOL (finite rows, equal +inf rows; pc-lsa
# also its log densities before the exp, whose +inf scores leave few
# finite rows), the chosen k and MLSA rungs exactly, and the SC-CAM orders
# in all but SA_ORDER_CAP of their positions.
SA_CHECK = {"mnist": (20_000, 500, (500, 64)), "cifar10": (25_000, 500, (500, 64)),
            "imdb": (2_000, 500, None)}
SA_RTOL = 1e-3
SA_ORDER_CAP = 0.05
# pc-mlsa at full width (``mlsa_full_width``): its EM's float32 Cholesky of
# near-singular covariances fails on one device and not the other near the
# ridge, so even the reg_covar rung can differ (CIFAR-10, 1e-4 on an H100
# against 1e-6 on its host's CPU, scores 5.5x apart); what is gated is the
# APFD of each side's SC-CAM order, within MLSA_APFD_GAP.
MLSA_APFD_GAP = 0.02
# Per path: model, (train, nominal, ood) sizes, NC and SA taps, DSA badge,
# batch size (the JAX case study's prediction badge), coverage neurons of
# the NC taps, the kernels the test_prio path must launch; for training the
# JAX registry's batch size, the runs trained, the classes, and the kernels
# the training epoch must launch once a step.
PATHS = {
    "mnist": dict(
        model=MnistConvNet, sizes=(60_000, 10_000, 10_000), nc=[0, 1, 2, 3], sa=[3],
        dsa_badge=None, batch=128,
        neurons=26 * 26 * 32 + 13 * 13 * 32 + 11 * 11 * 64 + 5 * 5 * 64,
        kernels=("fused_mnist_forward", "dsa_nearest"),
        train_batch=128, runs=[0, 1], classes=10, train_kernels=(),
    ),
    "cifar10": dict(
        model=Cifar10ConvNet, sizes=(50_000, 10_000, 10_000), nc=[0, 1, 2, 3], sa=[3],
        dsa_badge=None, batch=32,
        neurons=30 * 30 * 32 + 15 * 15 * 32 + 13 * 13 * 64 + 6 * 6 * 64,
        kernels=("fused_cifar10_forward", "dsa_nearest"),
        train_batch=32, runs=[0], classes=10, train_kernels=(),
    ),
    "imdb": dict(
        model=ImdbTransformer, sizes=(25_000, 25_000, 25_000), nc=[3, 5], sa=[5],
        dsa_badge=500, batch=600, neurons=32 + 20,
        kernels=("flash_attention_fwd", "dsa_nearest"),
        train_batch=32, runs=[0], classes=2,
        train_kernels=("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"),
    ),
}
# Accuracy a trained run must reach after its one epoch, on the held-out 10%
# and on the nominal test set: well above twice chance (0.2, 0.6). One epoch
# reached 0.954-0.961 on all three (CIFAR-10 and IMDB on an H100, MNIST on
# the CPU); the stand-ins' 8% ambiguous samples cap it near 0.96.
ACCURACY_FLOOR = {"mnist": 0.85, "cifar10": 0.85, "imdb": 0.85}
# MNIST's active-learning phase: the JAX registry's observed share and
# selection size, and the cut of its training
# base (retrains run the paths' one epoch). The random baseline's retrain
# must reach AL_RANDOM_FLOOR on both nominal splits (its 92 steps on the
# cut base; the full-set epoch reaches ACCURACY_FLOOR).
AL_FAMILY = "mnist"
AL_TRAIN_ROWS = 12_000
AL_OBSERVED_SHARE = 0.5
AL_NUM_SELECTED = 1000
AL_RANDOM_FLOOR = 0.7
# The card-against-CPU check of the selection builders: training rows (as
# SA_CHECK's, so that MDSA's covariances are not singular), test rows per
# set (half of them observed), rows selected (20% of the observed, as in the
# AL phase), and the SA variants (pc-mlsa's CPU fit at 1,600 features takes
# about a minute a class; its gap is read at full width in phase 5).
AL_CHECK = (20_000, 500, 50)
AL_CHECK_SA = ("dsa", "pc-lsa", "pc-mdsa", "pc-mmdsa")
AL_UNCERTAINTY_ATOL = 1e-5
# at_collection: rows dumped per set, and the tolerance of each tap (card
# against CPU) relative to the tap's largest magnitude
ACTIVATION_ROWS = 1_000
ACTIVATION_RTOL = 1e-5
COUNTERS = {
    "fused_mnist_forward": (fused_forward, "LAUNCHES"),
    "fused_cifar10_forward": (fused_forward, "CIFAR_LAUNCHES"),
    "dsa_nearest": (dsa_cuda, "LAUNCHES"),
    "flash_attention_fwd": (flash_attention, "LAUNCHES"),
    "flash_attention_bwd_dq": (flash_attention, "BWD_DQ_LAUNCHES"),
    "flash_attention_bwd_dkv": (flash_attention, "BWD_DKV_LAUNCHES"),
}


def zero_counters() -> None:
    for module, attr in COUNTERS.values():
        setattr(module, attr, 0)


def read_counters() -> dict:
    return {name: getattr(module, attr) for name, (module, attr) in COUNTERS.items()}


def make_data(family: str, seed: int):
    """(train x, y), (nominal x, y), (ood x, y) for one path at its sizes."""
    n_train, n_test, n_ood = PATHS[family]["sizes"]
    if family == "imdb":
        train, test = synthetic.token_classification(seed, n_train, n_test)
        ood = synthetic.corrupt_tokens(test[0][:n_ood], seed + 1)
    else:
        shape = (28, 28, 1) if family == "mnist" else (32, 32, 3)
        train, test = synthetic.image_classification(seed, n_train, n_test, shape)
        ood = synthetic.corrupt_images(test[0][:n_ood], seed + 1)
    return train, test, (ood, test[1][:n_ood])


def predicted_classes(family: str, params, x: np.ndarray, dev) -> list:
    """Counts of each predicted class on ``x`` (DSA needs at least two)."""
    model = BaseModel(PATHS[family]["model"](), params, device=dev)
    probs = predict(model.net, model.fused, x, dev)
    counts = torch.bincount(probs.argmax(1), minlength=probs.shape[1]).tolist()
    print(f"{family}: trained run 0 predicts classes {counts} on {x.shape[0]} training inputs")
    if sum(1 for c in counts if c) < 2:
        raise AssertionError(f"{family}: DSA's other-class distance needs two predicted classes")
    return counts


def case_study(family: str, data) -> CaseStudy:
    """The family's case study over this run's data, with the JAX
    registry's train config at one epoch."""
    cfg = PATHS[family]
    return CaseStudy(CaseStudySpec(
        name=family, model_factory=cfg["model"], loader=lambda: data,
        train_cfg=TrainConfig(batch_size=cfg["train_batch"], epochs=1, learning_rate=1e-3,
                              validation_split=0.1),
        nc_activation_layers=tuple(cfg["nc"]), sa_activation_layers=tuple(cfg["sa"]),
        prediction_badge_size=cfg["batch"], num_classes=cfg["classes"],
        dsa_badge_size=cfg["dsa_badge"],
    ))


def train_family(family: str, data, dev) -> tuple:
    """Train the family's runs through ``CaseStudy.train`` with the counters
    read around it; check losses, accuracies and checkpoints. Returns (the
    case study, the record)."""
    cfg = PATHS[family]
    cs = case_study(family, data)
    zero_counters()
    t0 = time.perf_counter()
    histories = cs.train(cfg["runs"], device=dev)
    train_s = time.perf_counter() - t0
    launches = read_counters()
    (x_tr, y_tr), (x_nom, y_nom), _ = data
    n_fit = training_rows(x_tr.shape[0], cs.spec.train_cfg.validation_split)
    runs = {}
    for run in cfg["runs"]:
        [rec] = histories[run]
        if not rec["mean_loss"] < rec["first_loss"]:
            raise AssertionError(f"{family} run {run}: mean epoch loss {rec['mean_loss']} "
                                 f"is not below the first step's {rec['first_loss']}")
        params = cs.load_params(run)
        with open(cs.model_path(run), "rb") as f:
            if checkpoint.to_bytes(params) != f.read():
                raise AssertionError(f"{family} run {run}: the checkpoint does not read back")
        acc = {
            "held_out_accuracy": evaluate_accuracy(cs.model_def, params, x_tr[n_fit:],
                                                   y_tr[n_fit:], dev),
            "test_accuracy": evaluate_accuracy(cs.model_def, params, x_nom, y_nom, dev),
        }
        for name, value in acc.items():
            if not value >= ACCURACY_FLOOR[family]:
                raise AssertionError(f"{family} run {run}: {name} {value} below the floor "
                                     f"{ACCURACY_FLOOR[family]}")
        runs[run] = {**rec, **acc}
    steps = sum(r["steps"] for r in runs.values())
    for name in cfg["train_kernels"]:
        if launches[name] != steps:
            raise AssertionError(f"{family} training launched {name} {launches[name]} times "
                                 f"in {steps} steps")
    record = {"train": family, "rows": n_fit, "batch": cfg["train_batch"], "train_s": train_s,
              "runs": runs, "launches": launches}
    print(json.dumps(record))
    return cs, record


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


def host_ms(fn, reps: int) -> float:
    """Mean milliseconds of the host's own time per call of ``fn()``, the
    calls queued back to back (after a warm-up; the card is waited for only
    after the last)."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(reps):
        fn()
    took = time.perf_counter() - start
    torch.cuda.synchronize()
    return took * 1e3 / reps


def graph_ms(fn, reps: int, stream=None) -> float:
    """Mean milliseconds of ``fn()`` replayed from one CUDA graph of ``reps``
    calls: the card's time alone, without the host's cost of each launch.
    Captured on ``stream`` where given (a backward must be captured on the
    stream of its forward), else on a new one."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
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


def bound_ms(flops: float, nbytes: float, unit: str = "f32"):
    """(least milliseconds at the published peaks, what bounds them), the
    operations counted at the rate of ``unit`` (a key of ``UNITS``)."""
    return mixed_bound_ms([(flops, unit)], nbytes)


def mixed_bound_ms(work, nbytes: float):
    """``bound_ms`` for work done by several units: ``work`` is (FLOPs, key
    of ``UNITS``) pairs, each at its unit's rate, one after another."""
    t_ops = sum(flops / UNITS[unit][0] for flops, unit in work) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _module(family: str, params, dev):
    net = PATHS[family]["model"]().to(dev).eval()
    net.load_state_dict(params["module"])
    return net


def _fused_record(name: str, kernel, plain, net, fused, x, work, replaces: str) -> dict:
    """A fused forward against its plain version on ``x``, max |dp| <= 1e-5,
    and its times: eager, replayed from a CUDA graph, the plain version's and
    the module forward's (cuDNN). ``work`` is its (FLOPs, unit) pairs; the
    bound takes each at its unit's rate, ``f32_bound_ms`` all at 67 TF/s."""
    got = kernel(fused, x)
    want = plain(fused, x)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"{name} disagrees with its plain version: {err}")
    with torch.no_grad():
        ms = cuda_ms(lambda: kernel(fused, x), 20)
        device = graph_ms(lambda: kernel(fused, x), 20)
        plain_ms = cuda_ms(lambda: plain(fused, x), 3)
        library_ms = cuda_ms(lambda: net(x), 20)
    b = x.shape[0]
    # images read and probabilities written once; the plain version's weights once
    nbytes = b * (x[0].numel() + 10) * 4 + sum(
        t.numel() * 4 for k, t in fused.items() if not k.endswith("_tc"))
    bound, by = mixed_bound_ms(work, nbytes)
    f32_bound, f32_by = bound_ms(sum(flops for flops, _ in work), nbytes)
    return {
        "name": name,
        "route": "cuda",
        "source": f"simple_tip_tpu_torch/csrc/{name}.cu",
        "replaces": replaces,
        "timed": f"one launch over the {b} nominal test images",
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "bound_unit": "convolutions in 3xTF32 on the tensor cores (3 TF32 products at 495 "
                      "TF/s); conv1 (B1) and the dense layers on float32 FMAs, 67 TF/s",
        "f32_bound_ms": f32_bound,
        "f32_bound_by": f32_by,
        "library_ms": library_ms,
        "device_ms": device,
    }


def check_fused_forward(params, x_test: np.ndarray, dev) -> dict:
    """B1 against its plain version on the nominal test set."""
    fused = {k: v.to(dev) for k, v in params["fused"].items()}
    x = torch.from_numpy(x_test).to(dev)
    b = x.shape[0]
    # conv1 at all 26x26 positions, conv2 at the 10x10 the floor pool keeps
    work = [(b * 2 * 26 * 26 * 32 * 9, "f32"), (b * 2 * 10 * 10 * 64 * 288, "3xtf32"),
            (b * 2 * 1600 * 10, "f32")]
    return _fused_record("fused_mnist_forward", fused_forward.fused_mnist_probs,
                         fused_forward.fused_mnist_probs_plain, _module("mnist", params, dev),
                         fused, x, work, "simple_tip_tpu/ops/fused_forward.py:60")


def check_cifar10_forward(params, x_test: np.ndarray, dev) -> dict:
    """B3 against its plain version on the nominal test set."""
    fused = {k: v.to(dev) for k, v in params["fused"].items()}
    x = torch.from_numpy(x_test).to(dev)
    b = x.shape[0]
    # the convs at the positions the pools keep: conv1 30x30, conv2 12x12, conv3 4x4
    convs = 30 * 30 * 32 * 27 + 12 * 12 * 64 * 288 + 4 * 4 * 64 * 576
    work = [(b * 2 * convs, "3xtf32"), (b * 2 * (1024 * 64 + 64 * 10), "f32")]
    return _fused_record("fused_cifar10_forward", fused_forward.fused_cifar10_probs,
                         fused_forward.fused_cifar10_probs_plain, _module("cifar10", params, dev),
                         fused, x, work, "simple_tip_tpu/ops/fused_forward.py:153")


def _cdist_nearest(x, labels, train, train_labels, want_same):
    d2 = torch.cdist(x, train).square_()
    same = labels[:, None] == train_labels[None, :]
    return torch.where(same if want_same else ~same, d2, torch.inf).min(dim=1)


def check_dsa_nearest(family: str, params, x_train, x_test, dev) -> dict:
    """B2 against its plain version on one path's own DSA: the path's
    scorer (``SA_VARIANTS["dsa"]``, its subsample and badge) fitted on the
    path's training traces and run over its nominal test traces, every
    badge checked through the DSA's class layout and the DSA's query plan
    per badge (or the full walk, where its searches are too small to plan);
    one score call (the plan, then the same-class search from the test
    traces and the other-class search from their nearest training traces)
    timed on the first badge. Returns the per-path record, times per score
    call."""
    cfg = PATHS[family]
    model = BaseModel(cfg["model"](), params, cfg["sa"], include_last_layer=True,
                      batch_size=1024, device=dev)
    train_outs = model.get_activations(x_train)
    test_outs = model.get_activations(x_test)
    prep = SharedTrainPrep(train_outs[:-1], train_outs[-1].argmax(1).cpu().numpy(), dev)
    dsa = SA_VARIANTS["dsa"](VariantFitter(prep, dev, cfg["dsa_badge"]))
    x = dsa.traces(test_outs[:-1])
    labels = test_outs[-1].argmax(1).to(torch.int32)
    chunk = dsa.badge_size or x.shape[0]
    host_labels = labels.cpu().numpy()
    worst, differing = 0.0, 0
    times, visited, planned = {}, 0, False
    for start in range(0, x.shape[0], chunk):
        xc, lc = x[start : start + chunk], labels[start : start + chunk]
        queries = dsa.query_plan(host_labels[start : start + chunk])
        closest = None
        for want_same in (True, False):
            q = xc if want_same else closest
            args = (q, lc, dsa.rows, dsa.rows_sq, dsa.train_labels, want_same)
            got_min, got_arg = dsa_cuda.masked_nearest(*args, dsa.layout, queries)
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
            if want_same:
                closest = dsa.rows.index_select(0, want_arg.long())
        if start == 0:
            # One score call as the DSA makes it: the query plan (where the
            # DSA plans), then both searches.
            planned = queries is not None
            walks = queries if planned else dsa_cuda.full_walk(len(xc), dsa.rows.shape[0], dev)
            visited = sum(total for total, _ in walks.visits.values())
            searches = ((xc, True), (closest, False))

            def kernel_call():
                plan = dsa.query_plan(host_labels[:chunk])
                for q, same in searches:
                    dsa_cuda.masked_nearest(q, lc, dsa.rows, dsa.rows_sq, dsa.train_labels,
                                            same, dsa.layout, plan)

            calls = {
                "ms": kernel_call,
                "plain_ms": lambda: [dsa_cuda.masked_nearest_plain(
                    q, lc, dsa.rows, dsa.rows_sq, dsa.train_labels, same) for q, same in searches],
                "library_ms": lambda: [_cdist_nearest(q, lc, dsa.rows, dsa.train_labels, same)
                                       for q, same in searches],
            }
            # small calls (IMDB's badges) take more repetitions against the timer's noise
            reps = (3, 2) if planned else (50, 50)
            times = {key: cuda_ms(fn, reps[key != "ms"]) for key, fn in calls.items()}
    c = min(chunk, x.shape[0])
    n, d = dsa.rows.shape
    print(f"dsa_nearest {family}: {differing} argmins differ over {x.shape[0]} queries "
          "(near ties within rtol 1e-4)")
    # The two searches together need every (query, training row) pair once:
    # the same-class pairs in the first, the other-class pairs in the second.
    flops = 2 * c * n * d
    nbytes = 2 * ((c + n) * d * 4 + (c + n) * 8 + c * 8)
    # the kernel's unit: 3xTF32 on the tensor cores, or f32 FMAs for few features
    unit = "3xtf32" if dsa_cuda.tensor_cores(d) else "f32"
    bound, by = bound_ms(flops, nbytes, unit)
    full = 2 * -(-c // dsa_cuda.BLOCK_QUERIES) * -(-n // dsa_cuda.BLOCK_TRAIN)
    return {"queries_per_call": c, "train_rows": n, "features": d,
            "max_abs_err": worst, **times, "bound_ms": bound, "bound_by": by,
            "bound_unit": UNITS[unit][1], "planned": planned, "tiles_visited": visited,
            "tiles_two_full_walks": full}


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
        "bound_unit": "; ".join(f"{family}: {rec['bound_unit']}" for family, rec in by_path.items()),
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
    h, dh = attn.num_heads, attn.head_dim

    def timed(q, k, v, reps):
        """Kernel, plain and SDPA forward times and the bound at q's shape."""
        qh, kh, vh = (x.permute(0, 2, 1, 3).contiguous() for x in (q, k, v))
        n = q.shape[0]

        def kernel():
            return flash_attention.flash_attention_fwd(q, k, v)

        def library():
            return F.scaled_dot_product_attention(qh, kh, vh)

        with torch.no_grad():
            rec = {
                "shape": [n, t, h, dh],
                "ms": cuda_ms(kernel, reps),
                "plain_ms": cuda_ms(lambda: flash_attention.flash_attention_plain(q, k, v), 5),
                "library_ms": cuda_ms(library, reps),
                # the same calls replayed from CUDA graphs: the card's time alone
                "device_ms": graph_ms(kernel, 20),
                "library_device_ms": graph_ms(library, 20),
                # the host's time per eager call, which bounds it where the card's is less
                "host_ms": host_ms(kernel, reps),
                "library_host_ms": host_ms(library, reps),
            }
        # two products of 2*dh FLOPs per (query, key) pair; q, k, v read and out
        # written once, lse written once
        flops = 4 * n * h * t * t * dh
        nbytes = 4 * (4 * n * t * h * dh + n * h * t)
        rec["bound_ms"], rec["bound_by"] = bound_ms(flops, nbytes, "3xtf32")
        return rec

    big = timed(q, k, v, 20)
    step = timed(*(x[:32].contiguous() for x in (q, k, v)), 100)
    print(f"flash_attention timed at q/k/v [{b}, {t}, {h}, {dh}] and [32, {t}, {h}, {dh}]")
    return {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "simple_tip_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "simple_tip_tpu/ops/flash_attention.py:58",
        "timed": f"one launch at one prediction batch, q/k/v [{b}, {t}, {h}, {dh}]; "
                 "library: scaled_dot_product_attention's forward",
        "max_abs_err": err,
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"],
        "bound_unit": UNITS["3xtf32"][1],
        "library_ms": big["library_ms"],
        "device_ms": big["device_ms"],
        "library_device_ms": big["library_device_ms"],
        "at_training_step": step,
    }


# The card-alone and host times of B5/B6 and the SDPA backward, per entry.
TIMES = ("device_ms", "host_ms", "library_device_ms", "library_host_ms", "library_graph_error")


def _bwd_close(got, want, what: str) -> tuple:
    """(max |got - want|, that over max |want|); raises unless |got - want|
    <= atol + 1e-4 |want| with atol = min(1e-5, 1e-4 max |want|), so the
    check can fail whatever the scale of the gradients."""
    scale = float(want.abs().max())
    excess = float(((got - want).abs() - 1e-4 * want.abs()).max())
    if excess > min(1e-5, 1e-4 * scale):
        raise AssertionError(f"flash backward {what}: off by {excess} beyond rtol 1e-4 "
                             f"(max |want| {scale})")
    err = float((got - want).abs().max())
    return err, err / scale


def imdb_step_tensors(net, tokens: np.ndarray, labels: np.ndarray, dev):
    """q, k, v [B, 100, 2, 32] of an IMDB forward over ``tokens`` and dO, the
    gradient of the batch's mean cross-entropy (``train=False``) with
    respect to the attention core's output, scaled to unit RMS: the
    backward is linear in dO, and the mean's dO (RMS ~1e-3) would leave dq
    and dk near 1e-5, the size of the check's atol."""
    attn = net.block.attention
    x = to_device(tokens, dev)
    emb = net.embedding(x).detach()
    b, t, _ = emb.shape
    with torch.no_grad():
        q, k, v = (p(emb).reshape(b, t, attn.num_heads, attn.head_dim).contiguous()
                   for p in (attn.query, attn.key, attn.value))
    core = flash_attention.flash_attention(q, k, v).detach().requires_grad_()
    probs, _ = net.suffix((emb, attn.out(core.reshape(b, t, -1))))
    y = F.one_hot(torch.as_tensor(labels, device=dev), probs.shape[1]).float()
    (dout,) = torch.autograd.grad(categorical_crossentropy(probs, y).mean(), core)
    return q, k, v, (dout / dout.pow(2).mean().sqrt()).contiguous()


def sdpa_backward_times(q, k, v, dout, reps: int) -> dict:
    """Times of the backward of ``scaled_dot_product_attention`` (dq, dk and
    dv together) on [B, T, H, dh] inputs: eager (CUDA events), the host's
    time per eager call, and replayed from a CUDA graph. The forward runs on
    a side stream, so that its backward runs and is captured there. A
    capture that fails is recorded in the result (it is the yardstick, not a
    check)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qh, kh, vh = (x.permute(0, 2, 1, 3).contiguous().requires_grad_() for x in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qh, kh, vh)
        doh = dout.permute(0, 2, 1, 3).contiguous()

        def library():
            return torch.autograd.grad(sdpa, (qh, kh, vh), doh, retain_graph=True)

        rec = {"library_ms": cuda_ms(library, reps), "library_host_ms": host_ms(library, reps)}
        try:
            rec["library_device_ms"] = graph_ms(library, 20, side)
        except RuntimeError as exc:
            rec["library_device_ms"] = None
            rec["library_graph_error"] = str(exc)[:500]
    torch.cuda.current_stream().wait_stream(side)
    return rec


def _bwd_times(kernel, plain, args, reps: int) -> dict:
    """A backward kernel's eager time, its plain version's, the card's time
    alone (replayed from a CUDA graph) and the host's own time per eager
    call, on ``args``."""
    return {"ms": cuda_ms(lambda: kernel(*args), reps),
            "plain_ms": cuda_ms(lambda: plain(*args), 3),
            "device_ms": graph_ms(lambda: kernel(*args), 20),
            "host_ms": host_ms(lambda: kernel(*args), reps)}


def check_flash_backward(params, data, dev, seed: int) -> list:
    """B5 and B6 against their plain versions on a real IMDB training step
    (the batch of 32 and its dO), a ragged [4, 300, 2, 8] and dh=128
    [4, 200, 2, 128]; timed at the step and at [8192, 100, 2, 32] (eager,
    replayed from a CUDA graph, and the host's time per eager call), with
    B4 beside them (``fwd_ms``) for the training step's breakdown."""
    net = _module("imdb", params, dev)
    (x_tr, y_tr), _, _ = data
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    cases = {
        "step": imdb_step_tensors(net, x_tr[:32], y_tr[:32], dev),
        "ragged": tuple(normal(4, 300, 2, 8) for _ in range(4)),
        "dh128": tuple(normal(4, 200, 2, 128) for _ in range(4)),
        "timing": imdb_step_tensors(net, x_tr[:PREDICT_BATCH], y_tr[:PREDICT_BATCH], dev),
    }
    err = {"dq": 0.0, "dkv": 0.0}
    rel = {}  # per case and gradient: max |got - want| / max |want|
    timed = {}
    for name, (q, k, v, dout) in cases.items():
        out, lse = flash_attention.flash_attention_fwd(q, k, v)
        dvec = flash_attention.attention_delta(out, dout)
        args = (q, k, v, dout, lse, dvec)
        dq = flash_attention.flash_bwd_dq(*args)
        dk, dv = flash_attention.flash_bwd_dkv(*args)
        want_dk, want_dv = flash_attention.flash_bwd_dkv_plain(*args)
        torch.cuda.synchronize()
        close = {"dq": _bwd_close(dq, flash_attention.flash_bwd_dq_plain(*args), f"{name} dq"),
                 "dk": _bwd_close(dk, want_dk, f"{name} dk"),
                 "dv": _bwd_close(dv, want_dv, f"{name} dv")}
        rel[name] = {g: r for g, (_, r) in close.items()}
        err["dq"] = max(err["dq"], close["dq"][0])
        err["dkv"] = max(err["dkv"], close["dk"][0], close["dv"][0])
        if name not in ("step", "timing"):
            continue
        reps = 20 if name == "step" else 5
        library = sdpa_backward_times(q, k, v, dout, reps)
        b, t, h, dh = q.shape
        pairs = b * h * t * t * dh  # one product is 2 * pairs FLOPs
        io = 4 * b * t * h * dh  # bytes of one [B, T, H, dh] array
        rows = 4 * 2 * b * h * t  # lse and D
        timed[name] = {
            "shape": [b, t, h, dh],
            "fwd_ms": cuda_ms(lambda: flash_attention.flash_attention_fwd(q, k, v), reps),
            "dq": {**_bwd_times(flash_attention.flash_bwd_dq, flash_attention.flash_bwd_dq_plain,
                                args, reps),
                   "bound": bound_ms(3 * 2 * pairs, 5 * io + rows, "3xtf32"), **library},
            "dkv": {**_bwd_times(flash_attention.flash_bwd_dkv,
                                 flash_attention.flash_bwd_dkv_plain, args, reps),
                    "bound": bound_ms(4 * 2 * pairs, 6 * io + rows, "3xtf32"), **library},
        }
    print(json.dumps({"flash_backward_relative_err": rel}))
    print(json.dumps({"flash_backward_timed": timed}))
    entries = []
    for key, name, line in (("dq", "flash_attention_bwd_dq", 174),
                            ("dkv", "flash_attention_bwd_dkv", 203)):
        step, big = timed["step"][key], timed["timing"][key]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "simple_tip_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"simple_tip_tpu/ops/flash_attention.py:{line}",
            "timed": "one launch at an IMDB training step, q/k/v/dO [32, 100, 2, 32]; "
                     "library: the backward of scaled_dot_product_attention (dq, dk, dv)",
            "max_abs_err": err[key],
            "ms": step["ms"],
            "plain_ms": step["plain_ms"],
            "bound_ms": step["bound"][0],
            "bound_by": step["bound"][1],
            "bound_unit": UNITS["3xtf32"][1],
            "library_ms": step["library_ms"],
            **{t: step[t] for t in TIMES if t in step},
            "at_8192": {"ms": big["ms"], "plain_ms": big["plain_ms"],
                        "bound_ms": big["bound"][0], "bound_by": big["bound"][1],
                        "library_ms": big["library_ms"],
                        **{t: big[t] for t in TIMES if t in big}},
        })
    return entries


WIDE_SHAPE = (64, 128, 2, 256)  # [B, T, H, dh]: past the narrow kernels' dh <= 128


def check_wide_heads(dev, seed: int) -> dict:
    """B4, B5 and B6 at head_dim 256, where they take their wide-head
    variants, against their plain versions on seeded q, k, v and dO: out and
    lse with the forward's check, dq, dk and dv with the backward's. Timed
    (eager, replayed from a CUDA graph, plain) beside the SDPA forward and
    backward on the same inputs."""
    rng = np.random.default_rng(seed + 1)
    q, k, v, dout = (torch.from_numpy(rng.normal(size=WIDE_SHAPE).astype(np.float32)).to(dev)
                     for _ in range(4))
    fa = flash_attention
    out, lse = fa.flash_attention_fwd(q, k, v)
    want_out, want_lse = fa.flash_attention_plain(q, k, v)
    args = (q, k, v, dout, lse, fa.attention_delta(out, dout))
    dq = fa.flash_bwd_dq(*args)
    dk, dv = fa.flash_bwd_dkv(*args)
    want_dk, want_dv = fa.flash_bwd_dkv_plain(*args)
    torch.cuda.synchronize()
    err = {"out": _attention_close(out, want_out, "wide-head out"),
           "lse": _attention_close(lse, want_lse, "wide-head lse"),
           "dq": _bwd_close(dq, fa.flash_bwd_dq_plain(*args), "wide-head dq")[0],
           "dk": _bwd_close(dk, want_dk, "wide-head dk")[0],
           "dv": _bwd_close(dv, want_dv, "wide-head dv")[0]}
    b, t, h, dh = WIDE_SHAPE
    pairs = b * h * t * t * dh  # one product is 2 * pairs FLOPs
    io = 4 * b * t * h * dh  # bytes of one [B, T, H, dh] array
    rows = 4 * 2 * b * h * t  # lse and D
    qh, kh, vh = (x.permute(0, 2, 1, 3).contiguous() for x in (q, k, v))

    def forward():
        return fa.flash_attention_fwd(q, k, v)

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh)

    with torch.no_grad():
        fwd = {"ms": cuda_ms(forward, 20), "device_ms": graph_ms(forward, 20),
               "plain_ms": cuda_ms(lambda: fa.flash_attention_plain(q, k, v), 3),
               "library_ms": cuda_ms(sdpa, 20),
               "bound": bound_ms(2 * 2 * pairs, 4 * io + 4 * b * h * t, "3xtf32")}
    library = sdpa_backward_times(q, k, v, dout, 20)
    record = {
        "shape": list(WIDE_SHAPE),
        "max_abs_err": err,
        "fwd": fwd,
        "dq": {**_bwd_times(fa.flash_bwd_dq, fa.flash_bwd_dq_plain, args, 20),
               "bound": bound_ms(3 * 2 * pairs, 5 * io + rows, "3xtf32"), **library},
        "dkv": {**_bwd_times(fa.flash_bwd_dkv, fa.flash_bwd_dkv_plain, args, 20),
                "bound": bound_ms(4 * 2 * pairs, 6 * io + rows, "3xtf32"), **library},
    }
    print(json.dumps({"wide_heads": record}))
    return record


def check_imdb_gradients(params, data, dev) -> dict:
    """Every parameter gradient of one full-width IMDB batch of 32 (loss
    with ``train=False``) through ``FlashAttention``, on the card and on
    the CPU, within rtol 2e-4 / atol 2e-5; the q/k/v kernels' gradients
    must be non-zero. The q and k kernels' gradients are ~1e-5, so each
    leaf's atol is cut to 2e-4 of its largest |gradient| plus 1e-7 of the
    model's largest, the f32 rounding floor that holds the key bias (its
    true gradient is 0: softmax ignores a shift shared by a query's keys)."""
    (x_tr, y_tr), _, _ = data
    grads = []
    for device in (dev, torch.device("cpu")):
        net = _module("imdb", params, device)
        probs, _ = net(to_device(x_tr[:32], device))
        y = F.one_hot(torch.as_tensor(y_tr[:32], device=device), 2).float()
        loss = categorical_crossentropy(probs, y).mean()
        names, tensors = zip(*net.named_parameters())
        grads.append(dict(zip(names, torch.autograd.grad(loss, tensors))))
    card, cpu = grads
    floor = 1e-7 * max(float(g.abs().max()) for g in cpu.values())
    worst, relative = 0.0, {}
    for name, want in cpu.items():
        got = card[name].cpu()
        scale = float(want.abs().max())
        atol = min(2e-5, 2e-4 * scale + floor)
        excess = float(((got - want).abs() - 2e-4 * want.abs()).max())
        if excess > atol:
            raise AssertionError(f"IMDB gradient {name}: card vs CPU off by {excess} beyond "
                                 f"rtol 2e-4 + atol {atol}")
        err = float((got - want).abs().max())
        worst = max(worst, err)
        if name.startswith("block.attention."):
            relative[name] = err / max(scale, floor)
    norms = {p: float(card[f"block.attention.{p}.weight"].norm())
             for p in ("query", "key", "value")}
    if not all(n > 0 for n in norms.values()):
        raise AssertionError(f"IMDB q/k/v kernel gradients vanish on the card: {norms}")
    record = {"imdb_gradients_card_vs_cpu_max_abs": worst, "qkv_kernel_grad_norms": norms,
              "attention_relative_err": relative}
    print(json.dumps(record))
    return record


def expected_artifacts(family: str, n: int, sa_names=SA_NAMES):
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
    for name in sa_names:
        out[f"{name}_scores"] = (np.dtype(np.float64), (n,))
        out[f"{name}_cam_order"] = (np.dtype(np.int64), (n,))
    return out


def read_artifacts(family: str, n: int, sa_names=SA_NAMES):
    """Load and check every artifact and time record of model 0: SA scores
    hold no NaN, and only dsa's and pc-lsa's may hold +inf (no other-class
    row; a KDE density that underflows).

    Returns ``({(ds, suffix): array}, {ds: {metric: [setup, pred, quant, cam]}})``.
    """
    found, records = {}, {}
    expected = expected_artifacts(family, n, sa_names)
    metrics = [*UNCERTAINTIES, *NC_METRICS, *sa_names]
    if PATHS[family]["model"].has_dropout:
        metrics.append("VR")
    for ds in ("nominal", "ood"):
        for suffix, (dtype, shape) in expected.items():
            path = os.path.join(subdir("priorities"), f"{family}_{ds}_0_{suffix}.npy")
            a = np.load(path)
            if a.dtype != dtype or a.shape != shape:
                raise AssertionError(f"{path}: {a.dtype}{a.shape}, want {dtype}{shape}")
            if suffix.endswith("cam_order") and not np.array_equal(np.sort(a), np.arange(n)):
                raise AssertionError(f"{path} is not a permutation")
            if a.dtype.kind == "f" and np.isnan(a).any():
                raise AssertionError(f"{path} has NaN values")
            if (a.dtype.kind == "f" and not suffix.startswith(("dsa", "pc-lsa"))
                    and not np.isfinite(a).all()):
                raise AssertionError(f"{path} has non-finite values")
            found[(ds, suffix)] = a
        extra = {os.path.basename(p) for p in os.listdir(subdir("priorities"))} - {
            f"{family}_{d}_0_{s}.npy" for d in ("nominal", "ood")
            for s in expected
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


def run_slice(family: str, params, data, dev, root: str, sa_names=SA_NAMES):
    """evaluate() into ``root`` with the SA variants ``sa_names``; returns
    (phase seconds, artifacts, time records, {variant: chosen k})."""
    cfg = PATHS[family]
    (x_tr, _), (x_nom, y_nom), (x_ood, y_ood) = data
    if x_ood.shape[0] != x_nom.shape[0]:
        raise AssertionError("the checks assume equal nominal and OOD sizes")
    os.environ["TIP_ASSETS"] = root
    phases, chosen_k = eval_prioritization.evaluate(
        model_id=0, case_study=family, model_def=cfg["model"](), params=params,
        training_dataset=x_tr, nominal_test_dataset=x_nom, nominal_test_labels=y_nom,
        ood_test_dataset=x_ood, ood_test_labels=y_ood,
        nc_activation_layers=cfg["nc"], sa_activation_layers=cfg["sa"],
        dsa_badge_size=cfg["dsa_badge"], batch_size=cfg["batch"], device=dev, sa_names=sa_names,
    )
    return (phases, *read_artifacts(family, x_nom.shape[0], sa_names), chosen_k)


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


def sa_report(art: dict, records: dict, chosen_k: dict) -> dict:
    """Per SA variant: setup and score seconds on both datasets, the +inf
    count of its scores; pc-mmdsa's chosen k."""
    report = {"chosen_k": chosen_k, "variants": {}}
    for name in SA_NAMES:
        rec = {"setup_s": records["nominal"][name][0]}
        for ds in ("nominal", "ood"):
            rec[f"{ds}_score_s"] = records[ds][name][2]
            rec[f"{ds}_cam_s"] = records[ds][name][3]
            rec[f"{ds}_inf"] = int(np.isinf(art[(ds, f"{name}_scores")]).sum())
        report["variants"][name] = rec
    return report


def apfd_table_row(family: str, root: str) -> dict:
    """The family's APFD table (``plotters/eval_apfd_table``) over the path's
    artifacts: {approach: [nominal, ood, time]}; every approach must have
    both APFDs (VR only where the model has dropout)."""
    os.environ["TIP_ASSETS"] = root
    table = eval_apfd_table.apfd_table([family])
    eval_apfd_table.add_reported_times(table, times_collector.load_times())
    row = {approach: [cells[family, c] for c in eval_apfd_table.COLUMNS]
           for (_, approach), cells in table.items()}
    for approach, (nominal, ood, _) in row.items():
        if approach == "VR" and not PATHS[family]["model"].has_dropout:
            continue
        if not (isinstance(nominal, float) and isinstance(ood, float)):
            raise AssertionError(f"{family}: APFD table has no {approach}: {nominal}, {ood}")
    return row


def _fit_and_score(name: str, train_ats, train_pred, test_ats, test_pred, device):
    """``name``'s registry scorer fitted on the training traces on
    ``device``, its scores of the test traces, and the fit and score seconds."""
    t0 = time.perf_counter()
    prep = SharedTrainPrep(train_ats.to(device), train_pred, device)
    scorer = SA_VARIANTS[name](VariantFitter(prep, device))
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scores = scorer(test_ats.to(device), test_pred)
    return scorer, scores, fit_s, time.perf_counter() - t0


def _lsa_log_densities(scorer, test_ats, test_pred, device) -> np.ndarray:
    """pc-lsa's per-class KDE log densities of the test traces before the
    exp (NaN for a class whose features were all dropped)."""
    out = np.full(test_ats.shape[0], np.nan)
    for c in np.unique(test_pred):
        lsa = scorer.modal_sa[int(c)]
        if lsa.kde is not None:
            rows = np.flatnonzero(test_pred == c)
            out[rows] = lsa.log_density(test_ats[rows].to(device)).cpu().numpy()
    return out


def _rel_gap(a: np.ndarray, b: np.ndarray) -> float:
    """Largest relative gap of ``a`` to ``b`` over ``b``'s finite entries."""
    fin = np.isfinite(b)
    return float((np.abs(a[fin] - b[fin]) / np.abs(b[fin]).clip(1e-30)).max(initial=0.0))


def _mlsa_rungs(scorer):
    return [(m.gmm.n_components, m.gmm.reg_covar) for m in scorer.modal_sa.values()]


def compare_sa_small(family: str, params, data, dev) -> dict:
    """The four SA variants fitted and scored on the card and on the CPU
    from the same traces (``SA_CHECK``; pc-mlsa on one class and its
    features of highest variance where it says so): the same chosen k and
    MLSA ``reg_covar`` rungs, the same +inf rows, finite scores (and
    pc-lsa's log densities) within ``SA_RTOL``, SC-CAM orders equal in all
    but ``SA_ORDER_CAP`` of their positions. On the convnets pc-mlsa is
    also fitted at full width (``mlsa_full_width``). Returns the errors and
    times per variant."""
    cfg = PATHS[family]
    n_train, n_test, mlsa_cut = SA_CHECK[family]
    (x_tr, _), (x_nom, y_nom), _ = data
    model = BaseModel(cfg["model"](), params, cfg["sa"], include_last_layer=True,
                      batch_size=1024, device=dev)
    train, test = model.get_activations(x_tr[:n_train]), model.get_activations(x_nom[:n_test])

    def rows(outs):
        return torch.cat([t.reshape(t.shape[0], -1) for t in outs[:-1]], dim=1).cpu()

    train_ats, train_pred = rows(train), train[-1].argmax(1).cpu().numpy()
    test_ats, test_pred = rows(test), test[-1].argmax(1).cpu().numpy()
    picks = {name: (slice(None), slice(None), slice(None)) for name in NEW_SA}
    if mlsa_cut is not None:
        cls = int(np.bincount(test_pred).argmax())
        tr = np.flatnonzero(train_pred == cls)[: mlsa_cut[0]]
        top = np.sort(np.argsort(train_ats[tr].var(dim=0).numpy())[-mlsa_cut[1]:])
        picks["pc-mlsa"] = (tr, np.flatnonzero(test_pred == cls), top)
    sides = {}
    for side, device in (("card", dev), ("cpu", torch.device("cpu"))):
        out = {}
        for name in NEW_SA:
            tr, te, cols = picks[name]
            scorer, scores, fit_s, score_s = _fit_and_score(
                name, train_ats[tr][:, cols], train_pred[tr], test_ats[te][:, cols],
                test_pred[te], device)
            k = getattr(scorer.discriminator, "best_k", None)
            rungs = [m.gmm.reg_covar for m in scorer.modal_sa.values() if hasattr(m, "gmm")]
            log_density = (_lsa_log_densities(scorer, test_ats, test_pred, device)
                           if name == "pc-lsa" else None)
            out[name] = (scores, k, rungs, fit_s, score_s, log_density)
        sides[side] = out
    report, breaches = {}, []
    for name in NEW_SA:
        a, k_card, rungs_card, fit_card, score_card, log_card = sides["card"][name]
        b, k_cpu, rungs_cpu, fit_cpu, score_cpu, log_cpu = sides["cpu"][name]
        rel = _rel_gap(a, b)
        moved = int((_sc_cam_order(a) != _sc_cam_order(b)).sum())
        if k_card != k_cpu or rungs_card != rungs_cpu:
            breaches.append(f"{name}: card k={k_card}, rungs {rungs_card}; "
                            f"CPU k={k_cpu}, rungs {rungs_cpu}")
        if not np.array_equal(np.isinf(a), np.isinf(b)) or np.isnan(a).any() or np.isnan(b).any():
            breaches.append(f"{name}: non-finite rows differ")
        if rel > SA_RTOL:
            breaches.append(f"{name}: rtol {rel} > {SA_RTOL}")
        if moved > SA_ORDER_CAP * a.shape[0]:
            breaches.append(f"{name}: {moved} of {a.shape[0]} SC-CAM positions differ")
        report[name] = {"rows": [int(np.size(train_pred[picks[name][0]])), int(a.shape[0])],
                        "features": int(train_ats[:1, picks[name][2]].shape[1]),
                        "max_rel_err": rel, "cam_positions_moved": moved,
                        "chosen_k": k_card, "reg_covar": rungs_card, "inf": int(np.isinf(a).sum()),
                        "card_fit_s": fit_card, "card_score_s": score_card,
                        "cpu_fit_s": fit_cpu, "cpu_score_s": score_cpu}
        if log_card is not None:
            log_rel = _rel_gap(log_card, log_cpu)
            report[name]["log_density"] = {
                "finite": int(np.isfinite(log_cpu).sum()), "max_rel_err": log_rel}
            if not all(np.array_equal(f(log_card), f(log_cpu)) for f in (np.isnan, np.isinf)):
                breaches.append(f"{name}: non-finite log densities differ")
            if log_rel > SA_RTOL:
                breaches.append(f"{name}: log densities rtol {log_rel} > {SA_RTOL}")
    if mlsa_cut is not None:
        report["mlsa_full_width"] = mlsa_full_width(family, model, train_ats, train_pred,
                                                    x_nom, y_nom, dev, breaches)
    print(json.dumps({"path": family, "sa_card_vs_cpu": report}))
    if breaches:
        raise AssertionError(f"{family} SA card vs CPU: " + "; ".join(breaches))
    return report


def mlsa_full_width(family: str, model, train_ats, train_pred, x_nom, y_nom, dev,
                    breaches: list) -> dict:
    """pc-mlsa at the tap's full width on the card and on the CPU: fitted on
    every training row of ``SA_CHECK``'s set predicted as the nominal set's
    most predicted class, scored on every nominal row predicted as it.
    Gates finite scores and the APFD of each side's SC-CAM order (faults:
    misclassified rows) within ``MLSA_APFD_GAP``, appending to
    ``breaches``; reads each side's components and ``reg_covar`` rung, the
    score gap and the SC-CAM positions moved."""
    test = model.get_activations(x_nom)
    test_pred = test[-1].argmax(1).cpu().numpy()
    cls = int(np.bincount(test_pred).argmax())
    te = np.flatnonzero(test_pred == cls)
    test_ats = torch.cat([t.reshape(t.shape[0], -1) for t in test[:-1]], dim=1)[
        torch.from_numpy(te).to(dev)].cpu()
    del test
    tr = np.flatnonzero(train_pred == cls)
    faults = test_pred[te] != np.asarray(y_nom)[te]
    got = {}
    for side, device in (("card", dev), ("cpu", torch.device("cpu"))):
        scorer, scores, fit_s, score_s = _fit_and_score(
            "pc-mlsa", train_ats[tr], train_pred[tr], test_ats, test_pred[te], device)
        got[side] = (scores, _mlsa_rungs(scorer), fit_s, score_s)
    (a, rungs_card, fit_card, score_card), (b, rungs_cpu, fit_cpu, score_cpu) = (
        got["card"], got["cpu"])
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        breaches.append("pc-mlsa at full width: non-finite scores")
    order_card, order_cpu = _sc_cam_order(a), _sc_cam_order(b)
    apfd_card, apfd_cpu = apfd_from_order(faults, order_card), apfd_from_order(faults, order_cpu)
    if not abs(apfd_card - apfd_cpu) <= MLSA_APFD_GAP:
        breaches.append(f"pc-mlsa at full width: APFD {apfd_card} on the card, {apfd_cpu} on "
                        f"the CPU, more than {MLSA_APFD_GAP} apart")
    return {"class": cls, "rows": [int(tr.size), int(te.size)],
            "features": int(train_ats.shape[1]), "faults": int(faults.sum()),
            "components_reg_covar": {"card": rungs_card, "cpu": rungs_cpu},
            "max_rel_err": _rel_gap(a, b),
            "cam_positions_moved": int((order_card != order_cpu).sum()),
            "selection_moved": mlsa_selection_moved(a, b, order_card, order_cpu),
            "apfd_card": apfd_card, "apfd_cpu": apfd_cpu,
            "card_fit_s": fit_card, "card_score_s": score_card,
            "cpu_fit_s": fit_cpu, "cpu_score_s": score_cpu}


def moved_rows(card, cpu) -> int:
    """Rows that one selection holds and the other does not."""
    return len(set(np.asarray(card).tolist()) - set(np.asarray(cpu).tolist()))


def mlsa_selection_moved(card, cpu, order_card, order_cpu) -> dict:
    """pc-mlsa's known card/CPU gap as active learning sees it: the rows
    moved in its top-k and its SC-CAM first-k at k = 20% of the rows (the
    AL phase selects 1,000 of 5,000 observed rows)."""
    k = max(1, card.shape[0] // 5)
    return {"k": k, "top_k": moved_rows(np.argsort(card)[-k:], np.argsort(cpu)[-k:]),
            "sc_cam_first_k": moved_rows(order_card[:k], order_cpu[:k])}


def run_path(family: str, params, data, dev, root: str) -> dict:
    """The path at full size with the counters read around it, its SA
    variants' times and APFD table, then the small card-against-CPU
    comparisons (the slice with DSA, then the four other SA variants)."""
    zero_counters()
    t0 = time.perf_counter()
    path_root = os.path.join(root, family)
    phases, art, records, chosen_k = run_slice(family, params, data, dev, path_root)
    seconds = time.perf_counter() - t0
    launches = read_counters()
    for name in PATHS[family]["kernels"]:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the {family} path")
    apfd = apfd_report(art)
    sa = sa_report(art, records, chosen_k)
    print(json.dumps({"path": family, "sizes": PATHS[family]["sizes"], "slice_s": seconds,
                      "phases_s": phases, "launches": launches, "apfd": apfd}))
    print(json.dumps({"path": family, "time_records": records}))
    print(json.dumps({"path": family, "sa": sa}))
    table = apfd_table_row(family, path_root)
    print(json.dumps({"path": family, "apfd_table": table}))
    small = (
        (data[0][0][:SMALL_TRAIN], data[0][1][:SMALL_TRAIN]),
        (data[1][0][:SMALL_TEST], data[1][1][:SMALL_TEST]),
        (data[2][0][:SMALL_TEST], data[2][1][:SMALL_TEST]),
    )
    _, card_art, _, _ = run_slice(family, params, small, dev,
                                  os.path.join(root, f"{family}_card"), ("dsa",))
    _, cpu_art, _, _ = run_slice(family, params, small, torch.device("cpu"),
                                 os.path.join(root, f"{family}_cpu"), ("dsa",))
    small_report = compare_small(family, card_art, cpu_art)
    flips = {k: v for k, v in small_report.items() if v}
    print(json.dumps({"path": family, "small_card_vs_cpu_flips": flips}))
    sa_small = compare_sa_small(family, params, data, dev)
    return {"sizes": PATHS[family]["sizes"], "slice_s": seconds, "phases_s": phases,
            "launches": launches, "apfd": apfd, "time_records": records, "sa": sa,
            "apfd_table": table, "small": small_report, "sa_small": sa_small}


def al_case_study(data) -> CaseStudy:
    """MNIST's case study for the AL phase: the path's one-epoch train
    config and the registry's AL settings, its training base cut to the
    first ``AL_TRAIN_ROWS`` rows."""
    (x_tr, y_tr), nominal, ood = data
    cs = case_study(AL_FAMILY, ((x_tr[:AL_TRAIN_ROWS], y_tr[:AL_TRAIN_ROWS]), nominal, ood))
    return CaseStudy(dataclasses.replace(cs.spec, al_observed_share=AL_OBSERVED_SHARE,
                                         al_num_selected=AL_NUM_SELECTED))


def read_al_pickles(family: str, has_dropout: bool) -> dict:
    """Load and check run 0's AL pickles: one per approach and observed
    split (VR only with dropout) plus the original model's, each the four
    splits' accuracies in the JAX package's order, Python floats in [0, 1]."""
    folder = subdir("active_learning")
    approaches = [a for a in [*APPROACHES, "random"] if a != "VR" or has_dropout]
    want = {f"{family}_0_{a}_{obs}.pickle" for a in approaches for obs in ("nominal", "ood")}
    want.add(f"{family}_0_original_na.pickle")
    found = set(os.listdir(folder))
    if found != want:
        raise AssertionError(f"AL pickles: missing {sorted(want - found)}, "
                             f"unexpected {sorted(found - want)}")
    splits = [(s, p) for s in ("nominal", "ood") for p in ("observed", "future")]
    out = {}
    for name in sorted(want):
        with open(os.path.join(folder, name), "rb") as f:
            acc = pickle.load(f)
        if list(acc) != splits or not all(type(v) is float and 0 <= v <= 1 for v in acc.values()):
            raise AssertionError(f"{name}: {acc} is not the four splits' accuracies")
        out[name[len(f"{family}_0_"):-len(".pickle")]] = acc
    return out


def run_active_learning(data, dev, root: str) -> dict:
    """MNIST's AL phase on run 0's checkpoint (in ``root``/train) through
    ``CaseStudy.run_active_learning_eval`` with the counters read around
    it. Checks launches, pickles, each retrain's epoch and the random
    baseline's floor; prints its seconds and its AL table row."""
    cs = al_case_study(data)
    os.environ["TIP_ASSETS"] = os.path.join(root, "train")
    zero_counters()
    t0 = time.perf_counter()
    [run] = cs.run_active_learning_eval([0], device=dev).values()
    seconds = time.perf_counter() - t0
    phases, members = run.seconds, run.retrain_epochs
    launches = read_counters()
    for name in PATHS[AL_FAMILY]["kernels"]:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the {AL_FAMILY} AL path")
    accuracies = read_al_pickles(AL_FAMILY, PATHS[AL_FAMILY]["model"].has_dropout)
    n_train = training_rows(AL_TRAIN_ROWS + AL_NUM_SELECTED, cs.spec.train_cfg.validation_split)
    steps = -(-n_train // cs.spec.train_cfg.batch_size)
    if len(members) != len(accuracies) - 1:
        raise AssertionError(f"{len(members)} retrains for {len(accuracies) - 1} selections")
    for i, history in enumerate(members):
        if [r["steps"] for r in history] != [steps]:
            raise AssertionError(f"AL retrain {i}: epochs {history}, want one of {steps} steps")
    for obs in ("nominal", "ood"):
        for split in (("nominal", "observed"), ("nominal", "future")):
            acc = accuracies[f"random_{obs}"][split]
            if not acc >= AL_RANDOM_FLOOR:
                raise AssertionError(f"random {obs} retrain: {split} accuracy {acc} below "
                                     f"{AL_RANDOM_FLOOR}")
    table = eval_active_learning_table.active_learning_table([AL_FAMILY])
    row = {approach: [cells[col] for col in eval_active_learning_table.columns([AL_FAMILY])]
           for (_, approach), cells in table.items()}
    retrains = len(members)
    record = {
        "family": AL_FAMILY, "seconds": seconds, "phases_s": phases,
        "retrain_mean_s": phases["retrain"] / retrains, "retrains": retrains,
        "steps_per_retrain": steps,
        "member_epoch_s": [h[0]["seconds"] for h in members],
        "member_mean_loss": [h[0]["mean_loss"] for h in members],
        "launches": launches,
        "reduced": {"epochs": "1 (registry 15)",
                    "train_rows": f"{AL_TRAIN_ROWS} of {PATHS[AL_FAMILY]['sizes'][0]}"},
        "settings": {"observed_share": AL_OBSERVED_SHARE, "num_selected": AL_NUM_SELECTED},
        "accuracies": {name: {f"{s}:{p}": v for (s, p), v in acc.items()}
                       for name, acc in accuracies.items()},
    }
    summary = {k: record[k] for k in ("family", "seconds", "phases_s", "retrain_mean_s",
                                      "retrains", "steps_per_retrain", "launches", "reduced",
                                      "settings")}
    print(json.dumps({"active_learning": summary}))
    print(json.dumps({"active_learning_table": {
        "columns": eval_active_learning_table.columns([AL_FAMILY]), "rows": row}}))
    record["table"] = row
    return record


def _gaps_to_edge(values: np.ndarray, rows, k: int) -> np.ndarray:
    """|value - the k-th largest value| of ``rows`` (0 for equal values,
    +inf ones included)."""
    edge = np.sort(values)[-k]
    v = values[np.asarray(sorted(rows), dtype=np.int64)]
    with np.errstate(invalid="ignore"):  # inf - inf, which the tie replaces
        return np.where(v == edge, 0.0, np.abs(v - edge))


def al_selections(params, datasets, x_train, k: int, device) -> tuple:
    """The four builders on one device: (selections, the uncertainties, NC
    scores and SA values their top-k were taken from, seconds)."""
    cfg = PATHS[AL_FAMILY]
    model = cfg["model"]()
    t0 = time.perf_counter()
    fp, unc = eval_active_learning._get_fp_selection(model, params, datasets, k, cfg["batch"],
                                                     device)
    nc, nc_scores = eval_active_learning._get_nc_selection(model, params, x_train, datasets,
                                                           cfg["nc"], k, cfg["batch"], device)
    sa, sa_scores = eval_active_learning._get_sa_selection(model, params, x_train, datasets,
                                                           cfg["sa"], k, cfg["dsa_badge"],
                                                           device, AL_CHECK_SA)
    sel = {**fp, **nc, **sa, **eval_active_learning._get_random_section(datasets, k)}
    eval_active_learning._selection_sanity_checks(k, sel)
    return sel, unc, nc_scores, sa_scores, time.perf_counter() - t0


def compare_al_selections(params, data, dev) -> dict:
    """The four selection builders on a small subset (``AL_CHECK``) on the
    card and on the CPU: rows moved per selection, gated as phase 7 of the
    module docstring says."""
    n_train, n_test, k = AL_CHECK
    (x_tr, _), (x_nom, y_nom), (x_ood, y_ood) = data
    datasets = eval_active_learning._shuffle_and_split_datasets(
        0, x_nom[:n_test], y_nom[:n_test], x_ood[:n_test], y_ood[:n_test], AL_OBSERVED_SHARE)
    card, unc, nc_card, sa_card, card_s = al_selections(params, datasets, x_tr[:n_train], k, dev)
    cpu, unc_cpu, nc_cpu, sa_cpu, cpu_s = al_selections(params, datasets, x_tr[:n_train], k,
                                                        torch.device("cpu"))
    if list(card) != list(cpu):
        raise AssertionError("AL selections: card and CPU built other selections")
    moved, breaches = {}, []
    for key, rows in card.items():
        metric, split = key
        out = set(np.asarray(rows).tolist()) - set(np.asarray(cpu[key]).tolist())
        moved[f"{metric}:{split}"] = len(out)
        if not out or metric == "VR":
            continue
        out |= set(np.asarray(cpu[key]).tolist()) - set(np.asarray(rows).tolist())
        base = metric[:-len("-cam")] if metric.endswith("-cam") else metric
        if metric == eval_active_learning.RANDOM_SPLIT:
            breaches.append(f"{key}: the random baseline moved")
        elif base in UNCERTAINTIES:
            gap = float(_gaps_to_edge(unc_cpu[key], out, k).max())
            if gap > AL_UNCERTAINTY_ATOL:
                breaches.append(f"{key}: rows moved {gap} from the edge")
        elif base in NC_METRICS:
            diff = np.abs(nc_card[base, split].astype(np.int64)
                          - nc_cpu[base, split].astype(np.int64))
            if not diff.any() or diff.max() > 2 or (diff > 0).mean() > 0.01:
                breaches.append(f"{key}: rows moved, scores apart by {int(diff.max())} "
                                f"on {int((diff > 0).sum())} rows")
        elif metric.endswith("-cam"):
            if len(out) / 2 > SA_ORDER_CAP * k:
                breaches.append(f"{key}: {len(out) // 2} of {k} SC-CAM rows moved")
        else:
            values = sa_cpu[key]
            edge = np.sort(values)[-k]
            gap = float(_gaps_to_edge(values, out, k).max())
            if not gap <= SA_RTOL * abs(edge):
                breaches.append(f"{key}: rows moved {gap} from the edge {edge}")
    counted = {
        "vr": sum(v for key, v in moved.items() if key.startswith("VR:")),
        "coverage": sum(v for key, v in moved.items() if key.split(":")[0].split("-")[0]
                        in NC_METRICS),
        "uncertainty": sum(v for key, v in moved.items() if key.split(":")[0] in UNCERTAINTIES),
        "sa": sum(v for key, v in moved.items()
                  if key.split(":")[0].replace("-cam", "") in AL_CHECK_SA),
    }
    report = {"rows": [n_train, n_test, k], "sa_variants": AL_CHECK_SA, "moved_by_kind": counted,
              "moved": {key: v for key, v in moved.items() if v}, "card_s": card_s,
              "cpu_s": cpu_s}
    print(json.dumps({"al_selections_card_vs_cpu": report}))
    if breaches:
        raise AssertionError("AL selections card vs CPU: " + "; ".join(breaches))
    return report


def check_collect_activations(tree, data, dev, root: str) -> dict:
    """``CaseStudy.collect_activations`` of MNIST run 0 (the flax tree
    ``tree``) on the first ``ACTIVATION_ROWS`` rows of each set, on the card
    and on the CPU: the same files, dtypes and shapes, labels byte-equal,
    each tap within ``ACTIVATION_RTOL`` of its largest magnitude."""
    cut = tuple((x[:ACTIVATION_ROWS], y[:ACTIVATION_ROWS]) for x, y in data)
    cs = case_study(AL_FAMILY, cut)
    dumps, seconds = {}, {}
    for side, device in (("card", dev), ("cpu", torch.device("cpu"))):
        os.environ["TIP_ASSETS"] = os.path.join(root, f"activations_{side}")
        cs.save_params(0, tree)
        t0 = time.perf_counter()
        cs.collect_activations([0], device=device)
        seconds[side] = time.perf_counter() - t0
        folder = os.path.join(subdir("activations"), AL_FAMILY, "model_0")
        dumps[side] = {os.path.relpath(os.path.join(d, n), folder): os.path.join(d, n)
                       for d, _, names in os.walk(folder) for n in names}
    if set(dumps["card"]) != set(dumps["cpu"]):
        raise AssertionError("at_collection: card and CPU wrote other files")
    badges = -(-ACTIVATION_ROWS // 100)
    layers = len(PATHS[AL_FAMILY]["model"].all_layers)
    if len(dumps["card"]) != 3 * badges * (layers + 1):
        raise AssertionError(f"at_collection: {len(dumps['card'])} files, want "
                             f"{3 * badges * (layers + 1)}")
    worst = {}
    for name, path in dumps["card"].items():
        a, b = np.load(path), np.load(dumps["cpu"][name])
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"at_collection {name}: {a.dtype}{a.shape} on the card, "
                                 f"{b.dtype}{b.shape} on the CPU")
        layer = name.split(os.sep)[1]
        if layer == "labels":
            if a.tobytes() != b.tobytes():
                raise AssertionError(f"at_collection {name}: labels differ")
            continue
        rel = float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))
        worst[layer] = max(worst.get(layer, 0.0), rel)
        if rel > ACTIVATION_RTOL:
            raise AssertionError(f"at_collection {name}: card vs CPU {rel} of the tap's "
                                 f"largest magnitude > {ACTIVATION_RTOL}")
    report = {"rows_per_set": ACTIVATION_ROWS, "files": len(dumps["card"]),
              "relative_err_by_layer": worst, "card_s": seconds["card"], "cpu_s": seconds["cpu"]}
    print(json.dumps({"at_collection": report}))
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

    t0 = time.perf_counter()
    data = {family: make_data(family, args.seed) for family in PATHS}
    print(f"data_s {time.perf_counter() - t0:.3f}")

    root = tempfile.mkdtemp(prefix="tip_chip_smoke_")
    paths = {}
    try:
        os.environ["TIP_ASSETS"] = os.path.join(root, "train")
        training, params = {}, {}
        trees = {}
        for family in PATHS:
            cs, training[family] = train_family(family, data[family], dev)
            trees[family] = cs.load_params(0)
            params[family] = params_from_jax(trees[family])
        classes = {family: predicted_classes(family, params[family], data[family][0][0], dev)
                   for family in PATHS}

        kernels = [
            check_fused_forward(params["mnist"], data["mnist"][1][0], dev),
            check_cifar10_forward(params["cifar10"], data["cifar10"][1][0], dev),
            check_flash_attention(params["imdb"], data["imdb"][1][0], dev, args.seed),
            *check_flash_backward(params["imdb"], data["imdb"], dev, args.seed),
        ]
        wide = check_wide_heads(dev, args.seed)
        for k in kernels:
            part = {"flash_attention_fwd": "fwd", "flash_attention_bwd_dq": "dq",
                    "flash_attention_bwd_dkv": "dkv"}.get(k["name"])
            if part:
                k["at_wide_heads"] = {"shape": wide["shape"], **wide[part]}
        gradients = check_imdb_gradients(params["imdb"], data["imdb"], dev)
        dsa_by_path = {family: check_dsa_nearest(family, params[family], data[family][0][0],
                                                 data[family][1][0], dev)
                       for family in PATHS}

        for family in PATHS:
            paths[family] = run_path(family, params[family], data[family], dev, root)
        active = run_active_learning(data[AL_FAMILY], dev, root)
        al_check = compare_al_selections(params[AL_FAMILY], data[AL_FAMILY], dev)
        activations = check_collect_activations(trees[AL_FAMILY], data[AL_FAMILY], dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"train_s": {f: t["train_s"] for f, t in training.items()},
                      "paths_s": {f: p["slice_s"] for f, p in paths.items()},
                      "total_s": sum(p["slice_s"] for p in paths.values()),
                      "active_learning_s": active["seconds"]}))

    def launches_by_path(name):
        return {f: p["launches"][name] for f, p in paths.items() if name in PATHS[f]["kernels"]}

    train_launches = training["imdb"]["launches"]
    for k in kernels:
        if k["name"].startswith("flash_attention_bwd"):
            # The backward runs only in training: its launches are the IMDB epoch's.
            k["launches"] = train_launches[k["name"]]
        else:
            k["launches"] = sum(launches_by_path(k["name"]).values())
            if k["name"] == "flash_attention_fwd":
                k["training_launches"] = train_launches[k["name"]]
        if k["name"] in PATHS[AL_FAMILY]["kernels"]:
            k["al_launches"] = active["launches"][k["name"]]
    b2 = dsa_nearest_entry(dsa_by_path, launches_by_path("dsa_nearest"))
    b2["al_launches"] = active["launches"]["dsa_nearest"]
    kernels.insert(1, b2)
    print(json.dumps({"kernels": kernels}))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"gpu": smi, "build_s": build_s, "kernels": kernels, "training": training,
                       "imdb_gradients": gradients, "wide_heads": wide, "classes": classes,
                       "paths": paths, "active_learning": active, "al_selections": al_check,
                       "at_collection": activations}, f, indent=1)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
