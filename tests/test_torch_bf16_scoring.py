"""The bf16 scoring mode (``TIP_COMPUTE_DTYPE=bfloat16``) of the port
against the JAX package's, on the CPU.

- The knob: ``config.scoring_compute_dtype`` gives the JAX function's
  outcome for every value (a ``ValueError`` naming the value included);
  ``CaseStudy.scoring_model_def`` is the bf16 model where JAX's is, and
  ``model_def`` (training, at_collection) stays float32.
- The kernels' plain versions against the Pallas kernels in interpret mode
  with bfloat16 operands (B1 ``fused_mnist_probs``, B3
  ``fused_cifar10_probs``, B4 ``flash_attention``), compiled with XLA's
  ``xla_allow_excess_precision`` off so that XLA keeps the kernels' bf16
  roundings (with it on, XLA:CPU drops the rounding of MNIST's conv1
  products and the reference moves by 1.1e-4): probabilities within
  ``KERNEL_ATOL`` (measured 3e-8 and 7e-9: summation order only); B4's
  bfloat16 outputs within one bf16 ulp of each element's magnitude and at
  most ``APART_SHARE`` of them apart (the float32 sums' order can flip an
  output's rounding, or a p's), its float32 lse within 1e-6.
- The modules against flax's bf16 modules on bridged weights: taps within
  ``TAP_ULPS`` bf16 ulps (measured 0: the same roundings) and probabilities
  within ``PROBS_ATOL``; IMDB against both JAX cores in bf16: the flash core
  to the same bounds, the dense core (which rounds its scores and softmax
  weights to bf16 where the flash core does not) within ``PROBS_ATOL`` and
  taps within ``DENSE_TAP_SHARE`` of each tap's largest magnitude (measured
  at most 0.0114 over three seeds: JAX's own two cores differ by as much).
- ``run_prio_eval`` of a mini MNIST study in bf16 against the JAX case
  study in bf16 from the same checkpoint (caches off, DSA the one SA
  variant): the same artifact names, dtypes and shapes; uncertainties
  within ``PROBS_ATOL``; the rows whose coverage scores differ counted and
  capped at ``COVERAGE_ROWS_CAP``; DSA within ``DSA_RTOL`` (its traces are
  the module's taps in both packages); each
  approach's APFD within ``APFD_GAP``.
- The caches: an existing float32 key is unchanged, and a float32 entry
  never serves a bf16 handler (SA fits and coverage statistics).
- No bf16 backward: ``FlashAttention.backward`` raises on bfloat16.
- The fused chain scores with the bf16 module; its programs and costs are
  the bf16 module's own (a bf16 cost is graded against the H100's bf16
  peak, 989.4e12 FLOP/s); ``--workers 2`` workers inherit the mode.
"""

import dataclasses
import functools
import glob
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_tip_tpu import config as jax_config
from simple_tip_tpu.casestudies import base as jax_base
from simple_tip_tpu.casestudies import mini as jax_mini
from simple_tip_tpu.engine import surprise_handler as jax_surprise
from simple_tip_tpu.models import Cifar10ConvNet as FlaxCifar10ConvNet
from simple_tip_tpu.models import ImdbTransformer as FlaxImdbTransformer
from simple_tip_tpu.models import MnistConvNet as FlaxMnistConvNet
from simple_tip_tpu.ops import flash_attention as jax_flash
from simple_tip_tpu.ops import fused_forward as jax_fused
from simple_tip_tpu_torch import cli, config
from simple_tip_tpu_torch.bridge import glorot_params, params_from_jax, params_to_jax
from simple_tip_tpu_torch.casestudies import base, mini
from simple_tip_tpu_torch.engine import eval_prioritization, sa_prep
from simple_tip_tpu_torch.engine.coverage_handler import CoverageWorker
from simple_tip_tpu_torch.engine.coverage_stats_cache import (
    COV_STATS_FORMAT_VERSION,
    CoverageStatsCache,
)
from simple_tip_tpu_torch.engine.model_handler import BaseModel
from simple_tip_tpu_torch.engine.surprise_handler import SurpriseHandler
from simple_tip_tpu_torch.models import Cifar10ConvNet, ImdbTransformer, MnistConvNet
from simple_tip_tpu_torch.models.predict import mc_dropout_votes, predict
from simple_tip_tpu_torch.ops import flash_attention as fa
from simple_tip_tpu_torch.ops import fused_forward as ff
from simple_tip_tpu_torch.ops.apfd import apfd_from_order
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_transformer import FLASH, imdb_flax_params, renamed

CPU = torch.device("cpu")
KERNEL_ATOL = 1e-6
APART_SHARE = 1e-3
TAP_ULPS = 2
PROBS_ATOL = 5e-3
DENSE_TAP_SHARE = 0.03
COVERAGE_ROWS_CAP = 0.02
DSA_RTOL = 1e-4
APFD_GAP = 0.02
NO_EXCESS = {"xla_allow_excess_precision": False}


def _bf16_ulps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """|got - want| in bf16 ulps at max(|got|, |want|), element by element."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), 1e-30)
    return np.abs(got - want) / 2.0 ** (np.floor(np.log2(mag)) - 7)


# -- the knob -------------------------------------------------------------------


def _outcome(fn):
    try:
        return fn()
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("value", ["", "float32", "f32", " F32 ", "bfloat16", "bf16", " BF16 ",
                                   "float8", "float16"])
def test_knob_equals_jax(monkeypatch, value):
    monkeypatch.setenv("TIP_COMPUTE_DTYPE", value)
    assert _outcome(config.scoring_compute_dtype) == _outcome(jax_config.scoring_compute_dtype)


def test_scoring_model_is_bf16_and_training_stays_f32(monkeypatch):
    monkeypatch.delenv("TIP_COMPUTE_DTYPE", raising=False)
    cs = base.get_case_study("mini-mnist")
    assert cs.scoring_model_def is cs.model_def and cs.model_def.compute_dtype is None
    monkeypatch.setenv("TIP_COMPUTE_DTYPE", "bfloat16")
    for name in ("mnist", "cifar10", "imdb"):
        cs = base.get_case_study(name)
        assert cs.model_def.compute_dtype is None
        assert cs.scoring_model_def.compute_dtype == torch.bfloat16
        assert type(cs.scoring_model_def) is type(cs.model_def)
        assert "compute_dtype=torch.bfloat16" in repr(cs.scoring_model_def)
        assert "compute_dtype" not in repr(cs.model_def)


def test_unknown_dtype_stops_the_command_line(monkeypatch, tmp_path):
    monkeypatch.setenv("TIP_ASSETS", str(tmp_path / "assets"))
    monkeypatch.setenv("TIP_COMPUTE_DTYPE", "float8")
    with pytest.raises(ValueError, match="float8"):
        cli.main(["--phase", "test_prio", "--case-study", "mnist", "--device", "cpu"])
    with pytest.raises(ValueError, match="float8"):
        jax_base.get_case_study("mnist")
    assert not os.path.exists(tmp_path / "assets" / "priorities")


# -- the bridge's bf16 fragments ----------------------------------------------------


@pytest.mark.parametrize("k,n", [(288, 64), (27, 32), (576, 64)])
def test_bf16_fragments_hold_the_rounded_weights_in_mma_order(k, n):
    w = torch.from_numpy(np.random.default_rng(k).normal(size=(k, n)).astype(np.float32))
    frags = ff.bf16_fragments(w)
    assert frags.dtype == torch.bfloat16 and tuple(frags.shape) == (-(-k // 16), n // 8, 32, 4)
    want = torch.nn.functional.pad(w, (0, 0, 0, (-k) % 16)).to(torch.bfloat16)
    for ks in (0, frags.shape[0] - 1):
        for nt in (0, n // 8 - 1):
            for lane in (0, 5, 31):
                g, t = lane // 4, lane % 4
                rows = [16 * ks + r for r in (2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)]
                assert torch.equal(frags[ks, nt, lane], want[rows, 8 * nt + g])


# -- the kernels' plain versions against the Pallas kernels in interpret mode --------


def _pallas(fn, *args):
    """``fn(*args)`` jitted, compiled with XLA's excess precision off."""
    jitted = jax.jit(fn)
    return np.asarray(jitted.lower(*args).compile(NO_EXCESS)(*args))


@pytest.mark.parametrize("family", ["mnist", "cifar10"])
def test_fused_plain_versions_match_pallas_interpret_in_bf16(family):
    params = glorot_params(1, family)
    shape, tile = ((28, 28, 1), 8) if family == "mnist" else ((32, 32, 3), 4)
    kernel = jax_fused.fused_mnist_probs if family == "mnist" else jax_fused.fused_cifar10_probs
    plain = (ff.fused_mnist_probs_bf16_plain if family == "mnist"
             else ff.fused_cifar10_probs_bf16_plain)
    x = np.random.default_rng(2).uniform(0, 1, size=(11,) + shape).astype(np.float32)
    want = _pallas(lambda p, x: kernel(p, x, jnp.bfloat16, tile=tile, interpret=True),
                   params, jnp.asarray(x))
    got = plain(params_from_jax(params)["fused"], torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= KERNEL_ATOL
    # the bf16 mode is not float32's: the roundings move the probabilities
    f32 = ff.fused_mnist_probs_plain if family == "mnist" else ff.fused_cifar10_probs_plain
    assert np.abs(f32(params_from_jax(params)["fused"], torch.from_numpy(x)).numpy()
                  - want).max() > 100 * KERNEL_ATOL


@pytest.mark.parametrize("shape,t_kv", [((2, 100, 2, 32), 100), ((3, 37, 2, 32), 53),
                                        ((1, 1100, 1, 16), 1100)])
def test_flash_bf16_plain_matches_pallas_interpret(shape, t_kv):
    rng = np.random.default_rng(t_kv)
    b, t_q, h, dh = shape
    q = rng.normal(size=shape).astype(np.float32)
    k, v = (rng.normal(size=(b, t_kv, h, dh)).astype(np.float32) for _ in range(2))
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    want = _pallas(lambda q, k, v: jax_flash.flash_attention(
        q, k, v, interpret=True, compute_dtype=jnp.bfloat16).astype(jnp.float32),
        bf(q), bf(k), bf(v))
    # the TPU kernel's lse, from its call on the folded, padded operands
    block_q, block_kv = jax_flash._block_for(t_q), jax_flash._block_for(t_kv)
    assert block_kv == fa.jax_kv_block(t_kv)

    def folded(a, block):
        a = np.pad(a, ((0, 0), (0, (-a.shape[1]) % block), (0, 0), (0, 0)))
        return bf(a.transpose(0, 2, 1, 3).reshape(b * h, a.shape[1], dh))

    want_lse = _pallas(lambda q, k, v: jax_flash._flash_fwd_call(
        q, k, v, t_kv, block_q, block_kv, True)[1],
        folded(q, block_q), folded(k, block_kv), folded(v, block_kv))
    want_lse = want_lse.reshape(b, h, -1)[:, :, :t_q]
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    out, lse = fa.flash_attention_bf16_plain(tb(q), tb(k), tb(v))
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ulps = _bf16_ulps(out.float().numpy(), want)
    assert ulps.max() <= 1 and (ulps > 0).sum() <= max(1, APART_SHARE * ulps.size)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-6, atol=1e-6)


# -- the modules against flax's bf16 modules ----------------------------------------


@pytest.mark.parametrize("family", ["mnist", "cifar10"])
def test_convnet_taps_and_probs_match_flax_in_bf16(family):
    params = glorot_params(2, family)
    flax_model, model, shape = {
        "mnist": (FlaxMnistConvNet, MnistConvNet, (28, 28, 1)),
        "cifar10": (FlaxCifar10ConvNet, Cifar10ConvNet, (32, 32, 3)),
    }[family]
    x = np.random.default_rng(3).uniform(0, 1, size=(6,) + shape).astype(np.float32)
    want_probs, want_taps = flax_model(compute_dtype=jnp.bfloat16).apply(
        {"params": params}, jnp.asarray(x))
    net = model(compute_dtype="bfloat16").eval()
    net.load_state_dict(params_from_jax(params)["module"])
    with torch.no_grad():
        probs, taps = net(torch.from_numpy(x))
    assert probs.dtype == torch.float32 and sorted(taps) == sorted(want_taps)
    np.testing.assert_allclose(probs.numpy(), np.asarray(want_probs), atol=PROBS_ATOL, rtol=0)
    for i, want in want_taps.items():
        assert taps[i].dtype == torch.float32 and taps[i].shape == want.shape, i
        assert _bf16_ulps(taps[i].numpy(), np.asarray(want)).max() <= TAP_ULPS, i
    # predict takes the bf16 fused forward, within the JAX gate of the module
    got = predict(net, params_from_jax(params)["fused"], x, CPU).numpy()
    np.testing.assert_allclose(got, np.asarray(want_probs), atol=PROBS_ATOL, rtol=0)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_imdb_taps_and_probs_match_both_jax_cores_in_bf16(impl):
    params = imdb_flax_params(1)
    x = np.random.default_rng(1).integers(0, 2000, size=(6, 100)).astype(np.int32)
    jax_params = params if impl == "dense" else renamed(params, FLASH)
    want_probs, want_taps = FlaxImdbTransformer(
        attention_impl=impl, compute_dtype=jnp.bfloat16).apply({"params": jax_params},
                                                               jnp.asarray(x))
    net = ImdbTransformer(compute_dtype="bfloat16").eval()
    net.load_state_dict(params_from_jax(params)["module"])
    before = fa.BF16_LAUNCHES, fa.LAUNCHES
    with torch.no_grad():
        probs, taps = net(torch.from_numpy(x).long())
    assert (fa.BF16_LAUNCHES, fa.LAUNCHES) == before  # the plain versions on the CPU
    np.testing.assert_allclose(probs.numpy(), np.asarray(want_probs), atol=PROBS_ATOL, rtol=0)
    for i, want in want_taps.items():
        want = np.asarray(want)
        assert taps[i].dtype == torch.float32 and taps[i].shape == want.shape, i
        if impl == "flash":
            assert _bf16_ulps(taps[i].numpy(), want).max() <= TAP_ULPS, i
        else:
            assert np.abs(taps[i].numpy() - want).max() <= DENSE_TAP_SHARE * np.abs(want).max(), i


@pytest.mark.parametrize("family", ["mnist", "imdb"])
def test_bf16_vote_prefix_split_equals_a_stochastic_forward(family):
    params = params_from_jax(glorot_params(4, family))
    model = MnistConvNet if family == "mnist" else ImdbTransformer
    net = model(compute_dtype="bfloat16").eval()
    net.load_state_dict(params["module"])
    rng = np.random.default_rng(4)
    if family == "mnist":
        x = torch.from_numpy(rng.uniform(0, 1, size=(5, 28, 28, 1)).astype(np.float32))
    else:
        x = torch.from_numpy(rng.integers(0, 2000, size=(5, 100)))
    with torch.no_grad():
        split = net.vote_probs(net.vote_prefix(x), torch.Generator().manual_seed(9))
        full = net(x, train=True, generator=torch.Generator().manual_seed(9))[0]
    assert torch.equal(split, full)
    votes = mc_dropout_votes(net, x.numpy(), 7, torch.Generator().manual_seed(0), 4, CPU)
    assert votes.shape == (5, net.num_classes) and bool((votes.sum(dim=1) == 7).all())


def test_flash_backward_refuses_bf16():
    q = torch.randn(1, 8, 1, 16, dtype=torch.bfloat16, requires_grad=True)
    out = fa.flash_attention(q, q, q)
    assert out.dtype == torch.bfloat16
    with pytest.raises(RuntimeError, match="float32"):
        out.float().sum().backward()


# -- the caches' dtype tag ------------------------------------------------------------


def test_f32_keys_are_unchanged_and_bf16_keys_are_their_own():
    tree = glorot_params(6, "mnist")
    data = np.random.default_rng(6).uniform(0, 1, size=(5, 28, 28, 1)).astype(np.float32)
    f32 = sa_prep.train_fingerprint(tree, data, [3])
    assert f32 == sa_prep.content_fingerprint(sa_prep.CACHE_FORMAT_VERSION, tree, data, [3],
                                              "torch")
    assert sa_prep.train_fingerprint(tree, data, [3], None) == f32
    assert sa_prep.train_fingerprint(tree, data, [3], torch.bfloat16) != f32
    assert sa_prep.train_fingerprint(tree, data, [3], "bfloat16") == \
        sa_prep.train_fingerprint(tree, data, [3], torch.bfloat16)
    os.environ.pop("TIP_COV_STATS_CACHE_DIR", None)
    cov32 = CoverageStatsCache.from_env(tree, data, [0, 1])
    assert cov32.fingerprint == sa_prep.content_fingerprint(
        COV_STATS_FORMAT_VERSION, tree, data, [0, 1], "torch")
    assert CoverageStatsCache.from_env(tree, data, [0, 1], torch.bfloat16).path != cov32.path


def test_f32_entries_never_serve_a_bf16_handler(monkeypatch, tmp_path):
    monkeypatch.setenv("TIP_ASSETS", str(tmp_path))
    monkeypatch.delenv("TIP_SA_CACHE_DIR", raising=False)
    monkeypatch.delenv("TIP_COV_STATS_CACHE_DIR", raising=False)
    monkeypatch.setenv("TIP_CLUSTER_BACKEND", "jax")
    params = params_from_jax(glorot_params(7, "mnist"))
    rng = np.random.default_rng(7)
    train = rng.uniform(0, 1, size=(60, 28, 28, 1)).astype(np.float32)
    test = rng.uniform(0, 1, size=(10, 28, 28, 1)).astype(np.float32)

    def sa_outcome(dtype):
        handler = SurpriseHandler(MnistConvNet(compute_dtype=dtype), params, [3], train, 32,
                                  device=CPU, sa_names=("dsa",), case_study="mini", model_id=0)
        handler.evaluate_all({"nominal": test})
        return handler.cache_outcomes["dsa"]

    def cov_outcome(dtype):
        base_model = BaseModel(MnistConvNet(compute_dtype=dtype), params,
                               activation_layers=[0, 1], batch_size=32, device=CPU)
        return CoverageWorker(base_model, train).stats_cache_outcome

    assert [cov_outcome(None), cov_outcome("bfloat16"), cov_outcome("bfloat16"),
            cov_outcome(None)] == ["miss", "miss", "hit", "hit"]
    assert [sa_outcome(None), sa_outcome("bfloat16"), sa_outcome("bfloat16"),
            sa_outcome(None)] == ["fit", "fit", "hit", "hit"]


# -- run_prio_eval in bf16 against the JAX case study in bf16 -------------------------


def _names(root, sub):
    return sorted(os.path.basename(p) for p in glob.glob(os.path.join(root, sub, "*")))


def _order(name: str, values: np.ndarray) -> np.ndarray:
    """The prioritization order an artifact stands for: a CAM order as it
    is, scores and uncertainties most suspicious first."""
    if name.endswith("_cam_order.npy"):
        return values
    return np.argsort(-values, kind="stable")


def test_bf16_run_prio_eval_matches_the_jax_case_study(monkeypatch, tmp_path):
    assets, jax_assets = tmp_path / "assets", tmp_path / "jax_assets"
    for var, value in (("TIP_SA_POOL", "1"), ("TIP_SA_CACHE_DIR", "off"),
                       ("TIP_COV_STATS_CACHE_DIR", "off"), ("TIP_CAM_BACKEND", "auto"),
                       ("TIP_CLUSTER_BACKEND", "jax"), ("TIP_ASSETS", str(assets))):
        monkeypatch.setenv(var, value)
    for var in ("TIP_FUSED_CHAIN", "TIP_CHAIN_GROUP", "TIP_COMPUTE_DTYPE"):
        monkeypatch.delenv(var, raising=False)
    # mini-mnist's model and taps on 240 / 60 of its images, one epoch; both
    # packages read the same arrays
    loader = mini.image_loader((28, 28, 1), seed=41, n_train=240, n_test=60)
    spec = dataclasses.replace(
        mini.MINI_CASE_STUDIES["mini-mnist"], loader=loader,
        train_cfg=dataclasses.replace(mini.MINI_CASE_STUDIES["mini-mnist"].train_cfg, epochs=1))
    base.CaseStudy(spec).train([0], device=CPU)  # float32, as always
    monkeypatch.setenv("TIP_COMPUTE_DTYPE", "bfloat16")
    monkeypatch.setattr(eval_prioritization, "evaluate",
                        functools.partial(eval_prioritization.evaluate, sa_names=("dsa",)))
    cs = base.CaseStudy(spec)
    assert cs.scoring_model_def.compute_dtype == torch.bfloat16
    cs.run_prio_eval([0], device=CPU)

    monkeypatch.setattr(jax_surprise, "SA_VARIANTS", {"dsa": jax_surprise.SA_VARIANTS["dsa"]})
    os.makedirs(jax_assets / "models" / "mini-mnist")
    with open(assets / "models" / "mini-mnist" / "0.msgpack", "rb") as f, \
            open(jax_assets / "models" / "mini-mnist" / "0.msgpack", "wb") as g:
        g.write(f.read())
    monkeypatch.setenv("TIP_ASSETS", str(jax_assets))
    jax_cs = jax_base.CaseStudy(dataclasses.replace(jax_mini.MINI_CASE_STUDIES["mini-mnist"],
                                                    loader=loader))
    assert jax_cs.scoring_model_def.compute_dtype == "bfloat16"
    jax_cs.run_prio_eval([0])

    names = _names(assets, "priorities")
    assert len(names) == 2 * (1 + 5 + 2 * 13)  # mask, 5 uncertainties, 12 NC + dsa x 2
    assert set(names) <= set(_names(jax_assets, "priorities"))
    assert _names(assets, "times") == _names(jax_assets, "times")
    loaded = {}
    for name in names:
        got = np.load(assets / "priorities" / name)
        want = np.load(jax_assets / "priorities" / name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        loaded[name] = got, want
    rows_apart, total = 0, 0
    for name, (got, want) in loaded.items():
        kind = name.split("_0_", 1)[1][: -len(".npy")]
        if kind == "uncertainty_VR":
            assert got.min() >= 0 and got.max() <= 1, name
        elif kind.startswith("uncertainty_"):
            np.testing.assert_allclose(got, want, atol=PROBS_ATOL, rtol=0, err_msg=name)
        elif kind == "dsa_scores":
            np.testing.assert_allclose(got, want, rtol=DSA_RTOL, atol=0, err_msg=name)
        elif kind.endswith("_scores"):
            rows_apart += int((got != want).sum())
            total += got.size
        if kind.endswith("_scores") or kind.endswith("_cam_order") or (
                kind.startswith("uncertainty_") and kind != "uncertainty_VR"):
            ds = name.split("_0_", 1)[0]
            mask = f"{ds}_0_is_misclassified.npy"
            gap = abs(apfd_from_order(loaded[mask][0], _order(name, got))
                      - apfd_from_order(loaded[mask][1], _order(name, want)))
            assert gap <= APFD_GAP, (name, gap)
    assert rows_apart <= COVERAGE_ROWS_CAP * total, (rows_apart, total)
    mask_apart = sum(int((g != w).sum()) for n, (g, w) in loaded.items()
                     if n.endswith("is_misclassified.npy"))
    assert mask_apart <= COVERAGE_ROWS_CAP * sum(
        g.size for n, (g, _) in loaded.items() if n.endswith("is_misclassified.npy"))
    # training stayed float32: the checkpoint is a float32 flax tree
    assert all(np.asarray(leaf).dtype == np.float32 for leaf in jax.tree_util.tree_leaves(
        params_to_jax("mnist", params_from_jax(jax_cs.load_params(0))["module"])))


# -- grading a bf16 program against the bf16 peak --------------------------------------

H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("dtype", ["bfloat16", "bf16", torch.bfloat16])
def test_a_bf16_program_is_graded_against_the_bf16_peak(dtype):
    from simple_tip_tpu_torch.obs import devicemeter
    from simple_tip_tpu_torch.utils import flops

    assert flops.peak_flops("gpu", H100, compute_dtype=dtype)[0] == 989.4e12
    assert flops.peak_flops("gpu", H100)[0] == 165e12  # float32 programs: 3xTF32 as before
    assert flops.peak_flops("gpu", "NVIDIA A100-SXM4-80GB", compute_dtype=dtype)[0] is None
    peaks = devicemeter.resolve_peaks("gpu", H100, compute_dtype=str(dtype))
    assert peaks["flops_per_s"] == 989.4e12 and peaks["hbm_bytes_per_s"] == 3.35e12
    assert devicemeter.resolve_peaks("gpu", "NVIDIA A100-SXM4-80GB",
                                     compute_dtype=str(dtype))["analytic_only"]
    cost = devicemeter.chain_cost("mnist", 512, 100, [100], compute_dtype="bfloat16")
    f32_cost = devicemeter.chain_cost("mnist", 512, 100, [100])
    assert cost["compute_dtype"] == "bfloat16" and "compute_dtype" not in f32_cost
    assert cost["flops"] == f32_cost["flops"] and cost["bytes_accessed"] < f32_cost[
        "bytes_accessed"]  # the bf16 activations are half the bytes
    graded = devicemeter.grade(cost, 1e-3, platform="gpu", device_kind=H100)
    assert graded["peak_flops_per_s"] == 989.4e12
    assert graded["mfu"] == pytest.approx(cost["flops"] / 1e-3 / 989.4e12)
    doc = devicemeter.build_breakdown({"chain": {"cost": cost, "dispatch_s": 1e-3},
                                       "f32": {"cost": f32_cost, "dispatch_s": 1e-3}},
                                      "gpu", H100)
    assert doc["programs"]["chain"]["grade"]["peak_flops_per_s"] == 989.4e12
    assert doc["programs"]["f32"]["grade"]["peak_flops_per_s"] == 165e12


def test_chain_programs_of_the_bf16_module_are_their_own():
    from simple_tip_tpu_torch.engine import run_program
    from simple_tip_tpu_torch.obs import devicemeter

    state = params_from_jax(glorot_params(8))["module"]
    keys = [run_program.program_fingerprint(MnistConvNet(compute_dtype=dtype), state, [0, 1],
                                            {}, (4, 28, 28, 1), torch.float32, "chain")
            for dtype in (None, "bfloat16")]
    assert keys[0] != keys[1]
    layout = run_program._coverage_layout({}, 100, False)
    run_program._stamp_cost("bf16-chain-test", MnistConvNet(compute_dtype="bfloat16"), 8, layout)
    run_program._stamp_cost("f32-chain-test", MnistConvNet(), 8, layout)
    try:
        assert devicemeter.program_cost("bf16-chain-test")["compute_dtype"] == "bfloat16"
        assert "compute_dtype" not in devicemeter.program_cost("f32-chain-test")
    finally:
        devicemeter.record_program_cost("bf16-chain-test", None)
        devicemeter.record_program_cost("f32-chain-test", None)


def test_fused_chain_scores_with_the_bf16_module(monkeypatch, tmp_path):
    from simple_tip_tpu_torch.engine import coverage_handler, run_program
    from simple_tip_tpu_torch.ops.uncertainty import POINT_PRED_QUANTIFIERS

    monkeypatch.setenv("TIP_ASSETS", str(tmp_path))
    monkeypatch.setenv("TIP_COV_STATS_CACHE_DIR", "off")
    monkeypatch.setattr(run_program, "PROFILE_BADGE_SIZE", 16)
    monkeypatch.setattr(coverage_handler, "PROFILE_BADGE_SIZE", 16)
    params = params_from_jax(glorot_params(9))
    rng = np.random.default_rng(9)
    train = rng.uniform(0, 1, size=(40, 28, 28, 1)).astype(np.float32)
    x = rng.uniform(0, 1, size=(20, 28, 28, 1)).astype(np.float32)
    model = MnistConvNet(compute_dtype="bfloat16")
    got = run_program.FusedChainRunner(model, params, train, [0, 1], batch_size=8,
                                       device=CPU).score_dataset(x)
    base_model = BaseModel(model, params, activation_layers=[0, 1], batch_size=8, device=CPU)
    assert base_model.net.compute_dtype == torch.bfloat16
    with torch.no_grad():
        probs = base_model.net(torch.from_numpy(x))[0]
    np.testing.assert_array_equal(np.asarray(got["pred"]), probs.argmax(1).numpy())
    for name, fn in POINT_PRED_QUANTIFIERS.items():
        np.testing.assert_allclose(np.asarray(got["uncertainties"][name]), fn(probs)[1].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
    # the per-phase route's coverage from the same bf16 taps, byte-equal
    _, scores, _ = CoverageWorker(base_model, train).evaluate_all(x, "x")
    assert sorted(scores) == sorted(got["scores"])
    for mid, want in scores.items():
        assert np.array_equal(np.asarray(got["scores"][mid]), want), mid


def test_workers_inherit_the_bf16_mode(tmp_path, monkeypatch):
    """``--workers 2`` spawns workers that score in bf16 too: their
    artifacts equal the in-process bf16 walk's byte for byte, and not the
    float32 walk's."""
    from test_torch_sched_provider import provide

    tests_dir = os.path.dirname(os.path.abspath(__file__))
    monkeypatch.setenv("TIP_CASE_STUDY_PROVIDER", "test_torch_sched_provider:provide")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [tests_dir, os.path.dirname(tests_dir), os.environ.get("PYTHONPATH", "")]))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    for var in ("TIP_SA_CACHE_DIR", "TIP_COV_STATS_CACHE_DIR"):
        monkeypatch.setenv(var, "off")
    for var in ("TIP_FUSED_CHAIN", "TIP_CHAIN_GROUP", "TIP_JOURNAL", "TIP_FAULT_PLAN",
                "TIP_WORKER_PLATFORMS", "TIP_OBS_DIR", "TIP_COMPUTE_DTYPE"):
        monkeypatch.delenv(var, raising=False)
    roots = {name: tmp_path / name for name in ("workers", "bf16", "f32")}
    monkeypatch.setenv("TIP_ASSETS", str(roots["workers"]))
    provide("sched-mnist").train([0, 1], device="cpu")
    for name in ("bf16", "f32"):
        shutil.copytree(roots["workers"] / "models", roots[name] / "models")
    for name, dtype in (("workers", "bfloat16"), ("bf16", "bfloat16"), ("f32", None)):
        monkeypatch.setenv("TIP_ASSETS", str(roots[name]))
        if dtype:
            monkeypatch.setenv("TIP_COMPUTE_DTYPE", dtype)
        else:
            monkeypatch.delenv("TIP_COMPUTE_DTYPE")
        provide("sched-mnist").run_prio_eval([0, 1], device="cpu",
                                              num_workers=2 if name == "workers" else 1)

    def priorities(root):
        folder = os.path.join(root, "priorities")
        return {n: np.load(os.path.join(folder, n)) for n in sorted(os.listdir(folder))}

    got, bf16, f32 = (priorities(roots[n]) for n in ("workers", "bf16", "f32"))
    assert sorted(got) == sorted(bf16) == sorted(f32) and len(got) == 2 * 2 * (1 + 5 + 2 * 13)
    for name in got:
        assert got[name].tobytes() == bf16[name].tobytes(), name
    assert any(got[n].tobytes() != f32[n].tobytes() for n in got if "uncertainty_softmax" in n)
