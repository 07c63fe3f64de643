"""Port parity for fresh parameters, the inverse bridge, checkpoints and the
case study.

- ``init_params`` has the JAX ``init_params`` tree (names, shapes, dtypes)
  and flax's distributions: glorot kernels inside their limit with the
  variance of ``U(-limit, limit)`` within 10% where a leaf has 1,000 entries
  or more, zero biases, embeddings in [-0.05, 0.05], layer norms 1 and 0.
- ``params_to_jax(params_from_jax(tree)) == tree`` bit for bit.
- The port's checkpoint writer gives ``flax.serialization.to_bytes``'s
  bytes; its reader returns flax-written arrays byte-equal; flax reads
  port-written bytes back equal; and on disk, either package's
  ``CaseStudy`` reads the other's ``save_params``.
- ``CaseStudy.train`` writes one checkpoint per run and reuses them;
  ``run_prio_eval`` writes the artifact set of the 39 approaches under the
  JAX names, dtypes and shapes.
"""

import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from simple_tip_tpu.casestudies import mini as jax_mini
from simple_tip_tpu.casestudies.base import CaseStudy as JaxCaseStudy
from simple_tip_tpu.models import Cifar10ConvNet as FlaxCifar10ConvNet
from simple_tip_tpu.models import ImdbTransformer as FlaxImdbTransformer
from simple_tip_tpu.models import MnistConvNet as FlaxMnistConvNet
from simple_tip_tpu.models.train import init_params as jax_init_params
from simple_tip_tpu_torch.bridge import params_from_jax, params_to_jax
from simple_tip_tpu_torch.casestudies import base, mini
from simple_tip_tpu_torch.models.init import init_params
from simple_tip_tpu_torch.models.train import TrainConfig
from simple_tip_tpu_torch.utils import checkpoint
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

FAMILIES = {
    "mnist": (FlaxMnistConvNet(), np.zeros((1, 28, 28, 1), np.float32)),
    "cifar10": (FlaxCifar10ConvNet(), np.zeros((1, 32, 32, 3), np.float32)),
    "imdb": (FlaxImdbTransformer(), np.zeros((1, 100), np.int32)),
}


def _jax_tree(family: str, seed: int = 0):
    model, example = FAMILIES[family]
    return jax.tree_util.tree_map(np.asarray, jax_init_params(model, jax.random.PRNGKey(seed), example))


def _assert_trees_equal(a, b):
    leaves_a = jax.tree_util.tree_leaves_with_path(a)
    leaves_b = jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in leaves_a] == [p for p, _ in leaves_b]
    for (path, x), (_, y) in zip(leaves_a, leaves_b):
        assert x.dtype == y.dtype and x.shape == y.shape, jax.tree_util.keystr(path)
        assert x.tobytes() == y.tobytes(), jax.tree_util.keystr(path)


def _glorot_limit(path, shape) -> float:
    """flax's glorot-uniform limit for a kernel (``DenseGeneral`` flattened)."""
    if len(shape) == 4:
        fans = (shape[0] * shape[1] * shape[2], shape[0] * shape[1] * shape[3])
    elif len(shape) == 3 and path[-2].key == "out":
        fans = (shape[0] * shape[1], shape[2])
    elif len(shape) == 3:
        fans = (shape[0], shape[1] * shape[2])
    else:
        fans = shape
    return float(np.sqrt(6.0 / (fans[0] + fans[1])))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_init_params_has_the_jax_tree_and_flax_distributions(family):
    ours = init_params(family, torch.Generator().manual_seed(0))
    theirs = _jax_tree(family)
    assert list(ours) == list(theirs)  # sorted, as jit returns them
    assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(theirs)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(ours),
                                 jax.tree_util.tree_leaves_with_path(theirs)):
        name = jax.tree_util.keystr(path)
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32, name
        leaf = path[-1].key
        if leaf == "kernel":
            limit = _glorot_limit(path, a.shape)
            for draw in (a, b):  # flax's own draw obeys the same limit
                assert np.abs(draw).max() <= limit, name
                if draw.size >= 1000:
                    var = float(np.var(draw.astype(np.float64)))
                    assert abs(var / (limit**2 / 3) - 1) < 0.1, (name, var)
        elif leaf == "embedding":
            assert np.abs(a).max() <= 0.05, name
        elif leaf == "scale":
            assert (a == 1).all(), name
        else:
            assert (a == 0).all(), name


def test_init_glorot_limits_and_variances():
    tree = init_params("imdb", torch.Generator().manual_seed(1))
    attn = tree["TransformerBlock_0"]["MultiHeadDotProductAttention_0"]
    cases = {
        "qkv": (attn["query"]["kernel"], 32, 64),  # DenseGeneral [32, (2, 32)]
        "out": (attn["out"]["kernel"], 64, 32),  # DenseGeneral [(2, 32), 32]
        "ffn": (tree["TransformerBlock_0"]["Dense_0"]["kernel"], 32, 32),
    }
    conv = init_params("cifar10", torch.Generator().manual_seed(1))
    cases["conv"] = (conv["Conv_1"]["kernel"], 9 * 32, 9 * 64)
    cases["dense"] = (conv["Dense_0"]["kernel"], 1024, 64)
    for name, (kernel, fan_in, fan_out) in cases.items():
        limit = np.sqrt(6.0 / (fan_in + fan_out))
        assert np.abs(kernel).max() <= limit, name
        if kernel.size >= 1000:
            var = float(np.var(kernel.astype(np.float64)))
            assert abs(var / (limit**2 / 3) - 1) < 0.1, (name, var)
    emb = tree["TokenAndPositionEmbedding_0"]["Embed_0"]["embedding"]
    assert np.abs(emb).max() <= 0.05 and abs(np.var(emb) / (0.05**2 / 3) - 1) < 0.1
    again = init_params("imdb", torch.Generator().manual_seed(1))
    _assert_trees_equal(tree, again)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_params_to_jax_inverts_the_bridge(family):
    tree = _jax_tree(family, seed=3)
    _assert_trees_equal(params_to_jax(family, params_from_jax(tree)["module"]), tree)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_checkpoint_bytes_match_flax_both_ways(family):
    tree = _jax_tree(family, seed=4)
    written = checkpoint.to_bytes(tree)
    assert written == serialization.to_bytes(tree)
    _assert_trees_equal(checkpoint.from_bytes(serialization.to_bytes(tree)), tree)
    back = jax.tree_util.tree_map(np.asarray, serialization.from_bytes(tree, written))
    _assert_trees_equal(back, tree)
    with pytest.raises(ValueError):
        checkpoint.from_bytes(written + b"\x00")


def _tiny_spec(name: str) -> base.CaseStudySpec:
    """A mini-mnist-shaped study at 200 training and 40 test images; SA on
    the softmax tap (the five SA variants at 1,600 features take minutes on
    the CPU)."""
    return base.CaseStudySpec(
        name=name, model_factory=mini.MINI_CASE_STUDIES["mini-mnist"].model_factory,
        loader=mini.image_loader((28, 28, 1), seed=41, n_train=200, n_test=40),
        train_cfg=TrainConfig(batch_size=64, epochs=2, learning_rate=2e-3, validation_split=0.1),
        nc_activation_layers=(0, 1, 2, 3), sa_activation_layers=(6,),
        prediction_badge_size=128, num_classes=10,
    )


def test_checkpoints_cross_between_the_packages_on_disk(tmp_path, monkeypatch):
    monkeypatch.setenv("TIP_ASSETS", str(tmp_path))
    jax_cs = JaxCaseStudy(jax_mini.MINI_CASE_STUDIES["mini-mnist"])
    port_cs = mini.provide("mini-mnist")
    assert port_cs.model_path(0) == jax_cs.model_path(0)
    jax_tree = _jax_tree("mnist", seed=5)
    jax_cs.save_params(0, jax_tree)
    _assert_trees_equal(port_cs.load_params(0), jax_tree)
    port_tree = init_params("mnist", torch.Generator().manual_seed(6))
    port_cs.save_params(1, port_tree)
    _assert_trees_equal(jax.tree_util.tree_map(np.asarray, jax_cs.load_params(1)), port_tree)


def test_case_study_trains_reuses_and_scores(tmp_path, monkeypatch):
    monkeypatch.setenv("TIP_ASSETS", str(tmp_path))
    cs = base.CaseStudy(_tiny_spec("tiny-mnist"))
    histories = cs.train([0, 1], device="cpu")
    assert sorted(histories) == [0, 1] and all(len(h) == 2 for h in histories.values())
    paths = [cs.model_path(i) for i in (0, 1)]
    stamps = [os.stat(p).st_mtime_ns for p in paths]
    assert cs.train([0, 1], device="cpu") == {}
    assert [os.stat(p).st_mtime_ns for p in paths] == stamps
    assert not np.array_equal(cs.load_params(0)["Dense_0"]["kernel"],
                              cs.load_params(1)["Dense_0"]["kernel"])
    cs.run_prio_eval([0], device="cpu")
    prio = os.listdir(tmp_path / "priorities")
    assert len(prio) == 2 * (1 + 5 + 2 * 12 + 2 * 5)  # mask, 5 uncertainties, NC, 5 SA
    for ds, n in (("nominal", 40), ("ood", 80)):
        assert np.load(tmp_path / "priorities" / f"tiny-mnist_{ds}_0_is_misclassified.npy").shape == (n,)
        order = np.load(tmp_path / "priorities" / f"tiny-mnist_{ds}_0_NAC_0_cam_order.npy")
        assert order.dtype == np.int64 and sorted(order) == list(range(n))
        vr = np.load(tmp_path / "priorities" / f"tiny-mnist_{ds}_0_uncertainty_VR.npy")
        assert vr.dtype == np.float64 and vr.shape == (n,)
    cs.save_params(2, {"Dense_0": cs.load_params(0)["Dense_0"]})
    with pytest.raises(ValueError):
        cs.load_params(2)


def test_get_case_study_resolves_minis_and_the_provider_and_names_what_is_missing(monkeypatch):
    assert base.get_case_study("mini-cifar10").spec.name == "mini-cifar10"
    # the paper names resolve to the registry since the port has the loaders
    assert base.get_case_study("imdb").spec is base.CASE_STUDIES["imdb"]
    with pytest.raises(KeyError, match="unknown"):
        base.get_case_study("svhn")
    monkeypatch.setenv("TIP_CASE_STUDY_PROVIDER", "test_torch_checkpoint:_provide")
    assert base.get_case_study("tiny-mnist").spec.name == "tiny-mnist"


def _provide(name: str):
    return base.CaseStudy(_tiny_spec(name)) if name == "tiny-mnist" else None
