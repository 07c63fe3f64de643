"""The port's ``engine/run_program.py`` and the fused route of ``evaluate``,
held against the JAX package and against the port's own per-phase route.

On the CPU a program is the eager closure, so these tests hold the route's
values and files; the CUDA graph that the card resolves is held against the
eager chain by ``chip_smoke.py``. Seeded numpy inputs and flax weights (the
MNIST architecture at 28x28 and the IMDB transformer, a few dozen rows) go
through the bridge into both packages:

- the knobs' grammar and messages equal the JAX package's;
- fingerprints change with the parameter layout, thresholds, badge shape,
  dtype, taps and tags, and not with equal inputs;
- ``evaluate`` with ``TIP_FUSED_CHAIN=1`` writes, on the inputs and
  weights of ``test_torch_slice.py``, the per-phase route's artifact set: masks, coverage scores, CAM orders and VR byte-equal,
  uncertainties within 1e-5 (the per-phase route predicts MNIST through
  B1's plain version, the chain through the module); and the JAX fused
  route's (``_eval_fused_chain``): the same, but VR, which draws from
  torch's generator, held by dtype, shape and range;
- ``GroupChainRunner`` at G=2 with a ragged last group, and
  ``evaluate_group`` over 5 models at G=2, byte-equal per member to the
  per-model fused walk;
- no card, no fallback: the runners' default device raises without one.
"""

import os

import numpy as np
import pytest
import torch

from simple_tip_tpu.engine import eval_prioritization as jax_ep
from simple_tip_tpu.engine import run_program as jax_rp
from simple_tip_tpu.models import ImdbTransformer as FlaxImdbTransformer
from simple_tip_tpu.models import MnistConvNet as FlaxMnistConvNet
from simple_tip_tpu_torch.bridge import params_from_jax
from simple_tip_tpu_torch.engine import eval_prioritization as ep
from simple_tip_tpu_torch.engine import run_program as rp
from simple_tip_tpu_torch.models import ImdbTransformer, MnistConvNet
from simple_tip_tpu_torch.ops.coverage import NAC
from test_torch_model import flax_params
from test_torch_slice import _data as slice_data
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_transformer import imdb_flax_params

UNCERTAINTY_ATOL = 1e-5
# family: (flax model, port model, flax weights of a seed, NC taps, input maker)
FAMILIES = {
    "mnist": (FlaxMnistConvNet, MnistConvNet, flax_params, [0, 1, 2, 3],
              lambda rng, n: rng.random((n, 28, 28, 1), dtype=np.float32)),
    "imdb": (FlaxImdbTransformer, ImdbTransformer, imdb_flax_params, [3, 5],
             lambda rng, n: rng.integers(0, 2000, (n, 100)).astype(np.int64)),
}
ROWS = {"train": 48, "nominal": 40, "ood": 24}
BADGE = 16


@pytest.fixture(autouse=True)
def _caches_off(monkeypatch):
    for var in ("TIP_SA_CACHE_DIR", "TIP_COV_STATS_CACHE_DIR", "TIP_PROGRAM_CACHE_DIR"):
        monkeypatch.setenv(var, "off")
    for var in ("TIP_FUSED_CHAIN", "TIP_CHAIN_GROUP", "TIP_INT8_PROFILES"):
        monkeypatch.delenv(var, raising=False)


def _data(family: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    make = FAMILIES[family][4]
    classes = 10 if family == "mnist" else 2
    return {name: (make(rng, n), rng.integers(0, classes, n)) for name, n in ROWS.items()}


# -- knobs --------------------------------------------------------------------


@pytest.mark.parametrize(
    "knob,var,cases",
    [
        ("fused_chain_enabled", "TIP_FUSED_CHAIN",
         ["1", "on", "TRUE", " On ", "", "0", "off", "no", "2"]),
        ("int8_profiles_enabled", "TIP_INT8_PROFILES", ["1", "on", "true", "", "0", "yes"]),
        ("chain_group_size", "TIP_CHAIN_GROUP",
         ["", "0", "off", "OFF", "1", "2", "4", "8", "-3", " 3 ", "two", "1.5"]),
    ],
)
def test_knobs_match_jax(monkeypatch, knob, var, cases):
    """Every value of each knob reads as in the JAX package, errors with the
    same message, and an unset knob is off."""
    for raw in cases:
        monkeypatch.setenv(var, raw)
        outcomes = []
        for module in (rp, jax_rp):
            try:
                outcomes.append(("value", getattr(module, knob)()))
            except ValueError as e:
                outcomes.append(("error", str(e)))
        assert outcomes[0] == outcomes[1], raw
    monkeypatch.delenv(var)
    assert getattr(rp, knob)() == getattr(jax_rp, knob)() in (False, 1)


# -- fingerprints -------------------------------------------------------------


def test_program_fingerprint_invalidation():
    """The chain key changes with the parameter layout, a metric's
    thresholds, the module's configuration, the taps, the badge shape, the
    dtype and the tags; equal inputs give equal keys."""
    net = MnistConvNet()
    weights = dict(net.state_dict())
    metrics = {"NAC_0": NAC(cov_threshold=0.0)}
    shape, layers = (16, 28, 28, 1), (0, 1, 2, 3)

    def key(net=net, weights=weights, layers=layers, metrics=metrics, shape=shape,
            dtype=torch.float32, tags=("chain",)):
        return rp.program_fingerprint(net, weights, layers, metrics, shape, dtype, *tags)

    base = key()
    assert base == key(net=MnistConvNet(), weights=dict(MnistConvNet().state_dict()))
    other = MnistConvNet(num_classes=7)
    variants = [
        key(shape=(32, 28, 28, 1)),
        key(dtype=torch.float16),
        key(metrics={"NAC_0": NAC(cov_threshold=0.5)}),
        key(net=other),
        key(weights=dict(other.state_dict())),
        key(layers=(0, 1)),
        key(tags=("chain", "int8=True")),
        key(tags=("chain", "device=cuda")),
        key(tags=("group_chain",)),
    ]
    assert len({base, *variants}) == len(variants) + 1


def test_select_and_rank_fingerprints_shape_keyed():
    """The select program is keyed by its shape and tags. The rank runs
    eagerly (the greedy reads the host every 32 picks), so no key names it:
    the JAX package's ``rank_fingerprint`` has no counterpart."""
    sel = rp.select_fingerprint(512, 5)
    assert sel == rp.select_fingerprint(512, 5)
    assert len({sel, rp.select_fingerprint(1024, 5), rp.select_fingerprint(512, 6),
                rp.select_fingerprint(512, 5, "group=2"),
                rp.select_fingerprint(512, 5, "device=cuda")}) == 5
    assert not hasattr(rp, "rank_fingerprint")


# -- the fused route of evaluate ----------------------------------------------


def _artifacts(root: str, family: str, model_id: int) -> dict:
    folder = os.path.join(root, "priorities")
    prefix = f"{family}_"
    out = {}
    for name in sorted(os.listdir(folder)):
        ds, mid, kind = name[len(prefix):-4].split("_", 2)
        if name.startswith(prefix) and int(mid) == model_id:
            out[(ds, kind)] = np.load(os.path.join(folder, name))
    return out


def _evaluate(monkeypatch, root, family, tree, data, fused: bool, model_id: int = 0):
    monkeypatch.setenv("TIP_ASSETS", str(root))
    # small badges: a padded 512-row badge costs seconds a call on one CPU
    # thread, and no value depends on the badge size
    monkeypatch.setattr(rp, "PROFILE_BADGE_SIZE", BADGE)
    if fused:
        monkeypatch.setenv("TIP_FUSED_CHAIN", "1")
    else:
        monkeypatch.delenv("TIP_FUSED_CHAIN", raising=False)
    phases, _ = ep.evaluate(
        model_id=model_id, case_study=family, model_def=FAMILIES[family][1](),
        params=params_from_jax(tree), training_dataset=data["train"][0],
        nominal_test_dataset=data["nominal"][0], nominal_test_labels=data["nominal"][1],
        ood_test_dataset=data["ood"][0], ood_test_labels=data["ood"][1],
        nc_activation_layers=FAMILIES[family][3], sa_activation_layers=[], batch_size=32,
        device="cpu", sa_names=(),
    )
    return phases


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def routes(request, tmp_path_factory):
    """The port's per-phase and fused routes and the JAX fused route on one
    family's inputs: ``(family, {route: artifacts}, fused phases)``."""
    family = request.param
    flax_model, _, make_tree, layers, _ = FAMILIES[family]
    # the slice test's inputs and weights, on which the two packages' taps
    # cross no threshold apart (their convolutions sum in other orders)
    x_train, x_test, y_test, x_ood = slice_data(family)
    tree = make_tree(4)
    data = {"train": (x_train, None), "nominal": (x_test, y_test), "ood": (x_ood, y_test)}
    arts = {}
    with pytest.MonkeyPatch.context() as mp:
        for var in ("TIP_SA_CACHE_DIR", "TIP_COV_STATS_CACHE_DIR", "TIP_PROGRAM_CACHE_DIR"):
            mp.setenv(var, "off")
        for route in ("per_phase", "fused"):
            root = tmp_path_factory.mktemp(f"{family}_{route}")
            phases = _evaluate(mp, root, family, tree, data, route == "fused")
            arts[route] = _artifacts(str(root), family, 0)
        root = tmp_path_factory.mktemp(f"{family}_jax")
        mp.setenv("TIP_ASSETS", str(root))
        jax_ep._eval_fused_chain(
            family, flax_model(), tree, 0, layers, data["nominal"][0], data["nominal"][1],
            data["ood"][0], data["ood"][1], data["train"][0], 32,
        )
        arts["jax"] = _artifacts(str(root), family, 0)
    yield family, arts, phases


def test_fused_phases_replace_fault_predictors_and_coverage(routes):
    _, _, phases = routes
    assert set(phases) == {"fused_chain", "surprise"}
    assert all(v >= 0 for v in phases.values())


def test_fused_artifacts_match_per_phase(routes):
    """The fused route writes the per-phase route's files: masks, scores,
    CAM orders and VR byte-equal, uncertainties within 1e-5."""
    _, arts, _ = routes
    got, want = arts["fused"], arts["per_phase"]
    assert set(got) == set(want)
    assert ("nominal", "uncertainty_VR") in want
    for key, ref in want.items():
        assert got[key].dtype == ref.dtype and got[key].shape == ref.shape, key
        if key[1].startswith("uncertainty_") and key[1] != "uncertainty_VR":
            np.testing.assert_allclose(got[key], ref, rtol=0, atol=UNCERTAINTY_ATOL,
                                       err_msg=str(key))
        else:
            np.testing.assert_array_equal(got[key], ref, err_msg=str(key))


def test_fused_artifacts_match_jax_fused_route(routes):
    """Against the JAX package's ``_eval_fused_chain``: the same files,
    dtypes and shapes; masks, scores and CAM orders byte-equal,
    uncertainties within 1e-5, VR (other generators) within its range."""
    _, arts, _ = routes
    got, want = arts["fused"], arts["jax"]
    assert set(got) == set(want)
    for key, ref in want.items():
        assert got[key].dtype == ref.dtype and got[key].shape == ref.shape, key
        if key[1] == "uncertainty_VR":
            assert ((got[key] >= 0) & (got[key] <= 1 - 1 / 200)).all()
        elif key[1].startswith("uncertainty_"):
            np.testing.assert_allclose(got[key], ref, rtol=0, atol=UNCERTAINTY_ATOL,
                                       err_msg=str(key))
        else:
            np.testing.assert_array_equal(got[key], ref, err_msg=str(key))


# -- runners ------------------------------------------------------------------


def _same_result(got: dict, want: dict, label: str) -> None:
    for key in ("pred", "uncertainties", "scores", "cam_orders", "al_select"):
        g, w = got[key], want[key]
        if isinstance(w, dict):
            assert set(g) == set(w), f"{label}: {key}"
            for name in w:
                assert g[name].dtype == w[name].dtype, f"{label}: {key} {name}"
                np.testing.assert_array_equal(g[name], w[name], err_msg=f"{label}: {key} {name}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{label}: {key}")


def test_group_runner_matches_fused_runner():
    """Three members at G=2, the second group ragged (one member and a
    padding copy of it): every member's result, VR and the AL select
    included, byte-equal to its own ``FusedChainRunner`` walk, one group
    dispatch per badge; both groups resolve one shared program and each
    binds its own weights and cut tables into it."""
    rp._RESOLVED.clear()
    data = _data("mnist", 1)
    x_train, x = data["train"][0], data["nominal"][0]
    members = [params_from_jax(flax_params(s)) for s in (4, 5, 6)]
    kwargs = dict(batch_size=16, badge_size=BADGE, device="cpu")
    refs = []
    for run, params in enumerate(members):
        runner = rp.FusedChainRunner(MnistConvNet(), params, x_train, [0, 1, 2, 3], **kwargs)
        refs.append(runner.evaluate_dataset(x, seed=run, select_k=5))
        assert runner.chain_dispatches == -(-len(x) // BADGE)
        assert runner.rank_dispatches == 12 and runner.select_dispatches == 5
    got, programs = [], set()
    for lo in (0, 2):
        group = rp.GroupChainRunner(MnistConvNet(), members[lo:lo + 2], x_train, [0, 1, 2, 3],
                                    group_size=2, **kwargs)
        got += group.evaluate_dataset(x, seeds=list(range(lo, min(lo + 2, 3))), select_k=5)
        assert group.group_chain_dispatches == -(-len(x) // BADGE)
        programs |= {id(p) for p in group._programs.values()}
    assert len(programs) == 1
    assert len(got) == 3
    for run, (g, r) in enumerate(zip(got, refs)):
        _same_result(g, r, f"member {run}")


def test_group_runner_refuses_mixed_structure():
    data = _data("mnist", 1)
    params = params_from_jax(flax_params(4))
    with pytest.raises(ValueError, match="exceed group_size"):
        rp.GroupChainRunner(MnistConvNet(), [params] * 3, data["train"][0], [0, 1, 2, 3],
                            group_size=2, device="cpu")
    with pytest.raises(ValueError, match="at least one member"):
        rp.GroupChainRunner(MnistConvNet(), [], data["train"][0], [0, 1, 2, 3], device="cpu")


def test_badge_buffer_takes_the_uploaded_layout():
    """The chain's badge buffer has the strides ``to_device`` gives the
    data (the per-phase route's badges): a one-channel image set made with
    ``[..., None]`` uploads with channel stride 0, and the card picks its
    convolution algorithms by such strides."""
    images = np.random.default_rng(0).random((6, 28, 28), dtype=np.float32)
    for x, channel_stride in ((images[..., None], 0), (images[..., None].copy(), 1)):
        shape, dtype, strides = rp.badge_layout(x, BADGE, torch.device("cpu"))
        assert shape == (BADGE, 28, 28, 1) and dtype == torch.float32
        assert strides == (784, 28, 1, channel_stride)
        runner = rp.FusedChainRunner(MnistConvNet(), params_from_jax(flax_params(4)),
                                     x, [0, 1, 2, 3], badge_size=BADGE, device="cpu")
        buf = runner.chain_program(shape, dtype, strides).args[1]
        assert buf.stride() == strides and not buf.any()


def test_stage_pads_a_ragged_tail_with_member_zero():
    trees = [params_from_jax(flax_params(s)) for s in (4, 5)]
    staged = rp.GroupChainRunner.stage(trees, 3, "cpu").ready()
    assert len(staged) == 3
    for member, src in zip(staged, (0, 1, 0)):
        assert set(member) == set(trees[src]["module"])
        for name, leaf in member.items():
            np.testing.assert_array_equal(leaf.numpy(), trees[src]["module"][name].numpy())


def test_evaluate_group_matches_per_model_walk(tmp_path, monkeypatch):
    """Five models at G=2 (a ragged last group of one) write, per model,
    the files the per-model fused walk writes, byte for byte."""
    data = _data("mnist", 2)
    trees = {mid: flax_params(10 + mid) for mid in range(5)}
    for mid, tree in trees.items():
        _evaluate(monkeypatch, tmp_path / "per_model", "mnist", tree, data, True, model_id=mid)
    monkeypatch.setenv("TIP_ASSETS", str(tmp_path / "grouped"))
    monkeypatch.setattr(rp, "PROFILE_BADGE_SIZE", BADGE)
    out = ep.evaluate_group(
        list(range(5)), "mnist", MnistConvNet(), lambda mid: params_from_jax(trees[mid]),
        data["train"][0], data["nominal"][0], data["nominal"][1], data["ood"][0],
        data["ood"][1], [0, 1, 2, 3], sa_activation_layers=[], batch_size=32, group_size=2,
        device="cpu", sa_names=(),
    )
    assert sorted(out) == list(range(5))
    assert all(set(phases) == {"fused_chain", "surprise"} for phases, _ in out.values())
    for mid in range(5):
        want = _artifacts(str(tmp_path / "per_model"), "mnist", mid)
        got = _artifacts(str(tmp_path / "grouped"), "mnist", mid)
        assert set(got) == set(want) and len(want) == 2 * (1 + 5 + 2 * 12)
        for key, ref in want.items():
            assert got[key].dtype == ref.dtype
            np.testing.assert_array_equal(got[key], ref, err_msg=f"model {mid}: {key}")


@pytest.mark.skipif(torch.cuda.is_available(), reason="holds the refusal where no card is visible")
def test_runners_refuse_without_a_card():
    data = _data("mnist", 1)
    params = params_from_jax(flax_params(4))
    for build in (
        lambda: rp.FusedChainRunner(MnistConvNet(), params, data["train"][0], [0, 1, 2, 3]),
        lambda: rp.GroupChainRunner(MnistConvNet(), [params], data["train"][0], [0, 1, 2, 3]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
