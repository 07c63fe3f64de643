"""The port's ``ops/fused_chain.py`` held against the JAX package's.

The same seeded inputs and flax weights (the MNIST architecture at 28x28,
a few dozen rows; the port's convnet has the published widths only, so the
JAX tests' 12x12 model does not bridge) go through both packages' chain
functions: predictions, packed words (int32 words whose bytes are the JAX
package's uint32 words) and coverage scores byte-equal, uncertainties
within 1e-5. Also held: the int8 codebook, on and off, against the plain
metrics and the JAX codebook, with NaN, ties, infinities and the refusal
above 127 cuts; padding rows all zero; the group chain per member against
the single chain, a padded member all zero; the top-k select against
``np.argsort(kind="stable")`` and JAX; the rank's picks against JAX's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simple_tip_tpu.models import MnistConvNet as FlaxMnistConvNet
from simple_tip_tpu.ops import coverage as jax_cov
from simple_tip_tpu.ops import fused_chain as jax_fc
from simple_tip_tpu.ops.prioritizers import pack_profiles as jax_pack_profiles
from simple_tip_tpu_torch.bridge import params_from_jax
from simple_tip_tpu_torch.models import MnistConvNet
from simple_tip_tpu_torch.ops import coverage as cov
from simple_tip_tpu_torch.ops import fused_chain as fc
from simple_tip_tpu_torch.ops.prioritizers import pack_profiles
from simple_tip_tpu_torch.ops.uncertainty import POINT_PRED_QUANTIFIERS
from test_torch_model import flax_params
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

LAYERS = (0, 1, 2, 3)
UNCERTAINTY_ATOL = 1e-5


def _stats(flat: np.ndarray):
    return [flat.min(axis=0)], [flat.max(axis=0)], [flat.std(axis=0)]


def _metric_pair(mins, maxs, stds):
    """The same coverage configuration in both packages, from numpy
    statistics: ``(port metrics, JAX metrics)``."""

    def build(m, t):
        lo, hi, sd = [t(a) for a in mins], [t(a) for a in maxs], [t(a) for a in stds]
        return {
            "NAC_0": m.NAC(cov_threshold=0.0),
            "NAC_0.75": m.NAC(cov_threshold=0.75),
            "NBC_0": m.NBC(mins=lo, maxs=hi, stds=sd, scaler=0.0),
            "NBC_0.5": m.NBC(mins=lo, maxs=hi, stds=sd, scaler=0.5),
            "SNAC_1": m.SNAC(maxs=hi, stds=sd, scaler=1.0),
            "KMNC_2": m.KMNC(lo, hi, sections=2),
            "TKNC_2": m.TKNC(top_neurons=2),
        }

    return build(cov, torch.from_numpy), build(jax_cov, np.asarray)


@pytest.fixture(scope="module")
def setup():
    """Flax weights and their bridge, seeded inputs, both packages' metrics
    from the port's training taps, and the JAX model."""
    rng = np.random.default_rng(0)
    x_train = rng.random((40, 28, 28, 1), dtype=np.float32)
    x_test = rng.random((24, 28, 28, 1), dtype=np.float32)
    tree = flax_params(3)
    params = params_from_jax(tree)
    net = _net(params)
    with torch.no_grad():
        _, taps = net(torch.from_numpy(x_train))
    flat = cov.flatten_layers([taps[i] for i in LAYERS]).numpy()
    metrics, jax_metrics = _metric_pair(*_stats(flat))
    return dict(tree=tree, params=params, net=net, x_test=x_test, metrics=metrics,
                jax_metrics=jax_metrics, model=FlaxMnistConvNet())


def _net(params) -> MnistConvNet:
    net = MnistConvNet().eval()
    net.load_state_dict(params["module"])
    return net


def _run_chain(chain, params, x, valid):
    with torch.no_grad():
        return chain(_net(params), torch.from_numpy(x), torch.tensor(valid, dtype=torch.int32))


def _u32(words: torch.Tensor) -> np.ndarray:
    return words.numpy().view(np.uint32)


def test_pack_bits_u32_bytes_equal_jax():
    rng = np.random.default_rng(1)
    packer = jax.jit(jax_fc.pack_bits_u32)
    for width in (1, 31, 32, 33, 100, 257):
        flat = rng.random((7, width)) > 0.5
        got = fc.pack_bits_u32(torch.from_numpy(flat))
        assert got.dtype == torch.int32 and got.shape == (7, -(-width // 32))
        want = np.asarray(packer(jnp.asarray(flat)))
        assert want.dtype == np.uint32
        np.testing.assert_array_equal(_u32(got), want)
        np.testing.assert_array_equal(got.numpy(), pack_profiles(torch.from_numpy(flat)).numpy())
        np.testing.assert_array_equal(want, jax_pack_profiles(flat))


def test_int8_codebook_exact_on_nan_and_ties():
    """The coding gives the plain metrics' bits and scores, and the JAX
    codebook's, on NaN, exact-threshold ties and infinities."""
    mins = [np.array([-1.0, 0.0, 0.5, -2.0, 0.0, 1.0], np.float32)]
    maxs = [np.array([1.0, 2.0, 0.5, 3.0, 0.0, 4.0], np.float32)]
    stds = [np.array([0.5, 1.0, 0.0, 0.25, 0.0, 2.0], np.float32)]
    metrics, jax_metrics = _metric_pair(mins, maxs, stds)
    del metrics["TKNC_2"], jax_metrics["TKNC_2"]
    codebook = fc.ThresholdCodebook(metrics)
    assert all(codebook.covers(m) for m in metrics)

    acts = np.random.default_rng(9).uniform(-3, 5, size=(32, 6)).astype(np.float32)
    acts[0] = mins[0]
    acts[1] = maxs[0]
    acts[2, :3] = np.nan
    acts[3, 0] = np.inf
    acts[3, 1] = -np.inf
    acts[4] = 0.0
    coded = codebook.apply(torch.from_numpy(acts))
    jax_codebook = jax_fc.ThresholdCodebook(jax_metrics)
    jax_coded = jax.jit(jax_codebook.apply)(jnp.asarray(acts))  # tiplint: disable=retrace-risk (one-shot per-test compile)
    for mid, metric in metrics.items():
        s_ref, p_ref = metric([torch.from_numpy(acts)])
        s, p = coded[mid]
        assert p.shape == p_ref.shape and s.dtype == s_ref.dtype
        np.testing.assert_array_equal(p.numpy(), p_ref.numpy(), err_msg=mid)
        np.testing.assert_array_equal(s.numpy(), s_ref.numpy(), err_msg=mid)
        np.testing.assert_array_equal(p.numpy(), np.asarray(jax_coded[mid][1]), err_msg=mid)
        np.testing.assert_array_equal(s.numpy(), np.asarray(jax_coded[mid][0]), err_msg=mid)


def test_int8_codebook_tables_equal_jax(setup):
    cb = fc.ThresholdCodebook(setup["metrics"])
    jax_cb = jax_fc.ThresholdCodebook(setup["jax_metrics"])
    assert cb.spec_signature() == jax_cb.spec_signature()
    n = setup["metrics"]["KMNC_2"].lo.shape[0]
    for got, want in zip(cb.table(n), jax_cb.table(n)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_int8_codebook_rejects_cut_overflow():
    mins, maxs = [np.zeros(3, np.float32)], [np.ones(3, np.float32)]
    messages = []
    for m, t in ((cov, torch.from_numpy), (jax_cov, np.asarray)):
        with pytest.raises(ValueError, match="int8") as err:
            (fc if m is cov else jax_fc).ThresholdCodebook(
                {"KMNC_200": m.KMNC([t(a) for a in mins], [t(a) for a in maxs], sections=200)}
            )
        messages.append(str(err.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("int8_profiles", [False, True])
def test_chain_matches_jax_and_per_phase_pieces(setup, int8_profiles):
    """One chain call against the JAX chain (pred, scores and packed words
    byte-equal, uncertainties within 1e-5) and against the port's own
    pieces: the module, each quantifier, each metric and the packer."""
    x = setup["x_test"]
    chain = fc.make_chain_fn(LAYERS, setup["metrics"], int8_profiles=int8_profiles)
    pred, unc, cov_out = _run_chain(chain, setup["params"], x, len(x))
    jax_chain = jax.jit(jax_fc.make_chain_fn(setup["model"], LAYERS, setup["jax_metrics"],
                                             int8_profiles=int8_profiles))
    j_pred, j_unc, j_cov = jax_chain(setup["tree"], jnp.asarray(x), np.int32(len(x)))

    np.testing.assert_array_equal(pred.numpy(), np.asarray(j_pred))
    for name in POINT_PRED_QUANTIFIERS:
        np.testing.assert_allclose(unc[name].numpy(), np.asarray(j_unc[name]), rtol=0,
                                   atol=UNCERTAINTY_ATOL, err_msg=name)
    for mid in setup["metrics"]:
        s, packed = cov_out[mid]
        assert s.dtype == torch.int16 or s.dtype == torch.int32
        np.testing.assert_array_equal(s.numpy(), np.asarray(j_cov[mid][0]), err_msg=mid)
        np.testing.assert_array_equal(_u32(packed), np.asarray(j_cov[mid][1]), err_msg=mid)

    with torch.no_grad():
        probs, taps = setup["net"](torch.from_numpy(x))
    acts = [taps[i] for i in LAYERS]
    np.testing.assert_array_equal(pred.numpy(), probs.argmax(1).numpy())
    for name, fn in POINT_PRED_QUANTIFIERS.items():
        np.testing.assert_array_equal(unc[name].numpy(), fn(probs)[1].numpy(), err_msg=name)
    for mid, metric in setup["metrics"].items():
        s_ref, p_ref = metric(acts)
        np.testing.assert_array_equal(cov_out[mid][0].numpy(), s_ref.numpy(), err_msg=mid)
        np.testing.assert_array_equal(cov_out[mid][1].numpy(), pack_profiles(p_ref).numpy(),
                                      err_msg=mid)


def test_chain_masks_padding_rows(setup):
    """Rows at index >= valid get all-zero packed words; valid rows equal
    the unpadded badge's."""
    x = setup["x_test"]
    n = len(x)
    chain = fc.make_chain_fn(LAYERS, setup["metrics"])
    padded = np.concatenate([x, np.random.default_rng(4).random((8,) + x.shape[1:],
                                                                 dtype=np.float32)])
    _, _, cov_pad = _run_chain(chain, setup["params"], padded, n)
    _, _, cov_ref = _run_chain(chain, setup["params"], x, n)
    for mid in setup["metrics"]:
        packed = cov_pad[mid][1].numpy()
        assert not packed[n:].any(), f"{mid}: padding rows have set bits"
        np.testing.assert_array_equal(packed[:n], cov_ref[mid][1].numpy())


def test_group_chain_matches_per_member(setup):
    """The group chain with each member's own cut table equals each member's
    chain with its own thresholds (plain metrics), byte for byte, and the
    JAX group chain (``member_tables=True``, vmapped over the stacked flax
    trees): pred, scores and packed words byte-equal, uncertainties within
    1e-5. With one member alive, the padding member's words are zero in
    both packages."""
    x = setup["x_test"]
    tree2 = flax_params(11)
    params2 = params_from_jax(tree2)
    net2 = _net(params2)
    x_train2 = np.random.default_rng(23).random((40, 28, 28, 1), dtype=np.float32)
    with torch.no_grad():
        _, taps2 = net2(torch.from_numpy(x_train2))
    metrics2, jax_metrics2 = _metric_pair(
        *_stats(cov.flatten_layers([taps2[i] for i in LAYERS]).numpy()))
    members = [(setup["params"], setup["metrics"]), (params2, metrics2)]
    codebooks = [fc.ThresholdCodebook(m) for _, m in members]
    assert codebooks[0].spec_signature() == codebooks[1].spec_signature()
    n_neurons = setup["metrics"]["KMNC_2"].lo.shape[0]
    tables = tuple(torch.from_numpy(np.stack([cb.table(n_neurons)[i] for cb in codebooks]))
                   for i in range(3))
    group = fc.make_group_chain_fn(LAYERS, setup["metrics"])
    xb, valid = torch.from_numpy(x), torch.tensor(len(x), dtype=torch.int32)
    nets = [_net(p) for p, _ in members]
    with torch.no_grad():
        g_pred, g_unc, g_cov = group(nets, tables, xb, valid, torch.tensor(2))
        r_pred, r_unc, r_cov = group(nets, tables, xb, valid, torch.tensor(1))
    for g, (p, m) in enumerate(members):
        pred, unc, cov_out = _run_chain(fc.make_chain_fn(LAYERS, m), p, x, len(x))
        np.testing.assert_array_equal(g_pred[g].numpy(), pred.numpy())
        for name in unc:
            np.testing.assert_array_equal(g_unc[name][g].numpy(), unc[name].numpy())
        for mid in m:
            np.testing.assert_array_equal(g_cov[mid][0][g].numpy(), cov_out[mid][0].numpy())
            np.testing.assert_array_equal(g_cov[mid][1][g].numpy(), cov_out[mid][1].numpy())
    np.testing.assert_array_equal(r_pred.numpy(), g_pred.numpy())
    for mid in setup["metrics"]:
        assert not r_cov[mid][1][1].any(), f"{mid}: padding member has set bits"
        np.testing.assert_array_equal(r_cov[mid][1][0].numpy(), g_cov[mid][1][0].numpy())

    jax_tables = tuple(
        jnp.asarray(np.stack([jax_fc.ThresholdCodebook(m).table(n_neurons)[i]
                              for m in (setup["jax_metrics"], jax_metrics2)]))
        for i in range(3))
    stacked = jax.tree_util.tree_map(lambda a, b: jnp.stack([a, b]), setup["tree"], tree2)
    jax_group = jax.jit(jax_fc.make_group_chain_fn(setup["model"], LAYERS, setup["jax_metrics"],
                                                   member_tables=True))
    for alive, (pred, unc, cov_out) in ((2, (g_pred, g_unc, g_cov)), (1, (r_pred, r_unc, r_cov))):
        j_pred, j_unc, j_cov = jax_group(stacked, jax_tables, jnp.asarray(x), np.int32(len(x)),
                                         np.int32(alive))
        np.testing.assert_array_equal(pred.numpy(), np.asarray(j_pred))
        for name in unc:
            np.testing.assert_allclose(unc[name].numpy(), np.asarray(j_unc[name]), rtol=0,
                                       atol=UNCERTAINTY_ATOL, err_msg=name)
        for mid in setup["metrics"]:
            np.testing.assert_array_equal(cov_out[mid][0].numpy(), np.asarray(j_cov[mid][0]),
                                          err_msg=f"{alive} alive: {mid}")
            np.testing.assert_array_equal(_u32(cov_out[mid][1]), np.asarray(j_cov[mid][1]),
                                          err_msg=f"{alive} alive: {mid}")


def test_select_top_k_matches_numpy_stable_argsort_and_jax():
    rng = np.random.default_rng(13)
    for n, valid, k in ((16, 16, 5), (16, 12, 5), (32, 9, 5), (40, 40, 7)):
        vals = rng.random(n).astype(np.float32)
        vals[: valid // 2] = vals[valid // 2 : 2 * (valid // 2)]  # ties
        got = fc.make_select_fn(k)(torch.from_numpy(vals), torch.tensor(valid)).numpy()
        np.testing.assert_array_equal(got, np.argsort(vals[:valid], kind="stable")[-k:])
        want = jax_fc.select_top_k(jnp.asarray(vals), np.int32(valid), k)
        np.testing.assert_array_equal(got, np.asarray(want))
        assert (got < valid).all()


def test_group_select_matches_per_member_select():
    vals = np.random.default_rng(21).random((3, 20)).astype(np.float32)
    vals[:, 3] = vals[:, 7]
    got = fc.make_group_select_fn(4)(torch.from_numpy(vals), torch.tensor(17)).numpy()
    for g in range(3):
        want = fc.select_top_k(torch.from_numpy(vals[g]), torch.tensor(17), 4).numpy()
        np.testing.assert_array_equal(got[g], want)
        assert (got[g] < 17).all()


def test_rank_badges_matches_jax():
    """Concatenated badges' greedy picks equal the JAX rank's, flat and
    grouped."""
    flat = np.random.default_rng(5).random((40, 70)) > 0.6
    words = pack_profiles(torch.from_numpy(flat))
    badges = (words[:20], words[20:])
    picked = fc.rank_badges(badges).numpy()
    j_picked, j_count = jax_fc.rank_badges(
        (jnp.asarray(_u32(words[:20])), jnp.asarray(_u32(words[20:])))
    )
    np.testing.assert_array_equal(picked, np.asarray(j_picked)[: int(j_count)])
    grouped = fc.rank_badges_grouped((torch.stack([badges[0]] * 2), torch.stack([badges[1]] * 2)))
    assert len(grouped) == 2
    for g in grouped:
        np.testing.assert_array_equal(g.numpy(), picked)
