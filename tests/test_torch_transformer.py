"""Port parity for the IMDB transformer and its bridge.

The same seeded token ids and the same flax parameters go through the JAX
package's ``ImdbTransformer`` and the port's on the CPU. The port has one
attention core (kernel B4's plain version here); the JAX model is run with
its default dense core and with its flash core (Pallas, interpret mode), and
probabilities and taps 1-7 agree with both at rtol 2e-4 and atol 2e-5, the
JAX package's own bound between its two cores. The MC-dropout split
(deterministic prefix once, stochastic rest per sample) is held against a
full stochastic forward fed the same masks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from simple_tip_tpu.models import ImdbTransformer as FlaxImdbTransformer
from simple_tip_tpu.models.train import init_params
from simple_tip_tpu_torch.bridge import params_from_jax
from simple_tip_tpu_torch.engine.model_handler import DROPOUT_SAMPLE_SIZE, BaseModel
from simple_tip_tpu_torch.models import ImdbTransformer
from simple_tip_tpu_torch.models.predict import mc_dropout_votes, predict, to_device
from simple_tip_tpu_torch.models.transformer import FlaxLayerNorm
from simple_tip_tpu_torch.ops import flash_attention as fa
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

DENSE, FLASH = "MultiHeadDotProductAttention_0", "SequenceParallelSelfAttention_0"


def imdb_flax_params(seed: int = 0, impl: str = "dense"):
    """Flax ``ImdbTransformer`` params as numpy (attention subtree named as
    ``impl`` names it), with non-zero biases and layer-norm offsets."""
    tokens = np.zeros((1, 100), np.int32)
    params = jax.tree_util.tree_map(
        np.asarray,
        init_params(FlaxImdbTransformer(attention_impl=impl), jax.random.PRNGKey(seed), tokens),
    )
    rng = np.random.default_rng(seed)

    def perturb(tree):
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                perturb(leaf)
            elif name in ("bias", "scale"):
                tree[name] = (leaf + rng.uniform(-0.05, 0.05, leaf.shape)).astype(np.float32)

    perturb(params)
    return params


def renamed(params, name: str):
    """The same tree with its attention subtree under ``name``."""
    block = dict(params["TransformerBlock_0"])
    attn = block.pop(DENSE, None) or block.pop(FLASH)
    return {**params, "TransformerBlock_0": {**block, name: attn}}


def tokens(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2000, size=(n, 100)).astype(np.int32)


def port_net(params) -> ImdbTransformer:
    net = ImdbTransformer().eval()
    net.load_state_dict(params_from_jax(params)["module"])
    return net


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_probs_and_taps_match_both_jax_cores(impl):
    params = imdb_flax_params(1)
    x = tokens(6, 1)
    jax_params = params if impl == "dense" else renamed(params, FLASH)
    want_probs, want_taps = FlaxImdbTransformer(attention_impl=impl).apply(
        {"params": jax_params}, jnp.asarray(x)
    )
    before = fa.LAUNCHES
    with torch.no_grad():
        probs, taps = port_net(params)(to_device(x, torch.device("cpu")))
    assert fa.LAUNCHES == before
    np.testing.assert_allclose(probs.numpy(), np.asarray(want_probs), rtol=2e-4, atol=2e-5)
    assert sorted(taps) == list(range(1, 8))
    for i in range(1, 8):
        assert tuple(taps[i].shape) == want_taps[i].shape, i
        np.testing.assert_allclose(
            taps[i].numpy(), np.asarray(want_taps[i]), rtol=2e-4, atol=2e-5, err_msg=f"tap {i}"
        )


def test_bridge_takes_either_attention_subtree():
    params = imdb_flax_params(2)
    dense = params_from_jax(params)
    flash = params_from_jax(renamed(params, FLASH))
    assert dense["fused"] == {} and sorted(dense["module"]) == sorted(flash["module"])
    for name, value in dense["module"].items():
        assert torch.equal(value, flash["module"][name]), name
    assert sorted(dense["module"]) == sorted(ImdbTransformer().state_dict())
    q = params["TransformerBlock_0"][DENSE]["query"]["kernel"]  # [32, 2, 32]
    assert dense["module"]["block.attention.query.weight"][32 + 5, 7].item() == q[7, 1, 5]
    out = params["TransformerBlock_0"][DENSE]["out"]["kernel"]  # [2, 32, 32]
    assert dense["module"]["block.attention.out.weight"][3, 32 + 5].item() == out[1, 5, 3]
    broken = renamed(params, "Attention_0")
    with pytest.raises(ValueError):
        params_from_jax(broken)


def test_vote_split_is_the_full_stochastic_forward():
    net = port_net(imdb_flax_params(3))
    x = to_device(tokens(5, 3), torch.device("cpu"))
    with torch.no_grad():
        full = net(x, train=True, generator=torch.Generator().manual_seed(11))[0]
        split = net.vote_probs(net.vote_prefix(x), torch.Generator().manual_seed(11))
        deterministic = net(x)[0]
    torch.testing.assert_close(split, full, rtol=0, atol=0)
    assert not torch.equal(full, deterministic)
    with pytest.raises(ValueError):
        net(x, train=True)


def test_votes_equal_full_stochastic_forwards_with_the_same_masks():
    net = port_net(imdb_flax_params(4))
    x = tokens(7, 4)
    votes = mc_dropout_votes(
        net, x, n_samples=6, generator=torch.Generator().manual_seed(5),
        batch_size=16, device=torch.device("cpu"),
    )
    gen = torch.Generator().manual_seed(5)
    want = torch.zeros(7, 2, dtype=torch.int64)
    with torch.no_grad():
        for _ in range(6):
            probs = net(to_device(x, torch.device("cpu")), train=True, generator=gen)[0]
            want[torch.arange(7), probs.argmax(1)] += 1
    torch.testing.assert_close(votes, want)


def test_token_ids_stay_integers_and_predict_runs_the_module():
    x = tokens(4, 5)
    t = to_device(x, torch.device("cpu"))
    assert t.dtype == torch.int64 and torch.equal(t, torch.from_numpy(x.astype(np.int64)))
    assert to_device(x.astype(np.float64), torch.device("cpu")).dtype == torch.float32
    params = imdb_flax_params(5)
    got = predict(port_net(params), {}, x, torch.device("cpu"))
    want, _ = FlaxImdbTransformer().apply({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


def test_layer_norm_follows_flax_epsilon():
    x = np.random.default_rng(6).normal(0.3, 1.0, size=(4, 9, 32)).astype(np.float32)
    # rows whose variance is near epsilon: 1e-6 (flax) and 1e-5 (torch's
    # default) would give visibly different outputs there
    x[0] = np.random.default_rng(9).normal(0.0, 1e-3, size=(9, 32))
    scale = np.random.default_rng(7).uniform(0.5, 1.5, 32).astype(np.float32)
    bias = np.random.default_rng(8).uniform(-0.1, 0.1, 32).astype(np.float32)
    want = nn.LayerNorm(epsilon=1e-6).apply({"params": {"scale": scale, "bias": bias}}, x)
    norm = FlaxLayerNorm(32)
    norm.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        got = norm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_imdb_vr_range_and_records():
    model = BaseModel(ImdbTransformer(), params_from_jax(imdb_flax_params(0)), device="cpu")
    pred, unc, times = model.get_pred_and_uncertainty(tokens(12, 9), seed=0)
    assert set(unc) == {"softmax", "pcs", "softmax_entropy", "deep_gini", "VR"}
    vr = unc["VR"]
    # two classes: VR = 1 - majority/200 lies in [0, 0.5]
    assert vr.dtype == np.float64 and vr.shape == (12,) and vr.min() >= 0 and vr.max() <= 0.5
    assert np.allclose(vr * DROPOUT_SAMPLE_SIZE, np.round(vr * DROPOUT_SAMPLE_SIZE))
    assert pred.dtype == np.int64 and set(pred.tolist()) <= {0, 1}
    assert len(times["VR"]) == 4
