"""Port parity for kernels B5 and B6, the flash-attention backward, and for
the differentiable entry point ``FlashAttention``.

On the CPU every wrapper runs its plain PyTorch version. B5's and B6's
plain versions are held against the JAX package's Pallas backward in
interpret mode (``jax.vjp`` of ``flash_attention(..., interpret=True)``,
whose custom VJP runs ``_flash_bwd_call``) with the same seeded q, k, v and
dO, rtol 1e-4 and atol 1e-5 (both sum the same float32 terms in other
orders). ``FlashAttention``'s gradients are held against JAX's flash core
and its dense core (``ring_self_attention_reference``) at rtol 2e-4 and
atol 2e-5, the JAX package's own bound between its cores. The IMDB case
takes the gradient of the module's loss with respect to the q/k/v
projections through the Function and compares it with ``jax.grad`` of the
JAX model. The CUDA kernels are held against the plain versions on the
card in ``test_torch_kernels_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_tip_tpu.models import ImdbTransformer as FlaxImdbTransformer
from simple_tip_tpu.models.train import categorical_crossentropy as jax_cce
from simple_tip_tpu.ops.flash_attention import flash_attention as pallas_flash_attention
from simple_tip_tpu.parallel.ring_attention import ring_self_attention_reference
from simple_tip_tpu_torch.bridge import params_from_jax, params_to_jax
from simple_tip_tpu_torch.models import ImdbTransformer
from simple_tip_tpu_torch.models.train import categorical_crossentropy
from simple_tip_tpu_torch.ops import flash_attention as fa
from test_torch_transformer import imdb_flax_params, tokens
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SHAPES = [
    ((2, 37, 2, 8), 37),  # ragged: shorter than one tile
    ((2, 100, 2, 32), 100),  # the IMDB sequence length, heads and head dim
    ((1, 40, 2, 8), 200),  # Tq < Tkv, several key tiles
    ((1, 150, 1, 4), 70),  # Tq > Tkv, several query tiles
]


def _inputs(shape, t_kv: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    b, t, h, dh = shape
    return [
        rng.normal(size=s).astype(np.float32)
        for s in ((b, t, h, dh), (b, t_kv, h, dh), (b, t_kv, h, dh), (b, t, h, dh))
    ]


def _jax_vjp(core, q, k, v, dout):
    _, vjp = jax.vjp(core, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(dout))]


def _pallas(q, k, v):
    return pallas_flash_attention(q, k, v, interpret=True)


@pytest.mark.parametrize("shape,t_kv", SHAPES, ids=lambda s: str(s))
def test_plain_backward_matches_pallas_interpret(shape, t_kv):
    q, k, v, dout = _inputs(shape, t_kv)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    out, lse = fa.flash_attention_fwd(tq, tk, tv)
    dvec = fa.attention_delta(out, tdo)
    before = (fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES)
    dq = fa.flash_bwd_dq(tq, tk, tv, tdo, lse, dvec)
    dk, dv = fa.flash_bwd_dkv(tq, tk, tv, tdo, lse, dvec)
    assert (fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES) == before, "CPU tensors launch nothing"
    want = _jax_vjp(_pallas, q, k, v, dout)
    for got, w in zip((dq, dk, dv), want):
        assert got.shape == w.shape
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-4, atol=1e-5)
    whole = fa.flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo)
    for got, w in zip(whole, (dq, dk, dv)):
        torch.testing.assert_close(got, w, rtol=0, atol=0)


@pytest.mark.parametrize("core", ["flash", "dense"])
@pytest.mark.parametrize("shape,t_kv", SHAPES[:3], ids=lambda s: str(s))
def test_function_gradients_match_both_jax_cores(shape, t_kv, core):
    q, k, v, dout = _inputs(shape, t_kv, seed=1)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    want = _jax_vjp(_pallas if core == "flash" else ring_self_attention_reference, q, k, v, dout)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-4, atol=2e-5)


def test_backward_runs_the_kernel_wrappers_not_the_plain_forward(monkeypatch):
    calls = []
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        real = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, _real=real, _n=name: calls.append(_n) or _real(*a))
    q, k, v, dout = (torch.from_numpy(x) for x in _inputs((1, 20, 1, 4), 20, seed=2))
    q.requires_grad_()
    out = fa.flash_attention(q, k, v)
    assert out.grad_fn.next_functions[0][0] is not None  # a graph node, not the plain loop
    torch.autograd.grad(out, q, dout)
    assert calls == ["flash_bwd_dq", "flash_bwd_dkv"]


def test_imdb_qkv_gradients_go_through_the_function_and_match_jax():
    maxlen = 32
    x = tokens(6, 3)[:, :maxlen]
    labels = np.random.default_rng(3).integers(0, 2, size=6)
    y = np.eye(2, dtype=np.float32)[labels]
    params = imdb_flax_params(2)
    params["TokenAndPositionEmbedding_0"]["Embed_1"]["embedding"] = params[
        "TokenAndPositionEmbedding_0"]["Embed_1"]["embedding"][:maxlen]
    flax_model = FlaxImdbTransformer(maxlen=maxlen)

    def loss_fn(p):
        probs, _ = flax_model.apply({"params": p}, jnp.asarray(x))
        return jnp.mean(jax_cce(probs, jnp.asarray(y)))

    want = jax.grad(loss_fn)(params)
    net = ImdbTransformer(maxlen=maxlen)
    net.load_state_dict(params_from_jax(params)["module"])
    probs, _ = net(torch.as_tensor(x, dtype=torch.int64))
    loss = categorical_crossentropy(probs, torch.from_numpy(y)).mean()
    named = dict(net.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    got = params_to_jax("imdb", dict(zip(named, grads)))
    got_attn = got["TransformerBlock_0"]["MultiHeadDotProductAttention_0"]
    want_attn = want["TransformerBlock_0"]["MultiHeadDotProductAttention_0"]
    for name in ("query", "key", "value"):
        g, w = got_attn[name]["kernel"], np.asarray(want_attn[name]["kernel"])
        assert np.abs(g).max() > 0, f"{name} kernel gradient vanishes"
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(got_attn[name]["bias"], np.asarray(want_attn[name]["bias"]),
                                   rtol=2e-4, atol=2e-5)
