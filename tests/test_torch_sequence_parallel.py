"""Port parity for sequence-parallel attention (ring and ulysses).

The same numpy-seeded inputs go through the JAX package on the 8 virtual
CPU devices of ``conftest.py`` (``ring_attention_sharded`` /
``ulysses_attention_sharded``, and ``ImdbTransformer(attention_impl=...,
sp_mesh=...)``) and through the port on spawned gloo ranks: one group of 8
ranks for the module, every case run inside it (``torch_rank_cases.py``,
subgroups for 2 and 4 ranks), over a ``FileStore`` under ``tmp_path``.
Outputs and gradients agree within rtol 2e-4 / atol 2e-5, the JAX
package's own bound (``tests/test_ring_attention.py``), on every rank; the
IMDB model's gradients under the sequence-parallel core equal the one-rank
flash model's (not n times them); the guards raise ``ValueError`` with the
JAX package's messages.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_rank_cases
from simple_tip_tpu.models import ImdbTransformer as FlaxImdbTransformer
from simple_tip_tpu.models.train import init_params
from simple_tip_tpu.parallel import ring_attention as jax_ring
from simple_tip_tpu.parallel import ulysses_attention as jax_ulysses
from simple_tip_tpu_torch.bridge import params_from_jax
from simple_tip_tpu_torch.parallel import ring_attention, ulysses_attention
from simple_tip_tpu_torch.parallel.distributed import run_ranks
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 2e-4, 2e-5
RING_SHAPE = (2, 64, 4, 16)
ULYSSES_SHAPE = (2, 64, 8, 16)
GRAD_SHAPE = (1, 32, 4, 8)
GRAD_CASES = (("ring", 2, None), ("ring", 4, None), ("ring", 8, None),
              ("ulysses", 2, "auto"), ("ulysses", 4, "auto"), ("ulysses", 4, "flash"))
IMDB_MAXLEN, IMDB_ROWS = 64, 4


def _normal(seed, shape, count):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(count)]


def _imdb_params():
    x = np.zeros((1, IMDB_MAXLEN), np.int32)
    params = jax.tree_util.tree_map(np.asarray, init_params(
        FlaxImdbTransformer(maxlen=IMDB_MAXLEN, attention_impl="ring"), jax.random.PRNGKey(0), x))
    rng = np.random.default_rng(1)

    def perturb(tree):  # non-zero biases and layer-norm offsets
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                perturb(leaf)
            elif name in ("bias", "scale"):
                tree[name] = (leaf + rng.uniform(-0.05, 0.05, leaf.shape)).astype(np.float32)

    perturb(params)
    return params


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2000, size=(IMDB_ROWS, IMDB_MAXLEN)).astype(np.int64)
    y = rng.integers(0, 2, size=IMDB_ROWS).astype(np.int64)
    params = _imdb_params()
    state = params_from_jax(params)["module"]
    return {
        "ring": _normal(0, RING_SHAPE, 3),
        "ulysses": _normal(0, ULYSSES_SHAPE, 3),
        "grad": _normal(4, GRAD_SHAPE, 3),
        "grad_w": _normal(5, GRAD_SHAPE, 1)[0],
        "grad_cases": GRAD_CASES,
        "imdb": (state, x, y),
        "imdb_params": params,
        "uneven": _normal(0, (2, 100, 2, 16), 3),
    }


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Each rank's results (``torch_rank_cases.run_cases``), in rank order."""
    store = tmp_path_factory.mktemp("sp_store") / "store"
    sent = {k: v for k, v in inputs.items() if k != "imdb_params"}
    return run_ranks(torch_rank_cases.run_cases, torch_rank_cases.WORLD, f"file://{store}",
                     args=(sent,), timeout_s=300)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


@pytest.mark.parametrize("n", torch_rank_cases.RING_SIZES)
def test_ring_matches_jax(ranks, inputs, n):
    want = np.asarray(jax_ring.ring_attention_sharded(*inputs["ring"],
                                                      jax_ring.sequence_parallel_mesh(n)))
    for rank in range(n):
        _close(ranks[rank]["ring", n], want, f"ring n={n} rank {rank}")


@pytest.mark.parametrize("n", torch_rank_cases.ULYSSES_SIZES)
@pytest.mark.parametrize("core", ["auto", "flash"])
def test_ulysses_matches_jax(ranks, inputs, n, core):
    """The dense local core (``auto`` on the CPU) and the flash core's plain
    versions against the JAX package's ulysses."""
    want = np.asarray(jax_ulysses.ulysses_attention_sharded(
        *inputs["ulysses"], jax_ring.sequence_parallel_mesh(n)))
    for rank in range(n):
        _close(ranks[rank]["ulysses", n, core], want, f"ulysses n={n} {core} rank {rank}")


def test_ring_core_matches_jax_ring_core(ranks, inputs):
    """The port's ring on its own (``RingAttention`` over each rank's block)
    against JAX's ``ring_attention`` in ``shard_map``: the gathered output
    of ``ring_attention_sharded`` is exactly the blocks in rank order."""
    mesh = jax_ring.sequence_parallel_mesh(4)
    spec = P(None, "sp", None, None)
    fn = jax.shard_map(functools.partial(jax_ring.ring_attention, axis_name="sp", n_dev=4),
                       mesh=mesh, in_specs=(spec,) * 3, out_specs=spec)
    args = [jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec)) for a in inputs["ring"]]
    _close(ranks[0]["ring", 4], np.asarray(fn(*args)), "ring core n=4")


@pytest.mark.parametrize("impl, n, core", GRAD_CASES)
def test_gradients_match_jax_dense(ranks, inputs, impl, n, core):
    q, k, v = (jnp.asarray(a) for a in inputs["grad"])
    w = jnp.asarray(inputs["grad_w"])
    want = jax.grad(lambda q, k, v: jnp.sum(jax_ring.ring_self_attention_reference(q, k, v) * w),
                    argnums=(0, 1, 2))(q, k, v)
    for rank in range(n):
        for name, got, oracle in zip("qkv", ranks[rank]["grad", impl, n, core], want):
            _close(got, oracle, f"{impl} n={n} {core} rank {rank}: d{name}")


@pytest.mark.parametrize("impl, n", [("ring", 4), ("ulysses", 2)])
def test_imdb_model_matches_jax(ranks, inputs, impl, n):
    """The IMDB model on bridged weights (``SequenceParallelSelfAttention_0``
    maps onto the port's attention): probabilities and taps 1-7 against the
    JAX model over a mesh of the same size."""
    _, x, _ = inputs["imdb"]
    model = FlaxImdbTransformer(maxlen=IMDB_MAXLEN, attention_impl=impl,
                                sp_mesh=jax_ring.sequence_parallel_mesh(n))
    want_probs, want_taps = model.apply({"params": inputs["imdb_params"]},
                                        jnp.asarray(x.astype(np.int32)))
    for rank in range(n):
        probs, taps, _ = ranks[rank]["imdb", impl]
        _close(probs, want_probs, f"{impl} rank {rank} probs")
        for i, tap in taps.items():
            _close(tap, want_taps[i], f"{impl} rank {rank} tap {i}")


@pytest.mark.parametrize("impl, n", [("ring", 4), ("ulysses", 2)])
def test_imdb_gradients_are_the_one_rank_gradients(ranks, impl, n):
    """Every rank holds the full gradients of the loss that each computes
    alike: the one-rank flash model's, not n times them."""
    _, _, want = ranks[0]["imdb", "flash"]
    for rank in range(n):
        _, _, got = ranks[rank]["imdb", impl]
        assert sorted(got) == sorted(want)
        for name in want:
            _close(got[name], want[name], f"{impl} rank {rank}: d {name}")


def _jax_raises(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_guards_raise_as_jax(ranks, inputs):
    """flash with a group, ulysses with heads not divisible by the ranks and
    an uneven sequence raise ValueError in the port's ranks, as the JAX
    package does for the same shapes and meshes."""
    guards = ranks[0]["guards"]
    x = np.zeros((1, IMDB_MAXLEN), np.int32)
    key = jax.random.PRNGKey(0)
    assert "single-device core" in _jax_raises(lambda: init_params(
        FlaxImdbTransformer(attention_impl="flash", sp_mesh=jax_ring.sequence_parallel_mesh(2)),
        key, np.zeros((1, 100), np.int32)))
    assert "single-device core" in guards["flash_with_group"]
    assert guards["ulysses_heads"] == _jax_raises(lambda: init_params(
        FlaxImdbTransformer(maxlen=IMDB_MAXLEN, attention_impl="ulysses",
                            sp_mesh=jax_ring.sequence_parallel_mesh(4)), key, x))
    mesh8 = jax_ring.sequence_parallel_mesh(8)
    assert guards["ring_uneven_core"] == _jax_raises(
        lambda: jax_ring.ring_attention_sharded(*inputs["uneven"], mesh8))
    assert guards["ring_uneven_model"] == _jax_raises(lambda: init_params(
        FlaxImdbTransformer(maxlen=100, attention_impl="ring", sp_mesh=mesh8), key,
        np.zeros((1, 100), np.int32)))


@pytest.mark.parametrize("seq_len, heads, n", [(100, 8, 8), (64, 2, 4), (64, 8, 4), (30, 3, 3)])
def test_divisibility_checks_equal_jax(seq_len, heads, n):
    def outcome(check):
        try:
            check()
        except ValueError as e:
            return str(e)
        return None

    assert outcome(lambda: ulysses_attention.check_ulysses_divisibility(seq_len, heads, n)) == \
        outcome(lambda: jax_ulysses.check_ulysses_divisibility(seq_len, heads, n))
    assert outcome(lambda: ring_attention.check_ring_divisibility(seq_len, n)) == \
        outcome(lambda: jax_ring.check_ring_divisibility(seq_len, n))


def test_dense_oracle_matches_jax():
    q, k, v = _normal(2, (2, 24, 3, 8), 3)
    got = ring_attention.dense_attention_f32_softmax(*(torch.from_numpy(a) for a in (q, k, v)))
    want = jax_ring.dense_attention_f32_softmax(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _close(got.numpy(), want, "dense oracle")
