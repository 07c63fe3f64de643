"""The pieces of the bf16 kernels' Hopper redesign that the CPU can check.

- B4 in bf16 (``ops.flash_attention``) has two routes, and which one runs is
  a pure function of (Tq, Tkv, head_dim), ``bf16_route``: the one-tile
  route where the TPU kernel folds every key in one tile of 128 (its
  ``_block_for``, which ``jax_kv_block`` copies), Tq is at most 128 too and
  the head dim is 16, 32 or 64; the two-pass route otherwise. Checked
  across the edges of both and of the TPU kernel's tile (Tkv 1, 100, 128,
  129, 256, 257, 1024, 1025), and the wrapper's constants against the
  kernel's source.
- B1 in bf16 forms each conv1 product with one ``mul.rn.bf16x2``, the
  product of two bfloat16 values rounded once to bfloat16, where the plain
  version (and the TPU kernel) rounds the float32 product. The two agree
  because the float32 product of two bfloat16 values is exact wherever it
  is a normal float32 (8 + 8 significand bits fit in 24): a hypothesis
  test over bfloat16 bit patterns. Below 2**-126 (float32 subnormals) the
  float32 product can round, and the identity stops holding there.
- ``fused_forward._bf16_products`` (the conv1 product alone, the card's
  instruction on a card) is on the CPU the plain version's rounding of the
  float32 product, equal to the correctly rounded product on normal ones.

The plain versions themselves are held to the Pallas kernels in
``tests/test_torch_bf16_scoring.py``; the kernels to the plain versions on
the card in ``tests/test_torch_kernels_cuda.py``.
"""

import pathlib
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from simple_tip_tpu.ops.flash_attention import _block_for
from simple_tip_tpu_torch.ops import flash_attention as fa
from simple_tip_tpu_torch.ops import fused_forward as ff
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

EDGES = (1, 100, 128, 129, 256, 257, 1024, 1025)
FLASH_BF16_CU = (pathlib.Path(fa.__file__).resolve().parent.parent / "csrc"
                 / "flash_attention_fwd_bf16.cu")
SMALLEST_NORMAL = 2.0 ** -126
BF16_MAX = (2.0 - 2.0 ** -7) * 2.0 ** 127  # below float32's largest, so no overflow either
# Positive finite bfloat16 bit patterns: 0x0001 .. 0x7F7F (0x7F80 is inf).
BF16_BITS = st.integers(min_value=0x0001, max_value=0x7F7F)


def _bf16(bits: int, negative: bool = False) -> float:
    """The float value of a bfloat16 bit pattern (sign bit from ``negative``)."""
    word = np.array([(bits | (0x8000 if negative else 0)) << 16], dtype=np.uint32)
    return float(word.view(np.float32)[0])


def _round_bf16(x: float) -> float:
    """``x`` (a float64) correctly rounded to bfloat16, to nearest even, with
    bfloat16's subnormals (spacing 2**-133 below 2**-126)."""
    if x == 0.0:
        return x
    exponent = max(np.frexp(abs(x))[1] - 1, -126)
    ulp = 2.0 ** (exponent - 7)
    return float(np.rint(x / ulp) * ulp)


@pytest.mark.parametrize("t_kv", EDGES)
def test_jax_kv_block_is_the_tpu_kernels_tile(t_kv):
    assert fa.jax_kv_block(t_kv) == _block_for(t_kv)


@pytest.mark.parametrize("t_kv", EDGES)
@pytest.mark.parametrize("t_q", [1, 100, 1100])
@pytest.mark.parametrize("dh", [16, 32, 48, 64, 128])
def test_bf16_route_follows_the_tpu_tile_and_the_head_dim(t_q, t_kv, dh):
    route = fa.bf16_route(t_q, t_kv, dh)
    # the one-tile route: Tkv in the TPU kernel's first tile (1, 100, 128 of
    # the edges), Tq up to 128 (1, 100), head dims 16, 32, 64
    want = "tile" if t_kv in (1, 100, 128) and t_q != 1100 and dh in (16, 32, 64) else "two_pass"
    assert route == want
    assert route == fa.bf16_route(t_q, t_kv, dh)  # a function of the shapes alone


def test_bf16_route_at_the_port_shapes():
    # IMDB (T 100, head_dim 32) and the fused chain's badge take the one-tile
    # route, and so does self-attention up to T 128 at head dims 16 and 64;
    # the TPU kernel's second tile starts at Tkv 129
    assert fa.bf16_route(100, 100, 32) == "tile"
    for dh in (16, 32, 64):
        assert fa.bf16_route(128, 128, dh) == "tile"
    for dh in (48, 80, 96, 112, 128):
        assert fa.bf16_route(128, 128, dh) == "two_pass"
    assert fa.bf16_route(129, 129, 32) == "two_pass"
    assert fa.bf16_route(129, 100, 32) == "two_pass"
    assert fa.bf16_route(1024, 128, 64) == "two_pass"
    assert fa.bf16_route(1100, 1100, 16) == "two_pass"


def test_bf16_route_constants_are_the_kernels():
    # the one-tile kernel takes Tq and Tkv up to kTileKeys and is built for
    # the head dims of its C entry's cases: the wrapper must route no other
    source = FLASH_BF16_CU.read_text()
    assert int(re.search(r"constexpr int kTileKeys = (\d+);", source).group(1)) == fa.TILE_KEYS
    entry = source[source.index('extern "C" int tip_flash_attention_fwd_bf16_tile'):]
    cases = tuple(int(d) for d in re.findall(r"case (\d+): return launch_tile<", entry))
    assert cases == fa.TILE_HEAD_DIMS


@settings(max_examples=2000, deadline=None, derandomize=True, database=None)
@given(BF16_BITS, BF16_BITS, st.booleans(), st.booleans())
def test_float32_product_of_bf16_values_is_exact_where_it_is_normal(a_bits, b_bits, a_neg, b_neg):
    a, b = _bf16(a_bits, a_neg), _bf16(b_bits, b_neg)
    exact = a * b  # float64 holds the 16-bit significand product exactly
    if not SMALLEST_NORMAL <= abs(exact) <= BF16_MAX:
        return
    single = np.float32(a) * np.float32(b)
    assert float(single) == exact
    # so rounding the float32 product to bfloat16 is the one rounding of
    # the exact product: mul.rn.bf16x2's result
    assert float(torch.tensor(float(single)).to(torch.bfloat16)) == _round_bf16(exact)


def test_the_identity_stops_at_subnormal_products():
    # (1 + 2**-7) squared needs 15 significand bits; at 2**-150 the float32
    # subnormals keep none of them past 2**-149
    a = b = _bf16(0x0001 | (52 << 7))  # 2**-75 * (1 + 2**-7)
    exact = a * b
    assert exact < SMALLEST_NORMAL
    assert float(np.float32(a) * np.float32(b)) != exact
    # while just above the smallest normal the same significands are exact
    a = _bf16(0x0001 | (64 << 7))  # 2**-63 * (1 + 2**-7)
    exact = a * a
    assert exact >= SMALLEST_NORMAL
    assert float(np.float32(a) * np.float32(a)) == exact


def test_bf16_products_on_the_cpu_are_the_rounded_float32_products():
    rng = np.random.default_rng(0)
    a = rng.normal(size=4096).astype(np.float32)
    b = (rng.normal(size=4096) * np.exp2(rng.integers(-40, 40, size=4096))).astype(np.float32)
    got = ff._bf16_products(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (4096,)
    a_bf = torch.from_numpy(a).bfloat16().double().numpy()
    b_bf = torch.from_numpy(b).bfloat16().double().numpy()
    want = np.array([_round_bf16(x) for x in a_bf * b_bf])
    assert np.array_equal(got.double().numpy(), want)
    with pytest.raises(ValueError):
        ff._bf16_products(torch.zeros(3), torch.zeros(4))
