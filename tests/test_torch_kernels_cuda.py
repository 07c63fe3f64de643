"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card and skips without one (decided inside
the fixture, never at import). The file imports neither jax nor the JAX
package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from simple_tip_tpu_torch.bridge import glorot_params, params_from_jax
from simple_tip_tpu_torch.ops import dsa_cuda, fused_forward
from simple_tip_tpu_torch.ops import flash_attention as fa


@pytest.fixture
def cuda_device():
    """The card, or a skip where none is visible."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from simple_tip_tpu_torch.device import resolve

    return resolve(None)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3, 7, 300, 1000, 1002])  # tiles of 5 images
def test_fused_forward_kernel_matches_plain(cuda_device, batch):
    fused = {k: v.to(cuda_device) for k, v in params_from_jax(glorot_params(3))["fused"].items()}
    x = np.random.default_rng(batch).uniform(0, 1, size=(batch, 28, 28, 1)).astype(np.float32)
    x = torch.from_numpy(x).to(cuda_device)
    before = fused_forward.LAUNCHES
    got = fused_forward.fused_mnist_probs(fused, x)
    torch.cuda.synchronize()
    assert fused_forward.LAUNCHES == before + 1
    want = fused_forward.fused_mnist_probs_plain(fused, x)
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n_query,n_train,dim", [(200, 384, 32), (70, 129, 1601)])
def test_dsa_nearest_kernel_matches_plain(cuda_device, n_query, n_train, dim):
    rng = np.random.default_rng(dim)
    train = torch.from_numpy(rng.random((n_train, dim), dtype=np.float32)).to(cuda_device)
    train[5] = train[3]  # exact duplicate rows: ties go to the lower index
    labels = rng.integers(0, 4, size=n_train)
    x = torch.from_numpy(rng.random((n_query, dim), dtype=np.float32)).to(cuda_device)
    x[0] = train[3]
    x_labels = rng.integers(0, 5, size=n_query)  # class 4 has no training rows
    x_labels[0] = labels[3] = labels[5] = 1
    args = (
        x,
        torch.as_tensor(x_labels, dtype=torch.int32, device=cuda_device),
        train,
        (train * train).sum(1),
        torch.as_tensor(labels, dtype=torch.int32, device=cuda_device),
    )
    for want_same in (True, False):
        before = dsa_cuda.LAUNCHES
        got_min, got_arg = dsa_cuda.masked_nearest(*args, want_same)
        torch.cuda.synchronize()
        assert dsa_cuda.LAUNCHES == before + 1
        want_min, want_arg = dsa_cuda.masked_nearest_plain(*args, want_same)
        torch.testing.assert_close(got_min, want_min, rtol=1e-4, atol=1e-4)
        assert torch.equal(got_arg, want_arg)
    masked = args[1] == 4
    got_min, got_arg = dsa_cuda.masked_nearest(*args, True)
    assert torch.isinf(got_min[masked]).all() and (got_arg[masked] == 0).all()
    assert int(dsa_cuda.masked_nearest(*args, True)[1][0]) == 3


def _layout_case(name: str):
    """(x, x_labels, train, labels) as numpy for one class-layout case at the
    kernel's real 128 x 128 tile. Integer-valued features (more than the
    kernel's 32 few-feature limit, so on the tensor cores) make every
    product exact in 3xTF32, so ties are exact and the lowest original index
    must win."""
    rng = np.random.default_rng(len(name))
    if name == "ties_across_a_class_boundary":
        labels = np.repeat([0, 1, 2], [130, 200, 300])
        train = rng.integers(0, 3, size=(630, 40))
        train[[129, 130, 400]] = train[7]  # one row in classes 0, 0, 1 and 2
        perm = rng.permutation(630)
        train, labels = train[perm], labels[perm]
        x = rng.integers(0, 3, size=(300, 40))
        x[:150] = train[perm.argsort()[7]]
        x_labels = np.where(np.arange(300) < 200, 2, 0)
    elif name == "a_class_without_training_rows":
        labels = rng.integers(0, 4, size=500)
        labels[labels == 2] = 3
        train = rng.integers(0, 4, size=(500, 36))
        x_labels = rng.integers(0, 4, size=300)
        x = rng.integers(0, 4, size=(300, 36))
    elif name == "a_class_filling_whole_tiles":
        labels = np.repeat([0, 1, 2], [256, 128, 77])
        rng.shuffle(labels)
        train = rng.integers(0, 3, size=(461, 48))
        x_labels = np.repeat([1, 0, 2], [128, 256, 50])
        x = rng.integers(0, 3, size=(434, 48))
    elif name == "rows_not_a_multiple_of_the_tile":
        labels = rng.integers(0, 5, size=1000)
        train = rng.integers(0, 3, size=(1000, 37))  # D padded to 40 on the card
        x_labels = rng.integers(0, 5, size=333)
        x = rng.integers(0, 3, size=(333, 37))
    elif name == "few_features_close_together":
        # IMDB-like: 20 features, traces near one point, so the float32
        # expansion's rounding decides the nearest row; the few-feature path
        # sums as the plain version does and must pick the same rows
        labels = rng.integers(0, 2, size=3000)
        train = 2.0 + rng.normal(0, 0.02, size=(3000, 20))
        x_labels = rng.integers(0, 2, size=500)
        x = 2.0 + rng.normal(0, 0.02, size=(500, 20))
    else:  # "mnist_like": 2,000 x 1,600 uniform features, 10 classes
        labels = rng.integers(0, 10, size=2000)
        train = rng.random((2000, 1600))
        x_labels = rng.integers(0, 10, size=700)
        x = rng.random((700, 1600))
    return x.astype(np.float32), x_labels, train.astype(np.float32), labels


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "ties_across_a_class_boundary", "a_class_without_training_rows",
    "a_class_filling_whole_tiles", "rows_not_a_multiple_of_the_tile",
    "few_features_close_together", "mnist_like",
])
def test_dsa_nearest_kernel_with_a_class_layout_matches_plain(cuda_device, case):
    x, x_labels, train, labels = _layout_case(case)
    train = torch.from_numpy(train).to(cuda_device)
    train_sq = (train * train).sum(1)
    train_labels = torch.as_tensor(labels, dtype=torch.int32, device=cuda_device)
    layout = dsa_cuda.class_layout(train, train_sq, train_labels)
    args = (torch.from_numpy(x).to(cuda_device),
            torch.as_tensor(x_labels, dtype=torch.int32, device=cuda_device),
            train, train_sq, train_labels)
    planned = dsa_cuda.plan_queries(x_labels, layout, cuda_device)
    for queries in (planned, None):  # the planned walk, then the full walk
        for want_same in (True, False):
            before = dsa_cuda.LAUNCHES
            got_min, got_arg = dsa_cuda.masked_nearest(*args, want_same, layout, queries)
            torch.cuda.synchronize()
            assert dsa_cuda.LAUNCHES == before + 1
            want_min, want_arg = dsa_cuda.masked_nearest_plain(*args, want_same)
            torch.testing.assert_close(got_min, want_min, rtol=1e-4, atol=1e-4)
            assert torch.equal(got_arg, want_arg)


@pytest.mark.cuda
def test_dsa_nearest_kernel_refuses_a_plan_of_another_tile(cuda_device, monkeypatch):
    """The kernel walks 128 x 128 tiles; a plan made for any other tile
    raises instead of returning the minima of the wrong rows."""
    x, x_labels, train, labels = _layout_case("rows_not_a_multiple_of_the_tile")
    train = torch.from_numpy(train).to(cuda_device)
    train_sq = (train * train).sum(1)
    train_labels = torch.as_tensor(labels, dtype=torch.int32, device=cuda_device)
    layout = dsa_cuda.class_layout(train, train_sq, train_labels)
    monkeypatch.setattr(dsa_cuda, "BLOCK_QUERIES", 64)
    queries = dsa_cuda.plan_queries(x_labels, layout, cuda_device)
    monkeypatch.undo()
    args = (torch.from_numpy(x).to(cuda_device),
            torch.as_tensor(x_labels, dtype=torch.int32, device=cuda_device),
            train, train_sq, train_labels, True, layout, queries)
    before = dsa_cuda.LAUNCHES
    with pytest.raises(RuntimeError):
        dsa_cuda.masked_nearest(*args)
    assert dsa_cuda.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2, 5, 300, 1001, 1003])  # tiles of 4 images
def test_cifar10_forward_kernel_matches_plain(cuda_device, batch):
    params = params_from_jax(glorot_params(4, "cifar10"))["fused"]
    fused = {k: v.to(cuda_device) for k, v in params.items()}
    x = np.random.default_rng(batch).uniform(0, 1, size=(batch, 32, 32, 3)).astype(np.float32)
    x = torch.from_numpy(x).to(cuda_device)
    before = fused_forward.CIFAR_LAUNCHES
    got = fused_forward.fused_cifar10_probs(fused, x)
    torch.cuda.synchronize()
    assert fused_forward.CIFAR_LAUNCHES == before + 1
    want = fused_forward.fused_cifar10_probs_plain(fused, x)
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,t_kv",
    [
        ((2, 128, 4, 16), 128),
        ((1, 100, 2, 32), 100),
        ((8, 100, 2, 32), 100),  # IMDB: every key in one chunk, 7 of 8 query tiles busy
        ((2, 300, 2, 8), 300),
        ((1, 17, 1, 4), 17),
        ((1, 40, 2, 8), 200),
        ((3, 65, 3, 5), 64),  # odd head dim, one ragged query tile
        ((1, 70, 1, 128), 129),  # the widest head dim
    ],
)
def test_flash_attention_kernel_matches_plain(cuda_device, shape, t_kv):
    rng = np.random.default_rng(shape[1])
    b, t, h, dh = shape
    q, k, v = (
        torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda_device)
        for s in ((b, t, h, dh), (b, t_kv, h, dh), (b, t_kv, h, dh))
    )
    before = fa.LAUNCHES
    out, lse = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    want_out, want_lse = fa.flash_attention_plain(q, k, v)
    torch.testing.assert_close(out, want_out, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)


BWD_SHAPES = [
    ((32, 100, 2, 32), 100),  # an IMDB training batch
    ((4, 300, 2, 8), 300),  # several ragged tiles each way
    ((2, 70, 1, 128), 129),  # the widest head dim, Tq != Tkv
    ((1, 40, 2, 8), 200),  # keys longer than queries
    ((1, 150, 1, 4), 70),  # queries longer than keys
    ((3, 65, 3, 5), 64),  # odd head dim, one ragged query tile
    ((2, 104, 2, 32), 104),  # T at a multiple of the 8-row n-tiles
    ((2, 112, 2, 32), 112),  # T at a multiple of the 16-row m-tiles
    ((2, 113, 2, 32), 113),  # one past: a last m-tile and n-tile of one row
    ((3, 100, 2, 16), 100),  # dh 16
    ((2, 90, 2, 33), 77),  # dh 33: padded to 64, 4-byte copies
    ((2, 130, 2, 64), 140),  # dh 64: several chunks of streamed rows
    ((350, 100, 2, 32), 100),  # 700 sequence-heads: items wrap across persistent blocks
]


def _bwd_inputs(shape, t_kv, device, seed):
    rng = np.random.default_rng(seed)
    b, t, h, dh = shape
    return [
        torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
        for s in ((b, t, h, dh), (b, t_kv, h, dh), (b, t_kv, h, dh), (b, t, h, dh))
    ]


def _bwd_close(got, want, what):
    """|got - want| <= 1e-5 + 1e-4 |want| (float32 sums in other orders)."""
    excess = float(((got - want).abs() - 1e-4 * want.abs()).max())
    assert excess <= 1e-5, f"{what} off by {excess} beyond rtol 1e-4"


@pytest.mark.cuda
@pytest.mark.parametrize("shape,t_kv", BWD_SHAPES)
def test_flash_bwd_kernels_match_plain(cuda_device, shape, t_kv):
    q, k, v, dout = _bwd_inputs(shape, t_kv, cuda_device, shape[1] + t_kv)
    out, lse = fa.flash_attention_fwd(q, k, v)
    dvec = fa.attention_delta(out, dout)
    before = (fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES)
    dq = fa.flash_bwd_dq(q, k, v, dout, lse, dvec)
    dk, dv = fa.flash_bwd_dkv(q, k, v, dout, lse, dvec)
    torch.cuda.synchronize()
    assert (fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES) == (before[0] + 1, before[1] + 1)
    _bwd_close(dq, fa.flash_bwd_dq_plain(q, k, v, dout, lse, dvec), "dq")
    want_dk, want_dv = fa.flash_bwd_dkv_plain(q, k, v, dout, lse, dvec)
    _bwd_close(dk, want_dk, "dk")
    _bwd_close(dv, want_dv, "dv")


@pytest.mark.cuda
def test_flash_bwd_kernels_match_plain_where_most_p_underflow(cuda_device):
    """90% of the keys score ~-160 below the rest (a shared dimension holds
    30 * -30, exact in TF32), so exp underflows to 0 for them while the
    other keys' scores stay small."""
    q, k, v, dout = _bwd_inputs((4, 100, 2, 32), 100, cuda_device, 11)
    far = torch.from_numpy(np.random.default_rng(12).random((4, 100, 2)) < 0.9).to(cuda_device)
    q[..., 0] = 30.0
    k[..., 0] = torch.where(far, -30.0, 0.0)
    out, lse = fa.flash_attention_fwd(q, k, v)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * fa._scale(32) - lse[..., None]
    assert float((scores < -104).float().mean()) > 0.8  # exp(-104) is below float32's least
    dvec = fa.attention_delta(out, dout)
    want_dk, want_dv = fa.flash_bwd_dkv_plain(q, k, v, dout, lse, dvec)
    dk, dv = fa.flash_bwd_dkv(q, k, v, dout, lse, dvec)
    _bwd_close(fa.flash_bwd_dq(q, k, v, dout, lse, dvec),
               fa.flash_bwd_dq_plain(q, k, v, dout, lse, dvec), "dq")
    _bwd_close(dk, want_dk, "dk")
    _bwd_close(dv, want_dv, "dv")


@pytest.mark.cuda
def test_flash_bwd_kernels_are_deterministic(cuda_device):
    """No atomics: two launches on the same inputs give bit-equal dq, dk and
    dv, at a size where every persistent block walks several items."""
    q, k, v, dout = _bwd_inputs((350, 100, 2, 32), 100, cuda_device, 13)
    out, lse = fa.flash_attention_fwd(q, k, v)
    args = (q, k, v, dout, lse, fa.attention_delta(out, dout))
    first = (fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args))
    second = (fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


WIDE_SHAPES = [
    ((2, 70, 2, 129), 77),  # one column past the narrow kernels: 4-byte copies, 2 slices
    ((1, 100, 2, 160), 100),  # 16-byte copies, a 32-column second slice
    ((2, 130, 1, 256), 90),  # two full slices, ragged 64-row blocks each way
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,t_kv", WIDE_SHAPES)
def test_flash_kernels_match_plain_at_wide_heads(cuda_device, shape, t_kv):
    """B4, B5 and B6 above head_dim 128 (their wide-head variants) against
    the plain versions, at the checks of the narrow shapes."""
    q, k, v, dout = _bwd_inputs(shape, t_kv, cuda_device, shape[3])
    before = (fa.LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES)
    out, lse = fa.flash_attention_fwd(q, k, v)
    dvec = fa.attention_delta(out, dout)
    dq = fa.flash_bwd_dq(q, k, v, dout, lse, dvec)
    dk, dv = fa.flash_bwd_dkv(q, k, v, dout, lse, dvec)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES) == tuple(n + 1 for n in before)
    want_out, want_lse = fa.flash_attention_plain(q, k, v)
    torch.testing.assert_close(out, want_out, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    _bwd_close(dq, fa.flash_bwd_dq_plain(q, k, v, dout, lse, dvec), "dq")
    want_dk, want_dv = fa.flash_bwd_dkv_plain(q, k, v, dout, lse, dvec)
    _bwd_close(dk, want_dk, "dk")
    _bwd_close(dv, want_dv, "dv")


@pytest.mark.cuda
def test_flash_kernels_are_deterministic_at_wide_heads(cuda_device):
    """The wide-head variants use no atomics either: two launches give
    bit-equal out, lse, dq, dk and dv."""
    q, k, v, dout = _bwd_inputs((3, 150, 2, 256), 150, cuda_device, 14)
    runs = []
    for _ in range(2):
        out, lse = fa.flash_attention_fwd(q, k, v)
        args = (q, k, v, dout, lse, fa.attention_delta(out, dout))
        runs.append((out, lse, fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_attention_gradients_on_the_card_match_the_cpu(cuda_device):
    rng = np.random.default_rng(7)
    host = [torch.from_numpy(rng.normal(size=(3, 90, 2, 16)).astype(np.float32)) for _ in range(4)]
    grads = {}
    for dev in (cuda_device, torch.device("cpu")):
        q, k, v = (x.to(dev).requires_grad_() for x in host[:3])
        out = fa.flash_attention(q, k, v)
        grads[dev.type] = torch.autograd.grad(out, (q, k, v), host[3].to(dev))
    for got, want in zip(grads["cuda"], grads["cpu"]):
        _bwd_close(got.cpu(), want, "gradient")


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    fused = {k: v.to(cuda_device) for k, v in params_from_jax(glorot_params(0))["fused"].items()}
    with pytest.raises(ValueError):
        fused_forward.fused_mnist_probs(fused, torch.zeros(2, 28, 28, 3, device=cuda_device))
    x = torch.zeros(4, 8, device=cuda_device)
    lab = torch.zeros(4, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        dsa_cuda.masked_nearest(x, lab, x, x.sum(1), lab, True)
    cifar = {
        k: v.to(cuda_device)
        for k, v in params_from_jax(glorot_params(0, "cifar10"))["fused"].items()
    }
    misaligned = torch.zeros(2 * 3072 + 1, device=cuda_device)[1:].view(2, 32, 32, 3)
    with pytest.raises(ValueError):
        fused_forward.fused_cifar10_probs(cifar, misaligned)
    without_fragments = {k: v for k, v in cifar.items() if not k.endswith("_tc")}
    with pytest.raises(ValueError):
        fused_forward.fused_cifar10_probs(without_fragments, torch.zeros(2, 32, 32, 3, device=cuda_device))


# -- the bf16 scoring mode: B1, B3 and B4 in bf16 -----------------------------------
#
# The bf16 kernels round activations to bfloat16 where the TPU kernels do, so a
# float32 sum taken in another order than the plain version's can flip one
# rounding: a flipped activation moved a probability by at most 1.1e-4 over
# 10,000 CIFAR-10 images on an H100 (1.5e-5 for MNIST; initialised weights, as
# here), hence BF16_FUSED_ATOL. B4's p is rounded to bfloat16 too, so one
# flipped p moves every output of its query row by up to 2^-8 p |v| / l;
# outputs are held within one bfloat16 ulp at the output's largest magnitude,
# their mean |difference| within BF16_MEAN_ULPS of that ulp, lse (float32)
# within 1e-5.
BF16_FUSED_ATOL = 5e-4
BF16_MODULE_ATOL = 5e-3  # the JAX package's gate for a fused forward against its module
BF16_MEAN_ULPS = 1 / 64
BF16_FUSED = {
    "mnist": ((28, 28, 1), fused_forward.fused_mnist_probs_bf16,
              fused_forward.fused_mnist_probs_bf16_plain, "BF16_LAUNCHES"),
    "cifar10": ((32, 32, 3), fused_forward.fused_cifar10_probs_bf16,
                fused_forward.fused_cifar10_probs_bf16_plain, "CIFAR_BF16_LAUNCHES"),
}
BF16_FLASH_SHAPES = [  # (q shape, Tkv): IMDB's, ragged T, several key tiles, wider heads
    ((4, 100, 2, 32), 100), ((3, 37, 2, 32), 53), ((2, 130, 2, 32), 70),
    ((1, 1100, 1, 16), 1100), ((2, 200, 2, 64), 200), ((2, 150, 1, 128), 150),
]


def _bf16_ulp(x: torch.Tensor) -> float:
    """One bfloat16 ulp at |x|'s largest magnitude."""
    return float(2.0 ** (np.floor(np.log2(float(x.float().abs().max()))) - 7))


@pytest.mark.cuda
@pytest.mark.parametrize("family,batch", [
    ("mnist", 1), ("mnist", 7), ("mnist", 9), ("mnist", 1001),  # tiles of 8 images
    ("cifar10", 1), ("cifar10", 5), ("cifar10", 1003),  # tiles of 4
])
def test_bf16_fused_forward_kernels_match_plain(cuda_device, family, batch):
    from simple_tip_tpu_torch.models import Cifar10ConvNet, MnistConvNet

    shape, kernel, plain, counter = BF16_FUSED[family]
    bridged = params_from_jax(glorot_params(5, family))
    fused = {k: v.to(cuda_device) for k, v in bridged["fused"].items()}
    net = {"mnist": MnistConvNet, "cifar10": Cifar10ConvNet}[family](compute_dtype="bfloat16")
    net = net.to(cuda_device).eval()
    net.load_state_dict(bridged["module"])
    x = np.random.default_rng(batch).uniform(0, 1, size=(batch,) + shape).astype(np.float32)
    x = torch.from_numpy(x).to(cuda_device)
    before = getattr(fused_forward, counter)
    got = kernel(fused, x)
    torch.cuda.synchronize()
    assert getattr(fused_forward, counter) == before + 1
    want = plain(fused, x)
    assert float((got - want).abs().max()) <= BF16_FUSED_ATOL
    with torch.no_grad():
        assert float((got - net(x)[0]).abs().max()) <= BF16_MODULE_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape,t_kv", BF16_FLASH_SHAPES)
def test_bf16_flash_forward_matches_plain(cuda_device, shape, t_kv):
    rng = np.random.default_rng(t_kv)
    b, _, h, dh = shape
    q = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(b, t_kv, h, dh)).astype(np.float32))
            for _ in range(2))
    q, k, v = (t.to(cuda_device).to(torch.bfloat16) for t in (q, k, v))
    before = fa.BF16_LAUNCHES, fa.LAUNCHES
    out, lse = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert (fa.BF16_LAUNCHES, fa.LAUNCHES) == (before[0] + 1, before[1])
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    want, want_lse = fa.flash_attention_bf16_plain(q, k, v)
    diff = (out.float() - want.float()).abs()
    assert float(diff.max()) <= _bf16_ulp(want)
    assert float(diff.mean()) <= BF16_MEAN_ULPS * _bf16_ulp(want)
    assert float(((lse - want_lse).abs() - 1e-5 * want_lse.abs()).max()) <= 1e-5


@pytest.mark.cuda
def test_bf16_cuda_tensors_never_reach_a_plain_version(cuda_device, monkeypatch):
    from simple_tip_tpu_torch.models import ImdbTransformer, MnistConvNet
    from simple_tip_tpu_torch.models.predict import predict

    def refuse(*args):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in ("fused_mnist_probs_bf16_plain", "fused_cifar10_probs_bf16_plain",
                 "fused_mnist_probs_plain", "fused_cifar10_probs_plain"):
        monkeypatch.setattr(fused_forward, name, refuse)
    for name in ("flash_attention_bf16_plain", "flash_attention_plain"):
        monkeypatch.setattr(fa, name, refuse)
    rng = np.random.default_rng(0)
    mnist = params_from_jax(glorot_params(1))
    net = MnistConvNet(compute_dtype="bfloat16").to(cuda_device).eval()
    net.load_state_dict(mnist["module"])
    fused = {k: v.to(cuda_device) for k, v in mnist["fused"].items()}
    before = fused_forward.BF16_LAUNCHES, fused_forward.LAUNCHES
    predict(net, fused, rng.uniform(0, 1, (20, 28, 28, 1)).astype(np.float32), cuda_device)
    assert (fused_forward.BF16_LAUNCHES, fused_forward.LAUNCHES) == (before[0] + 1, before[1])
    cifar = {k: v.to(cuda_device)
             for k, v in params_from_jax(glorot_params(1, "cifar10"))["fused"].items()}
    before = fused_forward.CIFAR_BF16_LAUNCHES
    fused_forward.fused_cifar10_probs_bf16(cifar, torch.rand(6, 32, 32, 3, device=cuda_device))
    assert fused_forward.CIFAR_BF16_LAUNCHES == before + 1
    imdb = params_from_jax(glorot_params(1, "imdb"))
    net = ImdbTransformer(compute_dtype="bfloat16").to(cuda_device).eval()
    net.load_state_dict(imdb["module"])
    before = fa.BF16_LAUNCHES, fa.LAUNCHES
    probs = predict(net, {}, rng.integers(0, 2000, (9, 100)), cuda_device)
    torch.cuda.synchronize()
    assert probs.dtype == torch.float32 and probs.shape == (9, 2)
    assert (fa.BF16_LAUNCHES, fa.LAUNCHES) == (before[0] + 1, before[1])


@pytest.mark.cuda
def test_bf16_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros(2, 10, 2, 24, dtype=torch.bfloat16, device=cuda_device)  # dh not 16k
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, q, q)
    q = torch.zeros(2, 10, 2, 32, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, q.float(), q)
    q.requires_grad_(True)
    out = fa.flash_attention(q, q, q)
    with pytest.raises(RuntimeError, match="float32"):
        out.float().sum().backward()
    mnist = {k: v.to(cuda_device) for k, v in params_from_jax(glorot_params(0))["fused"].items()}
    without_fragments = {k: v for k, v in mnist.items() if not k.endswith("_bf")}
    with pytest.raises(ValueError):
        fused_forward.fused_mnist_probs_bf16(without_fragments,
                                             torch.zeros(2, 28, 28, 1, device=cuda_device))


# -- the bf16 kernels' Hopper redesign: B4's two routes, B1's batches and scales --------
#
# B4 in bf16 takes its one-tile route (persistent blocks, scores in registers)
# up to Tq and Tkv 128 at head dims 16, 32 and 64, and its two-pass route at
# the other shapes (ops.flash_attention.bf16_route); each is held to the
# plain version as above, across the edge, at a batch that is no multiple of
# the persistent grid, with one and four heads, and at head dims outside
# the one-tile route. B1 in
# bf16 forms conv1's products with mul.rn.bf16x2: held at ragged batches, over
# more images than one pass of the grid, on inputs scaled far down and up,
# and its product alone against the correctly rounded product.
BF16_ROUTE_SHAPES = [  # (q shape, Tkv, route)
    ((4, 128, 2, 32), 128, "tile"), ((4, 129, 2, 32), 129, "two_pass"),
    ((1001, 100, 2, 32), 100, "tile"), ((3, 100, 1, 32), 100, "tile"),
    ((3, 100, 4, 32), 100, "tile"), ((5, 100, 4, 64), 100, "tile"),
    ((3, 77, 2, 16), 77, "tile"), ((2, 100, 2, 48), 100, "two_pass"),
    ((3, 128, 2, 128), 128, "two_pass"),
]


def _round_bf16(x: np.ndarray) -> np.ndarray:
    """float64 ``x`` correctly rounded to bfloat16 (to nearest even, with
    bfloat16's subnormals, spacing 2**-133 below 2**-126)."""
    ulp = np.exp2(np.maximum(np.frexp(np.abs(x))[1] - 1, -126) - 7.0)
    return np.where(x == 0, x, np.rint(x / ulp) * ulp)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,t_kv,route", BF16_ROUTE_SHAPES)
def test_bf16_flash_forward_routes_match_plain(cuda_device, shape, t_kv, route):
    rng = np.random.default_rng(shape[0] * 1000 + t_kv)
    b, t_q, h, dh = shape
    q = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(b, t_kv, h, dh)).astype(np.float32))
            for _ in range(2))
    q, k, v = (t.to(cuda_device).to(torch.bfloat16) for t in (q, k, v))
    assert fa.bf16_route(t_q, t_kv, dh) == route
    before = fa.BF16_LAUNCHES, fa.BF16_TILE_LAUNCHES
    out, lse = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    moved = (fa.BF16_LAUNCHES - before[0], fa.BF16_TILE_LAUNCHES - before[1])
    assert moved == ((1, 1) if route == "tile" else (1, 0))
    want, want_lse = fa.flash_attention_bf16_plain(q, k, v)
    diff = (out.float() - want.float()).abs()
    assert float(diff.max()) <= _bf16_ulp(want)
    assert float(diff.mean()) <= BF16_MEAN_ULPS * _bf16_ulp(want)
    assert float(((lse - want_lse).abs() - 1e-5 * want_lse.abs()).max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("batch,scale", [
    (1, 1.0), (7, 1.0), (9, 1.0), (1001, 1.0), (10003, 1.0),  # tiles of 4 images
    (300, 2.0 ** -60), (300, 2.0 ** 60),
])
def test_bf16_mnist_forward_batches_and_scales(cuda_device, batch, scale):
    fused = {k: v.to(cuda_device) for k, v in params_from_jax(glorot_params(7))["fused"].items()}
    x = np.random.default_rng(batch).uniform(0, 1, size=(batch, 28, 28, 1)) * scale
    x = torch.from_numpy(x.astype(np.float32)).to(cuda_device)
    before = fused_forward.BF16_LAUNCHES
    got = fused_forward.fused_mnist_probs_bf16(fused, x)
    torch.cuda.synchronize()
    assert fused_forward.BF16_LAUNCHES == before + 1
    want = fused_forward.fused_mnist_probs_bf16_plain(fused, x)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= BF16_FUSED_ATOL


@pytest.mark.cuda
def test_bf16_conv1_product_is_the_correctly_rounded_product(cuda_device):
    rng = np.random.default_rng(0)
    n = 1 << 16
    w1 = params_from_jax(glorot_params(0))["fused"]["w1"].numpy().reshape(-1)
    cases = {
        "random": (rng.normal(size=n), rng.normal(size=n) * np.exp2(rng.integers(-60, 60, n))),
        # pixels in [0, 1] times the bridge's conv1 weights
        "real": (rng.integers(0, 256, n) / 255.0, rng.choice(w1, n)),
        # products around the smallest normal float32 and below it
        "smallest": (rng.normal(size=n) * 2.0 ** -63, rng.normal(size=n) * 2.0 ** -64),
    }
    for name, (a, b) in cases.items():
        a, b = (torch.from_numpy(t.astype(np.float32)).to(cuda_device) for t in (a, b))
        got = fused_forward._bf16_products(a, b)
        torch.cuda.synchronize()
        assert got.is_cuda
        exact = a.bfloat16().double().cpu().numpy() * b.bfloat16().double().cpu().numpy()
        assert np.array_equal(got.double().cpu().numpy(), _round_bf16(exact)), name
