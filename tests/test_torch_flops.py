"""The port's analytic counts and peak table (``simple_tip_tpu_torch/utils/
flops.py``) against the JAX package's ``utils/flops.py``.

The counts are integers and must be equal, family by family, at the
registry's shapes; the convnet counts are also recomputed from the port's
own module weights and tap shapes. The peak table is the port's own: the
H100 SXM at the 3xTF32 tensor-core rate, labelled so; any other device kind
gets no peak (the JAX table falls back to v5e there, which the port must
not do).
"""

import numpy as np
import pytest
import torch

from simple_tip_tpu.utils import flops as jax_flops
from simple_tip_tpu_torch.models import Cifar10ConvNet, MnistConvNet
from simple_tip_tpu_torch.utils import flops
from test_torch_threads import one_torch_thread  # noqa: F401

H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("family", ["mnist", "fmnist", "cifar10"])
def test_convnet_counts_equal_jax(family):
    assert flops.conv_net_forward_flops(family) == jax_flops.conv_net_forward_flops(family)
    for act_bytes, in_bytes in ((2, 4), (4, 4), (1, 1)):
        assert flops.conv_net_forward_hbm_bytes(family, act_bytes, in_bytes) == \
            jax_flops.conv_net_forward_hbm_bytes(family, act_bytes, in_bytes)
    assert isinstance(flops.conv_net_forward_flops(family), int)


@pytest.mark.parametrize("kw", [
    {},
    {"seq_len": 512, "n_layers": 2},
    {"d_model": 64, "n_heads": 4, "d_ff": 128, "pooled_dense": ((64, 20), (20, 2))},
])
def test_transformer_and_training_counts_equal_jax(kw):
    got = flops.transformer_forward_flops(**kw)
    assert got == jax_flops.transformer_forward_flops(**kw)
    assert flops.training_step_flops(got, 32) == jax_flops.training_step_flops(got, 32)
    assert flops.dense_flops(1600, 10) == jax_flops.dense_flops(1600, 10)
    assert flops.conv2d_flops(26, 26, 32, 3, 3, 1) == jax_flops.conv2d_flops(26, 26, 32, 3, 3, 1)


def test_unknown_model_raises_as_jax():
    for fn in (flops.conv_net_forward_flops, flops.conv_net_forward_hbm_bytes):
        with pytest.raises(ValueError):
            fn("resnet50")


@pytest.mark.parametrize("net, hw_c", [(MnistConvNet(), (28, 28, 1)),
                                       (Cifar10ConvNet(), (32, 32, 3))])
def test_convnet_counts_match_the_port_modules(net, hw_c):
    """Every conv and dense term recomputed from the module's weight shapes
    and the taps' geometry."""
    x = torch.zeros((1,) + hw_c)
    with torch.no_grad():
        _, taps = net.eval()(x)
    convs = [m for m in net.modules() if isinstance(m, torch.nn.Conv2d)]
    denses = [m for m in net.modules() if isinstance(m, torch.nn.Linear)]
    conv_outs = [t for t in taps.values() if t.dim() == 4]
    total = 0
    for conv in convs:
        c_out, c_in, kh, kw = conv.weight.shape
        out = next(t for t in conv_outs if t.shape[3] == c_out and t.shape[1] ==
                   _valid(hw_c[0], convs, conv))
        total += 2 * out.shape[1] * out.shape[2] * c_out * kh * kw * c_in
    for dense in denses:
        total += 2 * dense.in_features * dense.out_features
    assert total == flops.conv_net_forward_flops(net.family)


def _valid(h: int, convs, upto) -> int:
    """Output height of ``upto`` along the VALID conv / 2x2 pool stack."""
    for conv in convs:
        h = h - conv.kernel_size[0] + 1
        if conv is upto:
            return h
        h //= 2


def test_h100_peaks_are_the_3xtf32_rate_and_hbm3():
    peak, label = flops.peak_flops("gpu", H100)
    assert peak == 165e12 and "3xTF32" in label and "H100" in label
    bw, bw_label = flops.hbm_peak_bytes(H100)
    assert bw == 3.35e12 and H100 in bw_label
    frac, peak, _ = flops.mfu(16.5e12, "gpu", H100)
    assert abs(frac - 0.1) < 1e-12 and peak == 165e12


@pytest.mark.parametrize("kind", ["NVIDIA H100 PCIe", "NVIDIA H100 NVL", "NVIDIA A100-SXM4-80GB",
                                  "TPU v5 lite", "weird-chip", ""])
def test_unknown_device_kind_gets_no_peak(kind):
    """The JAX table assumes v5e for an unknown kind; the port assumes no
    chip: no peak, and the label says the kind is not in the table."""
    peak, label = flops.peak_flops("gpu", kind)
    assert peak is None and "not in the table" in label
    bw, bw_label = flops.hbm_peak_bytes(kind)
    assert bw is None and "not in the table" in bw_label
    assert flops.mfu(1e12, "gpu", kind)[:2] == (None, None)
    assert jax_flops.peak_flops("tpu", "weird-chip")[0] == 197e12  # the JAX fallback


def test_cpu_peak_equals_jax():
    for cores in (1, 4, 0):
        assert flops.peak_flops("cpu", cores=cores) == jax_flops.peak_flops("cpu", cores=cores)
    got = flops.mfu(96e9, "cpu", cores=2)
    want = jax_flops.mfu(96e9, "cpu", cores=2)
    assert got == want and np.isclose(got[0], 0.5)
