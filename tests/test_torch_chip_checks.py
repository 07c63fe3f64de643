"""The flash-backward checks of ``chip_smoke.py`` can fail at the main
path's scale.

A real IMDB step's dO is the gradient of a mean cross-entropy, so its dq
and dk are orders of magnitude below a fixed atol of 1e-5. These tests run
the checks on the CPU (plain versions) on such a step, and hold that they
pass on exact results and raise on a doubled dq, a dropped key tile, lost
dk rows and a 0.1% error in dv; and that the card-vs-CPU gradient check
raises when one side's dq is doubled.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from simple_tip_tpu_torch.bridge import params_from_jax
from simple_tip_tpu_torch.data import synthetic
from simple_tip_tpu_torch.models import ImdbTransformer
from simple_tip_tpu_torch.models.init import init_params
from simple_tip_tpu_torch.ops import flash_attention as fa
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def imdb():
    """Full-width IMDB params from flax's initializers, and 8 sequences."""
    net = ImdbTransformer()
    params = params_from_jax(init_params("imdb", torch.Generator().manual_seed(0), net))
    (x, y), _ = synthetic.token_classification(0, 8, 2)
    return params, x, y


@pytest.fixture(scope="module")
def step(imdb):
    params, x, y = imdb
    net = ImdbTransformer()
    net.load_state_dict(params["module"])
    q, k, v, dout = chip_smoke.imdb_step_tensors(net.eval(), x, y, CPU)
    out, lse = fa.flash_attention_fwd(q, k, v)
    args = (q, k, v, dout, lse, fa.attention_delta(out, dout))
    dq = fa.flash_bwd_dq_plain(*args)
    dk, dv = fa.flash_bwd_dkv_plain(*args)
    dq_one_tile = fa.flash_bwd_dq_plain(q, k[:, :64], v[:, :64], *args[3:])
    return {"dq": dq, "dk": dk, "dv": dv, "dq_one_tile": dq_one_tile}


def test_step_dout_has_unit_rms(imdb):
    params, x, y = imdb
    net = ImdbTransformer()
    net.load_state_dict(params["module"])
    dout = chip_smoke.imdb_step_tensors(net.eval(), x, y, CPU)[3]
    assert float(dout.pow(2).mean().sqrt()) == pytest.approx(1.0, rel=1e-5)


def _dropped_rows(t):
    t = t.clone()
    t[:, 64:] = 0
    return t


MUTATIONS = {
    "exact": ("dq", lambda s: s["dq"]),
    "doubled dq": ("dq", lambda s: 2 * s["dq"]),
    "dropped key tile": ("dq", lambda s: s["dq_one_tile"]),
    "lost dk rows": ("dk", lambda s: _dropped_rows(s["dk"])),
    "dv off by 0.1%": ("dv", lambda s: 1.001 * s["dv"]),
}


@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_backward_check_catches_errors_at_the_step_scale(step, mutation):
    grad, mutate = MUTATIONS[mutation]
    got = mutate(step)
    if mutation == "exact":
        assert chip_smoke._bwd_close(got, step[grad], grad) == (0.0, 0.0)
    else:
        with pytest.raises(AssertionError, match="flash backward"):
            chip_smoke._bwd_close(got, step[grad], grad)


@pytest.mark.parametrize("doubled", [False, True])
def test_gradient_check_catches_a_doubled_dq(imdb, monkeypatch, doubled):
    params, x, y = imdb
    if doubled:  # the first of the check's two passes stands in for the card
        plain, calls = fa.flash_bwd_dq_plain, []

        def first_doubled(*args):
            calls.append(1)
            return (2 if len(calls) == 1 else 1) * plain(*args)

        monkeypatch.setattr(fa, "flash_bwd_dq_plain", first_doubled)
        with pytest.raises(AssertionError, match="IMDB gradient"):
            chip_smoke.check_imdb_gradients(params, ((x, y), None, None), CPU)
    else:
        record = chip_smoke.check_imdb_gradients(params, ((x, y), None, None), CPU)
        assert record["imdb_gradients_card_vs_cpu_max_abs"] == 0.0
        assert all(n > 0 for n in record["qkv_kernel_grad_norms"].values())
