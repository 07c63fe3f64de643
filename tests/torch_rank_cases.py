"""The rank side of ``test_torch_sequence_parallel.py``: every case of the
port's sequence-parallel attention, run inside one spawned group of 8 gloo
ranks on the CPU (subgroups of the first 2 and 4 ranks for the smaller
meshes). Imports no JAX: each rank starts from a fresh interpreter."""

import torch
import torch.nn.functional as F

from simple_tip_tpu_torch.models import ImdbTransformer
from simple_tip_tpu_torch.models.train import categorical_crossentropy
from simple_tip_tpu_torch.parallel.ring_attention import (
    ring_attention_sharded,
    sequence_parallel_group,
)
from simple_tip_tpu_torch.parallel.ulysses_attention import ulysses_attention_sharded

WORLD = 8
RING_SIZES = (2, 4, 8)
ULYSSES_SIZES = (2, 4)


def _tensors(arrays, grad: bool = False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


def _core(impl: str, local_core: str):
    if impl == "ring":
        return ring_attention_sharded
    return lambda q, k, v, group: ulysses_attention_sharded(q, k, v, group, local_core)


def _gradients(impl, local_core, arrays, weights, group):
    q, k, v = _tensors(arrays, grad=True)
    out = _core(impl, local_core)(q, k, v, group)
    grads = torch.autograd.grad((out * torch.from_numpy(weights)).sum(), (q, k, v))
    return [g.numpy() for g in grads]


def _imdb(impl, group, state, maxlen, x, y):
    """(probs, taps, {name: gradient}) of the IMDB model on ``state``."""
    net = ImdbTransformer(maxlen=maxlen, attention_impl=impl, sp_group=group).eval()
    net.load_state_dict(state)
    probs, taps = net(torch.from_numpy(x))
    loss = categorical_crossentropy(probs, F.one_hot(torch.from_numpy(y), 2).float()).mean()
    names, params = zip(*net.named_parameters())
    grads = torch.autograd.grad(loss, params)
    return (probs.detach().numpy(), {i: t.detach().numpy() for i, t in taps.items()},
            {n: g.numpy() for n, g in zip(names, grads)})


def _raises(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def run_cases(rank: int, world: int, inputs: dict) -> dict:
    """Every case this rank takes part in: {case key: result}."""
    groups = {n: sequence_parallel_group(n) for n in RING_SIZES}
    res = {}
    for n in RING_SIZES:
        if rank < n:
            res["ring", n] = ring_attention_sharded(*_tensors(inputs["ring"]), groups[n]).numpy()
    for n in ULYSSES_SIZES:
        if rank < n:
            for core in ("auto", "flash"):
                res["ulysses", n, core] = ulysses_attention_sharded(
                    *_tensors(inputs["ulysses"]), groups[n], core).numpy()
    for impl, n, core in inputs["grad_cases"]:
        if rank < n:
            res["grad", impl, n, core] = _gradients(impl, core, inputs["grad"], inputs["grad_w"],
                                                    groups[n])
    state, x, y = inputs["imdb"]
    for impl, n in (("ring", 4), ("ulysses", 2)):
        if rank < n:
            res["imdb", impl] = _imdb(impl, groups[n], state, x.shape[1], x, y)
    if rank == 0:
        res["imdb", "flash"] = _imdb("flash", None, state, x.shape[1], x, y)
    uneven = _tensors(inputs["uneven"])
    res["guards"] = {
        "flash_with_group": _raises(lambda: ImdbTransformer(attention_impl="flash",
                                                            sp_group=groups[2])),
        "ulysses_heads": _raises(lambda: ImdbTransformer(
            maxlen=x.shape[1], attention_impl="ulysses", sp_group=groups[4])(
            torch.from_numpy(x)) if rank < 4 else None),
        "ring_uneven_core": _raises(lambda: ring_attention_sharded(*uneven, groups[8])),
        "ring_uneven_model": _raises(lambda: ImdbTransformer(
            maxlen=100, attention_impl="ring", sp_group=groups[8])(
            torch.zeros((2, 100), dtype=torch.int64))),
    }
    return res


def barrier_cases(rank: int, world: int, timeout_s: float) -> dict:
    """Rank 0 and 1 meet at one barrier name twice (each use its own
    rendezvous); then rank 1 skips the third, and rank 0's times out."""
    from simple_tip_tpu_torch.parallel import distributed

    distributed.barrier("twice", timeout_s=60)
    distributed.barrier("twice", timeout_s=60)
    if rank == 1:
        return "skipped"
    try:
        distributed.barrier("alone", timeout_s=timeout_s)
    except TimeoutError as e:
        return str(e)
    return "passed"
