"""Weight bridge between the flax parameter trees of the three model
families and the port's modules.

A flax tree arrives as nested dicts of numpy arrays; ``params_from_jax``
tells the family by its top-level names and returns two layouts of it:

- ``"module"``: the ``state_dict`` of the port's module. Conv kernels go
  from HWIO to OIHW; dense kernels keep their ``[in, out]`` row order,
  stored transposed as ``nn.Linear``'s ``[out, in]`` (the rows of the first
  dense layer after a conv stack already follow the NHWC flatten that the
  modules reproduce). IMDB's ``DenseGeneral`` kernels ``[32, 2, 32]`` (q, k,
  v) and ``[2, 32, 32]`` (out) fold their head axes into one.
- ``"fused"``: the operands of the family's fused forward kernel, each conv
  as its im2col matrix ``HWIO.reshape(9 * C_in, C_out)`` with rows in
  ``(dy, dx, c)`` order, each dense kernel as ``[in, out]``:

  - MNIST (``Conv_0``, ``Conv_1``, ``Dense_0``): ``w1 [9, 32]``,
    ``w2 [288, 64]``, ``wd [1600, 10]`` and biases;
  - CIFAR-10 (``Conv_0..2``, ``Dense_0..1``): ``w1 [27, 32]``,
    ``w2 [288, 64]``, ``w3 [576, 64]``, ``wd1 [1024, 64]``, ``wd2 [64, 10]``
    and biases;
  - besides, each conv that the card multiplies on its tensor cores as
    ``w*_tc``, its im2col matrix as TF32 fragments
    (``ops.fused_forward.tf32_fragments``): MNIST ``w2_tc``, CIFAR-10
    ``w1_tc``, ``w2_tc`` and ``w3_tc``. The plain versions do not read them;
  - IMDB: none (the JAX package has no fused IMDB kernel; its attention
    core is kernel B4 inside the module).

All tensors are float32 on the CPU; callers move them to their device.
``params_to_jax`` is the inverse of the module layout: a trained module (or
its ``state_dict``) becomes a flax-layout numpy tree again, with every
dict's keys sorted as a jitted flax ``init`` returns them, and the IMDB
attention subtree under ``MultiHeadDotProductAttention_0``, the name of the
JAX default (dense) core, from which the JAX ``CaseStudy.load_params``
builds its template.
"""

from typing import Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

from simple_tip_tpu_torch.models import Cifar10ConvNet, ImdbTransformer, MnistConvNet
from simple_tip_tpu_torch.ops.fused_forward import tf32_fragments

FAMILIES = ("mnist", "cifar10", "imdb")
_ATTENTION_NAMES = ("MultiHeadDotProductAttention_0", "SequenceParallelSelfAttention_0")


def _f32(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _np(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def family_model(family: str):
    """The port's model class of ``family``."""
    for model in (MnistConvNet, Cifar10ConvNet, ImdbTransformer):
        if model.family == family:
            return model
    raise ValueError(f"unknown family {family!r}; use one of {FAMILIES}")


def family_of(params) -> str:
    """``"mnist"``, ``"cifar10"`` or ``"imdb"`` from a flax tree's names."""
    if "TransformerBlock_0" in params:
        return "imdb"
    if "Conv_2" in params:
        return "cifar10"
    return "mnist"


def _expect(name: str, a: np.ndarray, shape) -> np.ndarray:
    if a.shape != tuple(shape):
        raise ValueError(f"bridge: {name} has shape {a.shape}, want {tuple(shape)}")
    return a


def _mnist(params):
    w1 = _expect("Conv_0", _np(params["Conv_0"]["kernel"]), (3, 3, 1, 32))
    w2 = _expect("Conv_1", _np(params["Conv_1"]["kernel"]), (3, 3, 32, 64))
    wd = _expect("Dense_0", _np(params["Dense_0"]["kernel"]), (1600, 10))
    b1, b2, bd = (params[n]["bias"] for n in ("Conv_0", "Conv_1", "Dense_0"))
    module = {
        "conv1.weight": _f32(w1.transpose(3, 2, 0, 1)),
        "conv1.bias": _f32(b1),
        "conv2.weight": _f32(w2.transpose(3, 2, 0, 1)),
        "conv2.bias": _f32(b2),
        "dense.weight": _f32(wd.T),
        "dense.bias": _f32(bd),
    }
    fused = {
        "w1": _f32(w1.reshape(9, 32)),
        "b1": _f32(b1),
        "w2": _f32(w2.reshape(288, 64)),
        "b2": _f32(b2),
        "wd": _f32(wd),
        "bd": _f32(bd),
    }
    fused["w2_tc"] = tf32_fragments(fused["w2"])
    return module, fused


def _cifar10(params):
    convs = [
        _expect("Conv_0", _np(params["Conv_0"]["kernel"]), (3, 3, 3, 32)),
        _expect("Conv_1", _np(params["Conv_1"]["kernel"]), (3, 3, 32, 64)),
        _expect("Conv_2", _np(params["Conv_2"]["kernel"]), (3, 3, 64, 64)),
    ]
    dense = [
        _expect("Dense_0", _np(params["Dense_0"]["kernel"]), (1024, 64)),
        _expect("Dense_1", _np(params["Dense_1"]["kernel"]), (64, 10)),
    ]
    conv_b = [params[f"Conv_{i}"]["bias"] for i in range(3)]
    dense_b = [params[f"Dense_{i}"]["bias"] for i in range(2)]
    module, fused = {}, {}
    for i, (w, b) in enumerate(zip(convs, conv_b), start=1):
        module[f"conv{i}.weight"] = _f32(w.transpose(3, 2, 0, 1))
        module[f"conv{i}.bias"] = _f32(b)
        fused[f"w{i}"] = _f32(w.reshape(-1, w.shape[3]))
        fused[f"b{i}"] = _f32(b)
    for i, (w, b) in enumerate(zip(dense, dense_b), start=1):
        module[f"dense{i}.weight"] = _f32(w.T)
        module[f"dense{i}.bias"] = _f32(b)
        fused[f"wd{i}"] = _f32(w)
        fused[f"bd{i}"] = _f32(b)
    for i in range(1, 4):
        fused[f"w{i}_tc"] = tf32_fragments(fused[f"w{i}"])
    return module, fused


def _imdb(params):
    emb = params["TokenAndPositionEmbedding_0"]
    block = params["TransformerBlock_0"]
    found = [n for n in _ATTENTION_NAMES if n in block]
    if len(found) != 1:
        raise ValueError(f"bridge: want one attention subtree of {_ATTENTION_NAMES}, got {found}")
    attn = block[found[0]]
    module = {
        "embedding.token.weight": _f32(emb["Embed_0"]["embedding"]),
        "embedding.position.weight": _f32(emb["Embed_1"]["embedding"]),
    }
    for name in ("query", "key", "value"):
        w = _np(attn[name]["kernel"])
        if w.ndim != 3:
            raise ValueError(f"bridge: attention {name} kernel has shape {w.shape}")
        module[f"block.attention.{name}.weight"] = _f32(w.reshape(w.shape[0], -1).T)
        module[f"block.attention.{name}.bias"] = _f32(_np(attn[name]["bias"]).reshape(-1))
    w_out = _np(attn["out"]["kernel"])
    module["block.attention.out.weight"] = _f32(w_out.reshape(-1, w_out.shape[-1]).T)
    module["block.attention.out.bias"] = _f32(attn["out"]["bias"])
    for i in (1, 2):
        ln = block[f"LayerNorm_{i - 1}"]
        module[f"block.norm{i}.weight"] = _f32(ln["scale"])
        module[f"block.norm{i}.bias"] = _f32(ln["bias"])
        ffn = block[f"Dense_{i - 1}"]
        module[f"block.ffn{i}.weight"] = _f32(_np(ffn["kernel"]).T)
        module[f"block.ffn{i}.bias"] = _f32(ffn["bias"])
        dense = params[f"Dense_{i - 1}"]
        module[f"dense{i}.weight"] = _f32(_np(dense["kernel"]).T)
        module[f"dense{i}.bias"] = _f32(dense["bias"])
    return module, {}


def params_from_jax(params) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"module": state_dict, "fused": kernel operands}`` from a flax tree
    of any of the three families."""
    convert = {"mnist": _mnist, "cifar10": _cifar10, "imdb": _imdb}[family_of(params)]
    module, fused = convert(params)
    return {"module": module, "fused": fused}


def _sorted(tree: Dict) -> Dict:
    return {
        k: _sorted(v) if isinstance(v, dict) else np.ascontiguousarray(v)
        for k, v in sorted(tree.items())
    }


def params_to_jax(family: str, module: Union[nn.Module, Mapping[str, torch.Tensor]]) -> Dict:
    """The flax-layout numpy tree of a port module of ``family`` (or of its
    ``state_dict``): the inverse of ``params_from_jax``'s module layout.
    Conv kernels go OIHW -> HWIO, dense kernels ``[out, in]`` -> ``[in, out]``,
    and IMDB's q/k/v and out kernels unfold their head axes."""
    state = module.state_dict() if isinstance(module, nn.Module) else module
    w = {k: v.detach().cpu().numpy().astype(np.float32) for k, v in state.items()}

    def conv(name):
        return {"kernel": w[f"{name}.weight"].transpose(2, 3, 1, 0), "bias": w[f"{name}.bias"]}

    def dense(name):
        return {"kernel": w[f"{name}.weight"].T, "bias": w[f"{name}.bias"]}

    if family == "mnist":
        tree = {"Conv_0": conv("conv1"), "Conv_1": conv("conv2"), "Dense_0": dense("dense")}
    elif family == "cifar10":
        tree = {f"Conv_{i}": conv(f"conv{i + 1}") for i in range(3)}
        tree.update({f"Dense_{i}": dense(f"dense{i + 1}") for i in range(2)})
    elif family == "imdb":
        embed = w["embedding.token.weight"].shape[1]
        heads = w["block.attention.query.weight"].shape[0] // embed

        def projection(name):
            kernel = w[f"block.attention.{name}.weight"].T
            return {"kernel": kernel.reshape(kernel.shape[0], heads, -1),
                    "bias": w[f"block.attention.{name}.bias"].reshape(heads, -1)}

        out = w["block.attention.out.weight"].T
        attention = {name: projection(name) for name in ("query", "key", "value")}
        attention["out"] = {"kernel": out.reshape(heads, -1, out.shape[1]),
                            "bias": w["block.attention.out.bias"]}
        block = {_ATTENTION_NAMES[0]: attention}
        for i in (1, 2):
            block[f"LayerNorm_{i - 1}"] = {"scale": w[f"block.norm{i}.weight"],
                                           "bias": w[f"block.norm{i}.bias"]}
            block[f"Dense_{i - 1}"] = dense(f"block.ffn{i}")
        tree = {
            "TokenAndPositionEmbedding_0": {
                "Embed_0": {"embedding": w["embedding.token.weight"]},
                "Embed_1": {"embedding": w["embedding.position.weight"]},
            },
            "TransformerBlock_0": block,
            "Dense_0": dense("dense1"),
            "Dense_1": dense("dense2"),
        }
    else:
        raise ValueError(f"unknown family {family!r}; use one of {FAMILIES}")
    return _sorted(tree)


def glorot_params(seed: int, family: str = "mnist") -> Dict[str, Dict]:
    """A flax-layout tree of ``family``'s model drawn with numpy from ``seed``.

    Glorot-uniform kernels (Keras' default, as the JAX models initialise
    them; fan-in and fan-out include the receptive field, and a
    ``DenseGeneral`` kernel counts its folded head axes), U(-0.05, 0.05)
    embeddings (Keras' default), and small uniform biases and layer-norm
    offsets, so that every bias path is exercised.
    """
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}; use one of {FAMILIES}")
    rng = np.random.default_rng(seed)

    def glorot(shape, fan_in, fan_out):
        limit = np.sqrt(6.0 / (fan_in + fan_out))
        return rng.uniform(-limit, limit, size=shape).astype(np.float32)

    def small(shape, centre=0.0):
        return (centre + rng.uniform(-0.05, 0.05, size=shape)).astype(np.float32)

    def conv(c_in, c_out):
        return {"kernel": glorot((3, 3, c_in, c_out), 9 * c_in, 9 * c_out), "bias": small(c_out)}

    def dense(n_in, n_out):
        return {"kernel": glorot((n_in, n_out), n_in, n_out), "bias": small(n_out)}

    if family == "mnist":
        return {"Conv_0": conv(1, 32), "Conv_1": conv(32, 64), "Dense_0": dense(1600, 10)}
    if family == "cifar10":
        return {
            "Conv_0": conv(3, 32),
            "Conv_1": conv(32, 64),
            "Conv_2": conv(64, 64),
            "Dense_0": dense(1024, 64),
            "Dense_1": dense(64, 10),
        }

    def qkv():
        return {"kernel": glorot((32, 2, 32), 32, 64), "bias": small((2, 32))}

    return {
        "TokenAndPositionEmbedding_0": {
            "Embed_0": {"embedding": small((2000, 32))},
            "Embed_1": {"embedding": small((100, 32))},
        },
        "TransformerBlock_0": {
            "MultiHeadDotProductAttention_0": {
                "query": qkv(),
                "key": qkv(),
                "value": qkv(),
                "out": {"kernel": glorot((2, 32, 32), 64, 32), "bias": small(32)},
            },
            "LayerNorm_0": {"scale": small(32, 1.0), "bias": small(32)},
            "Dense_0": dense(32, 32),
            "Dense_1": dense(32, 32),
            "LayerNorm_1": {"scale": small(32, 1.0), "bias": small(32)},
        },
        "Dense_0": dense(32, 20),
        "Dense_1": dense(20, 2),
    }
