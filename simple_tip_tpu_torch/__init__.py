"""PyTorch/CUDA port of simple_tip_tpu for one NVIDIA H100 (Hopper, sm_90a).

The JAX package ``simple_tip_tpu`` stays the reference; this package
re-implements, for the MNIST and CIFAR-10 convnets and the IMDB
transformer, training (``models/train.py``, ``parallel/ensemble.py``,
``casestudies/``; checkpoints in flax's msgpack bytes, ``utils/checkpoint.py``)
and the per-phase ``test_prio`` route: predictions and uncertainties, the 12
neuron-coverage metrics with their CAM orders, and the five surprise-adequacy
variants with their surprise-coverage CAM orders (all 39 approaches), plus
the APFD table over them (``plotters/``). It imports torch, numpy and scipy
only, never jax, flax or anything of ``simple_tip_tpu``.

Every Pallas kernel of the JAX package has a hand-written CUDA counterpart
under ``csrc/``: the fused MNIST and CIFAR-10 forwards
(``ops/fused_forward.py``), DSA's masked nearest neighbour
(``ops/dsa_cuda.py``) and the flash-attention forward and backward
(``ops/flash_attention.py``). Every entry point takes ``device=None``, which
means the card and raises without one; ``device="cpu"`` runs each kernel's
plain PyTorch version instead.
"""
