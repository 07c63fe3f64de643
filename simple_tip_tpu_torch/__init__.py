"""PyTorch/CUDA port of simple_tip_tpu for one NVIDIA H100 (Hopper, sm_90a).

The JAX package ``simple_tip_tpu`` stays the reference; this package
re-implements, for the MNIST and CIFAR-10 convnets and the IMDB
transformer, training (``models/train.py``, ``parallel/ensemble.py``,
``casestudies/``; checkpoints in flax's msgpack bytes, ``utils/checkpoint.py``)
and the per-phase ``test_prio`` route: predictions and uncertainties, the 12
neuron-coverage metrics with their CAM orders, and the five surprise-adequacy
variants with their surprise-coverage CAM orders (all 39 approaches), plus
the APFD table over them (``plotters/``); and the fused route of
``test_prio`` (``TIP_FUSED_CHAIN``, ``TIP_CHAIN_GROUP``: one chain program a
badge, a CUDA graph on the card, ``engine/run_program.py``); ring and
ulysses attention with the sequence sharded over ``torch.distributed``
ranks (``parallel/ring_attention.py``, ``parallel/ulysses_attention.py``)
and the multi-host full-study command (``full_study.py``). It imports torch, numpy and scipy
only, never jax, flax or anything of ``simple_tip_tpu``.

Every Pallas kernel of the JAX package has a hand-written CUDA counterpart
under ``csrc/``: the fused MNIST and CIFAR-10 forwards
(``ops/fused_forward.py``), DSA's masked nearest neighbour
(``ops/dsa_cuda.py``) and the flash-attention forward and backward
(``ops/flash_attention.py``). Every entry point takes ``device=None``, which
means the card and raises without one; ``device="cpu"`` runs each kernel's
plain PyTorch version instead.
"""
