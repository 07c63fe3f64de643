"""PyTorch/CUDA port of simple_tip_tpu for one NVIDIA H100 (Hopper, sm_90a).

The JAX package ``simple_tip_tpu`` stays the reference; this package
re-implements its per-phase ``test_prio`` route for the MNIST convnet:
predictions and uncertainties, the 12 neuron-coverage metrics with their
CAM orders, and DSA with its surprise-coverage CAM order. It imports torch
and numpy only, never jax, flax or anything of ``simple_tip_tpu``.

The two Pallas kernels on that route have hand-written CUDA counterparts
under ``csrc/``: the fused MNIST forward (``ops/fused_forward.py``) and DSA's
masked nearest neighbour (``ops/dsa_cuda.py``). Every entry point takes
``device=None``, which means the card and raises without one;
``device="cpu"`` runs each kernel's plain PyTorch version instead.
"""
