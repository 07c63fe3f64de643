"""Training across models on one card (the ensemble of independent runs),
the shared asyncio loop thread that sync callers drive the scoring engine
through (``aio``), the run scheduler and fleet, sequence-parallel attention
over ``torch.distributed`` (``ring_attention``, ``ulysses_attention``,
their ``exchange``) and the multi-process helpers (``distributed``)."""

from simple_tip_tpu_torch.parallel.aio import LoopThread, shared_loop

__all__ = ["LoopThread", "shared_loop"]
