"""Training across models on one card (the ensemble of independent runs),
and the shared asyncio loop thread that sync callers drive the scoring
engine through (``aio``)."""

from simple_tip_tpu_torch.parallel.aio import LoopThread, shared_loop

__all__ = ["LoopThread", "shared_loop"]
