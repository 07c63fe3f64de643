"""Utilities of the port: profiling hooks (``maybe_trace``), the analytic
FLOPs counts, the flax msgpack checkpoint codec and artifact checks."""

from simple_tip_tpu_torch.utils.profiling import maybe_trace

__all__ = ["maybe_trace"]
