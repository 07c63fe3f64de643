"""Resilience helpers of the port: a retry policy and a circuit breaker.

Counterparts of the JAX package's ``resilience/retry.py`` and
``resilience/breaker.py`` (same ``TIP_RETRY_*`` and ``TIP_BREAKER_*``
grammar, same breaker state file). The JAX package's fault injection, run
journal and leases are not ported. Stdlib only.
"""

from simple_tip_tpu_torch.resilience.breaker import CircuitBreaker
from simple_tip_tpu_torch.resilience.retry import RetryGiveUp, RetryPolicy

__all__ = ["CircuitBreaker", "RetryGiveUp", "RetryPolicy"]
