"""The port's online scoring service: continuous batching over chain programs.

Counterpart of the JAX package's ``serving`` package, over the port's
``engine/run_program.py``:

- **continuous batcher** (``batcher``): in-flight requests coalesce into
  the one padded badge shape a model's chain program was captured for; a
  partial badge is masked by the program's ``valid`` count, and a flush
  deadline bounds how long a lonely request waits for co-riders;
- **warm pool** (``executor``): per-model ``FusedChainRunner`` programs
  resolved (on the card: CUDA graphs captured) at register time;
- **multi-tenant routing** (``engine``): per-model queues with fair
  round-robin badge scheduling;
- **admission control and shedding** (``admission``): a row bound and a
  predicted-backlog bound from the live badge-time EWMA, the circuit
  breaker in front of the backend, typed ``RequestShed`` rejections;
- **SLO telemetry** through ``obs``: p50/p95/p99 request latency, badge
  fill, queue depth and sheds.

A row's outputs do not depend on the badge it rode in (the chain is row
independent and the padding is masked), so online scores are the offline
walk's, byte for byte.

From Python::

    from simple_tip_tpu_torch.parallel import shared_loop
    from simple_tip_tpu_torch.serving import (
        FusedChainExecutor, ScoringEngine, ServingKnobs)

    engine = ScoringEngine(FusedChainExecutor(device=None),  # "cpu" for the CPU
                           ServingKnobs(max_badge=512, flush_deadline_s=0.005))
    engine.register_model("mnist/0", model_def=MnistConvNet(), params=params,
                          training_set=x_train, nc_layers=[0, 1, 2, 3])
    loop = shared_loop()
    loop.run(engine.start())
    response = loop.run(engine.score("mnist/0", x_test[:100]))
    loop.run(engine.close())

Env knobs: ``TIP_SERVE_MAX_BADGE``, ``TIP_SERVE_FLUSH_DEADLINE_MS``,
``TIP_SERVE_QUEUE_BOUND``, ``TIP_SERVE_SHED_MODE``, ``TIP_SERVE_INFLIGHT``,
``TIP_SERVE_MAX_BACKLOG_S`` (``knobs``).
"""

from simple_tip_tpu_torch.serving.admission import AdmissionController
from simple_tip_tpu_torch.serving.batcher import Chunk, ContinuousBatcher
from simple_tip_tpu_torch.serving.engine import ScoringEngine
from simple_tip_tpu_torch.serving.errors import (
    BackendDown,
    EngineClosed,
    RequestShed,
    ServingError,
)
from simple_tip_tpu_torch.serving.executor import StubExecutor
from simple_tip_tpu_torch.serving.knobs import ServingKnobs

_LAZY_EXPORTS = {
    "FusedChainExecutor": "executor",
    "drive": "loadgen",
}

__all__ = [
    "AdmissionController",
    "BackendDown",
    "Chunk",
    "ContinuousBatcher",
    "EngineClosed",
    "FusedChainExecutor",
    "RequestShed",
    "ScoringEngine",
    "ServingError",
    "ServingKnobs",
    "StubExecutor",
    "drive",
]


def __getattr__(name):
    """Lazy re-exports (``FusedChainExecutor`` and ``drive``)."""
    from importlib import import_module

    if name in _LAZY_EXPORTS:
        return getattr(
            import_module(f"simple_tip_tpu_torch.serving.{_LAZY_EXPORTS[name]}"), name
        )
    raise AttributeError(f"module 'simple_tip_tpu_torch.serving' has no attribute {name!r}")


def __dir__():
    """Make the lazy exports visible to dir() and tab completion."""
    return sorted(list(globals()) + list(_LAZY_EXPORTS))
