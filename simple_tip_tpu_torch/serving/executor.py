"""Badge executors: the warm pool of chain programs and a stub.

Counterpart of the JAX package's ``serving/executor.py``. The executor is
the scoring engine's only backend-facing surface:

- ``register_model(key, badge_size, **spec)`` resolves everything up front
  (a request never pays a capture);
- ``run_badge(key, segments)`` scores one badge assembled from the given
  row segments and returns one result per segment, in order; it is called
  from worker threads;
- ``merge(parts)`` joins one request's per-chunk results.

``StubExecutor`` is stdlib only, so the batching, admission and resilience
paths are testable without a model. ``FusedChainExecutor`` is the real
backend: one ``FusedChainRunner`` and its chain program (a CUDA graph on
the card) per registered model; it imports numpy, torch and the engine
when it is built, as the JAX package's imports jax.
"""

import threading
import time
from typing import Dict, List, Sequence

from simple_tip_tpu_torch import obs


class StubExecutor:
    """In-process fake backend: per-row ``fn``, optional delay and faults.

    ``delay_s`` simulates badge dispatch time (``time.sleep`` in a worker
    thread — sync context by design); ``fail_first`` makes the first N
    ``run_badge`` calls raise ``OSError`` (the default-transient type, so
    retry/breaker paths are exercisable without a real outage).
    """

    def __init__(self, delay_s: float = 0.0, fail_first: int = 0):
        self.delay_s = float(delay_s)
        self._fail_remaining = int(fail_first)
        self._fns: Dict[object, object] = {}
        self.badge_log: List[object] = []  # model key per run_badge, in order
        self._lock = threading.Lock()

    def register_model(self, key, badge_size: int, fn=None) -> None:
        """Register ``key`` with a per-row scoring callable (default: sum)."""
        self._fns[key] = fn if fn is not None else (lambda row: sum(row))

    def run_badge(self, key, segments: Sequence[Sequence]) -> List[list]:
        """Score one badge; returns one list of per-row values per segment."""
        with self._lock:
            if self._fail_remaining > 0:
                self._fail_remaining -= 1
                raise OSError("injected stub backend fault")
            self.badge_log.append(key)
        if self.delay_s:
            time.sleep(self.delay_s)
        fn = self._fns[key]
        return [[fn(row) for row in seg] for seg in segments]

    @staticmethod
    def merge(parts: List[list]) -> list:
        """Concatenate per-chunk row-value lists into one response list."""
        return [v for part in parts for v in part]


class _WarmModel:
    """One registered model's runner, chain program and host staging badge."""

    __slots__ = ("runner", "program", "staging", "badge_size")

    def __init__(self, runner, program, staging, badge_size: int):
        self.runner = runner
        self.program = program
        self.staging = staging
        self.badge_size = badge_size


class FusedChainExecutor:
    """Warm pool of per-model chain programs behind the executor API.

    Registration builds a ``FusedChainRunner`` (training statistics, metric
    setup) and resolves its badge-shaped chain program at once: on the card
    the CUDA graph is captured in the register call, never in a request.
    The program's badge buffer takes the layout of ``layout_like``'s rows
    (default: the training set's) as the offline walk lays out its set
    (``badge_layout``): on the card, a one-channel image set's channel
    stride picks cuDNN's algorithms, and with them bits of the coverage
    profiles.

    A program has one set of input buffers and static outputs, and the
    process shares it between runners of one fingerprint, so a dispatch
    holds the program's lock from binding the runner's weights through
    reading the outputs back to the host; and it holds ``DEVICE_GATE``
    shared, so that no capture (of another model being registered) runs
    while it touches the card. Rows are uploaded as the offline walk
    uploads them (``to_device``: integers as int64, the rest as float32)
    and the padding rows are zeroed, so a row's outputs are the offline
    walk's, whichever co-riders shared its badge.

    The JAX executor's program cache and sharding arguments are not
    ported: programs live in this process, on one card. ``device`` is the
    card by default and ``"cpu"`` for the plain versions.
    """

    def __init__(self, device=None):
        from simple_tip_tpu_torch.device import resolve

        self.device = resolve(device)
        self._models: Dict[object, _WarmModel] = {}
        self._lock = threading.Lock()
        #: badges run per model key
        self.dispatches: Dict[object, int] = {}

    def register_model(
        self,
        key,
        badge_size: int,
        model_def=None,
        params=None,
        training_set=None,
        nc_layers=None,
        batch_size: int = 32,
        layout_like=None,
    ) -> None:
        """Build and warm one model's chain program (idempotent per key).

        ``params`` is the bridge's output for ``model_def``; ``layout_like``
        is an array whose rows the requests' rows are laid out like.
        """
        with self._lock:
            already = self._models.get(key)
            if already is not None and already.badge_size == int(badge_size):
                return  # warm already: a re-register must not capture again

        import numpy as np
        import torch

        from simple_tip_tpu_torch.engine.run_program import FusedChainRunner, badge_layout

        with obs.span("serving.register", model=str(key), badge=int(badge_size)):
            runner = FusedChainRunner(
                model_def, params, training_set, nc_layers, batch_size=batch_size,
                badge_size=int(badge_size), device=self.device,
            )
            sample = np.asarray(training_set if layout_like is None else layout_like)
            shape, dtype, strides = badge_layout(sample, int(badge_size), self.device)
            program = runner.chain_program(shape, dtype, strides)
            staging = torch.zeros(shape, dtype=dtype)
            if self.device.type == "cuda":
                staging = staging.pin_memory()
        with self._lock:
            self._models[key] = _WarmModel(runner, program, staging, int(badge_size))
            self.dispatches.setdefault(key, 0)

    def runner(self, key):
        """The registered model's ``FusedChainRunner`` (its offline walk)."""
        return self._models[key].runner

    def program(self, key):
        """The registered model's chain program (``recorded``: the kernel
        launches one replay makes)."""
        return self._models[key].program

    def run_badge(self, key, segments: Sequence) -> List[dict]:
        """One chain dispatch over the badge assembled from ``segments``.

        Returns per-segment dicts of host ``pred`` / ``uncertainties`` /
        ``scores`` slices; padding rows are computed but never returned.
        """
        import numpy as np
        import torch

        from simple_tip_tpu_torch.engine.run_program import DEVICE_GATE

        m = self._models[key]
        rows = [np.ascontiguousarray(seg, dtype=_upload_dtype(seg)) for seg in segments]
        n = sum(r.shape[0] for r in rows)
        if n > m.badge_size:
            raise ValueError(f"badge overflow: {n} rows into a {m.badge_size}-row program")
        prog = m.program
        with DEVICE_GATE.shared(), prog.lock:
            m.runner.bind(prog)
            _, x_buf, valid = prog.args
            off = 0
            for r in rows:
                m.staging[off : off + r.shape[0]].copy_(torch.from_numpy(r))
                off += r.shape[0]
            m.staging[off:].zero_()  # zero is a valid token id; valid masks it
            x_buf.copy_(m.staging)
            valid.fill_(n)
            pred_d, unc_d, cov_d = prog()
            pred = pred_d.cpu().numpy().copy()
            unc = {name: u.cpu().numpy().copy() for name, u in unc_d.items()}
            scores = {mid: s.cpu().numpy().copy() for mid, (s, _) in cov_d.items()}
        with self._lock:
            self.dispatches[key] += 1
        obs.counter("serving.chain_dispatches").inc()
        out, off = [], 0
        for r in rows:
            sl = slice(off, off + r.shape[0])
            out.append({
                "pred": pred[sl].copy(),
                "uncertainties": {k: v[sl].copy() for k, v in unc.items()},
                "scores": {k: v[sl].copy() for k, v in scores.items()},
            })
            off += r.shape[0]
        return out

    @staticmethod
    def merge(parts: List[dict]) -> dict:
        """Concatenate per-chunk field arrays into one request response."""
        import numpy as np

        if len(parts) == 1:
            return parts[0]
        return {
            "pred": np.concatenate([p["pred"] for p in parts]),
            "uncertainties": {
                k: np.concatenate([p["uncertainties"][k] for p in parts])
                for k in parts[0]["uncertainties"]
            },
            "scores": {
                k: np.concatenate([p["scores"][k] for p in parts])
                for k in parts[0]["scores"]
            },
        }


def _upload_dtype(rows) -> type:
    """The dtype ``to_device`` uploads ``rows`` as: int64 for integers
    (token ids), float32 for everything else."""
    import numpy as np

    return np.int64 if np.issubdtype(np.asarray(rows).dtype, np.integer) else np.float32
