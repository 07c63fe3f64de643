"""Continuous batcher: per-model queues coalescing into fixed badge shapes.

Counterpart of the JAX package's ``serving/batcher.py``, with the same
policy. A plain data structure (no clocks, no asyncio, no torch), so the
policy is testable with synthetic timestamps; the engine feeds it
``loop.time()`` values.

- a model's queue is **ready** when it holds a full badge of rows, or when
  its oldest chunk has waited past the flush deadline (a partial badge is
  padded, and the chain program's ``valid`` count masks the padding);
- badge assembly pops whole chunks while they fit; chunks never split, and
  the engine caps each chunk at ``max_badge`` rows on submit;
- model selection is **fair round-robin**: the rotation pointer advances
  past each served model, so a tenant with a deep queue cannot starve one
  with a shallow queue.
"""

from collections import deque
from typing import Dict, List, Optional

from simple_tip_tpu_torch import obs


class Chunk:
    """One contiguous block of rows from one request.

    ``request`` is an opaque engine-side handle (the batcher only uses its
    IDENTITY, for whole-request eviction) and ``index`` the chunk's
    position within it; ``rows`` is the payload block; ``t_enqueue`` the
    caller-supplied enqueue timestamp driving the flush deadline.
    """

    __slots__ = ("request", "index", "rows", "n", "t_enqueue")

    def __init__(self, request, index: int, rows, n: int, t_enqueue: float):
        self.request = request
        self.index = int(index)
        self.rows = rows
        self.n = int(n)
        self.t_enqueue = float(t_enqueue)


class Badge:
    """One assembled dispatch unit: chunks, row count, and fill ratio.

    ``request_ids`` collects the distinct request ids riding the badge
    (in chunk order) when the opaque request handles carry one — the
    engine stamps them on the dispatch span so a request's admission
    event and its badge correlate by id. Handles without the attribute
    (tests driving the batcher directly) simply contribute nothing.
    """

    __slots__ = ("model", "chunks", "rows", "fill", "request_ids")

    def __init__(self, model, chunks: List[Chunk], max_badge: int):
        self.model = model
        self.chunks = chunks
        self.rows = sum(c.n for c in chunks)
        self.fill = self.rows / float(max_badge)
        seen = set()
        self.request_ids: List[str] = []
        for c in chunks:
            rid = getattr(c.request, "request_id", None)
            if rid and rid not in seen:
                seen.add(rid)
                self.request_ids.append(rid)


class ContinuousBatcher:
    """Per-model chunk queues + the badge-readiness/fairness policy."""

    def __init__(self, max_badge: int, flush_deadline_s: float):
        self.max_badge = int(max_badge)
        self.flush_deadline_s = float(flush_deadline_s)
        self._queues: Dict[object, deque] = {}
        self._rows: Dict[object, int] = {}
        self._rotation: List[object] = []
        self._next = 0

    # -- enqueue -------------------------------------------------------------

    def add_model(self, model) -> None:
        """Register ``model`` in the rotation (idempotent)."""
        if model not in self._queues:
            self._queues[model] = deque()
            self._rows[model] = 0
            self._rotation.append(model)

    def push(self, model, chunk: Chunk) -> None:
        """Queue one chunk for ``model`` (which must be registered)."""
        if chunk.n > self.max_badge:
            raise ValueError(
                f"chunk of {chunk.n} rows exceeds the {self.max_badge}-row badge"
            )
        self._queues[model].append(chunk)
        self._rows[model] += chunk.n
        obs.gauge("serving.queue_rows").set(self.total_rows())

    # -- introspection -------------------------------------------------------

    def pending_rows(self, model=None) -> int:
        """Queued rows for ``model``, or across all models when None."""
        if model is not None:
            return self._rows.get(model, 0)
        return self.total_rows()

    def total_rows(self) -> int:
        """Queued rows across every model."""
        return sum(self._rows.values())

    def next_deadline(self) -> Optional[float]:
        """Earliest absolute flush time across queues, or None when empty."""
        deadlines = [
            q[0].t_enqueue + self.flush_deadline_s
            for q in self._queues.values()
            if q
        ]
        return min(deadlines) if deadlines else None

    # -- badge assembly ------------------------------------------------------

    def take_ready(self, now: float, force: bool = False) -> Optional[Badge]:
        """Pop the next ready badge under the fairness rotation, or None.

        Ready = a full badge of rows queued, the oldest chunk past the
        flush deadline, or ``force`` (engine drain). The rotation pointer
        advances past the served model so repeated calls interleave
        tenants.
        """
        n_models = len(self._rotation)
        for i in range(n_models):
            model = self._rotation[(self._next + i) % n_models]
            q = self._queues[model]
            if not q:
                continue
            full = self._rows[model] >= self.max_badge
            expired = (now - q[0].t_enqueue) >= self.flush_deadline_s
            if not (full or expired or force):
                continue
            chunks: List[Chunk] = []
            total = 0
            while q and total + q[0].n <= self.max_badge:
                chunk = q.popleft()
                chunks.append(chunk)
                total += chunk.n
            self._rows[model] -= total
            self._next = (self._next + i + 1) % n_models
            obs.gauge("serving.queue_rows").set(self.total_rows())
            return Badge(model, chunks, self.max_badge)
        return None

    # -- shedding / drain ----------------------------------------------------

    def evict_oldest(self, model) -> List[Chunk]:
        """Pop every queued chunk of ``model``'s OLDEST request
        (``shed_mode=oldest``: the engine fails that request to admit a new
        one). Returns the evicted chunks ([] when the queue is empty)."""
        q = self._queues.get(model)
        if not q:
            return []
        victim = q[0].request
        kept, evicted = deque(), []
        for chunk in q:
            (evicted if chunk.request is victim else kept).append(chunk)
        self._queues[model] = kept
        self._rows[model] -= sum(c.n for c in evicted)
        obs.gauge("serving.queue_rows").set(self.total_rows())
        return evicted

    def drain(self) -> List[Chunk]:
        """Pop EVERY queued chunk (engine close: fail them explicitly)."""
        out: List[Chunk] = []
        for model in self._rotation:
            out.extend(self._queues[model])
            self._queues[model].clear()
            self._rows[model] = 0
        obs.gauge("serving.queue_rows").set(0)
        return out
