"""Open-loop load generator for the scoring engine.

Counterpart of the JAX package's ``serving/loadgen.py``. Drives the engine
at a target arrival rate (open loop: submissions follow the clock, not the
responses, the shape that shows queueing collapse) and reports sustained
inputs/s, p50/p95/p99 request latency, mean badge fill and shed / error
counts. Requests may differ in size (``make_rows(i)`` decides): the rate
spaces them by ``rows_per_request``, their mean, and the sustained rate
counts the rows of the answered ones. Stdlib only.
"""

import asyncio
from typing import Callable, List, Optional, Sequence

from simple_tip_tpu_torch import obs
from simple_tip_tpu_torch.serving.errors import ServingError


def percentile(values: Sequence[float], q: float):
    """Nearest-rank percentile ``q`` (0..100), or None on empty input.

    Same definition as ``obs.metrics.Quantile.percentile`` so the loadgen
    report and the live SLO telemetry cannot disagree on a quantile.
    """
    if not values:
        return None
    window = sorted(values)
    rank = max(1, -(-int(q) * len(window) // 100))  # ceil(q*n/100)
    return window[min(rank, len(window)) - 1]


async def drive(
    engine,
    model,
    make_rows: Callable[[int], Sequence],
    n_requests: int,
    rows_per_request: int,
    arrival_rows_per_s: float,
    on_response: Optional[Callable[[int, object], None]] = None,
) -> dict:
    """Open-loop run: ``n_requests`` of ``rows_per_request`` rows (on
    average) at the target arrival rate; returns the measured SLO dict.

    ``make_rows(i)`` builds request ``i``'s row block (seeded by the
    caller for determinism); ``on_response(i, response)`` sees each
    answered request. Sheds and backend errors are counted, never raised:
    overload behaviour is the measurement.
    """
    loop = asyncio.get_running_loop()
    interval = (
        rows_per_request / arrival_rows_per_s if arrival_rows_per_s > 0 else 0.0
    )
    fill0 = obs.metrics_snapshot()["histograms"].get("serving.badge_fill") or {
        "count": 0,
        "sum": 0.0,
    }
    latencies_ms: List[float] = []
    outcomes = {"ok": 0, "shed": 0, "error": 0, "ok_rows": 0}
    t_start = loop.time()

    async def one(i: int, t_target: float):
        delay = t_target - loop.time()
        if delay > 0:
            await asyncio.sleep(delay)
        t0 = loop.time()
        rows = make_rows(i)
        try:
            response = await engine.score(model, rows)
        except ServingError:
            outcomes["shed"] += 1
            return
        except Exception:  # noqa: BLE001 — measured, not raised
            outcomes["error"] += 1
            return
        outcomes["ok"] += 1
        outcomes["ok_rows"] += len(rows)
        latencies_ms.append((loop.time() - t0) * 1000.0)
        if on_response is not None:
            on_response(i, response)

    await asyncio.gather(
        *(one(i, t_start + i * interval) for i in range(n_requests))
    )
    elapsed = max(loop.time() - t_start, 1e-9)
    fill1 = obs.metrics_snapshot()["histograms"].get("serving.badge_fill") or {
        "count": 0,
        "sum": 0.0,
    }
    n_badges = fill1["count"] - fill0["count"]
    fill = (
        (fill1["sum"] - fill0["sum"]) / n_badges if n_badges > 0 else None
    )
    return {
        "requests": n_requests,
        "rows_per_request": rows_per_request,
        "arrival_rows_per_s": round(arrival_rows_per_s, 1),
        "sustained_inputs_per_s": round(
            outcomes["ok_rows"] / elapsed, 1
        ),
        "ok": outcomes["ok"],
        "shed": outcomes["shed"],
        "errors": outcomes["error"],
        "p50_ms": percentile(latencies_ms, 50),
        "p95_ms": percentile(latencies_ms, 95),
        "p99_ms": percentile(latencies_ms, 99),
        "badge_fill": round(fill, 4) if fill is not None else None,
        "badges": n_badges,
        "elapsed_s": round(elapsed, 4),
    }
