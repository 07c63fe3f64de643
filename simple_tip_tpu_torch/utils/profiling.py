"""Profiling hooks: ``maybe_trace(label)``.

Counterpart of the JAX package's ``utils/profiling.py``, with two optional
capture planes:

- set ``TIP_OBS_DIR`` (``simple_tip_tpu_torch/obs``) and every
  ``maybe_trace`` phase is an obs span with ``kind="phase"``;
- set ``TIP_PROFILE_DIR`` to also run a ``torch.profiler.profile`` (CPU and
  CUDA activities) around the phase and write its Chrome trace to
  ``TIP_PROFILE_DIR/<label>/trace-<pid>-<n>.pt.trace.json`` (viewable in
  Perfetto).

With neither set, ``maybe_trace`` is a no-op context manager.

The span keeps the JAX package's attribute names, so that the feature store
and ``obs/splice.py`` read both packages' spans: ``xla_trace_dir`` is the
directory the profiler trace went to (here a ``torch.profiler`` Chrome
trace, not an XLA capture), and ``xla_started_ts`` the wall-clock instant
stamped inside the profiler context, after its start-up: the anchor the
splice shifts the trace's own microsecond clock onto.
"""

import contextlib
import itertools
import os
import time

from simple_tip_tpu_torch import obs

_COUNT = itertools.count()


@contextlib.contextmanager
def maybe_trace(label: str):
    """Context manager: obs span when TIP_OBS_DIR is set, plus a
    ``torch.profiler`` trace when TIP_PROFILE_DIR is set."""
    profile_dir = os.environ.get("TIP_PROFILE_DIR")
    span_attrs = {"kind": "phase"}
    if profile_dir:
        span_attrs["xla_trace_dir"] = os.path.join(profile_dir, label)
    with obs.span(label, **span_attrs) as sp:
        if not profile_dir:
            yield
            return
        import torch

        out = os.path.join(profile_dir, label)
        os.makedirs(out, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            # Stamped inside the profiler context: the splice anchors the
            # trace here, past the profiler's own start-up.
            sp.set(xla_started_ts=time.time())
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        prof.export_chrome_trace(
            os.path.join(out, f"trace-{os.getpid()}-{next(_COUNT)}.pt.trace.json")
        )
