"""Span tracer: nested, attributed spans written as append-only JSONL.

Counterpart of the JAX package's ``obs/tracer.py``: the same knobs, record
kinds and keys, so one reader parses both packages' streams. One event
stream per process, under ``TIP_OBS_DIR``:

- unset / ``0`` / ``off``  -> disabled: ``span()`` returns a shared no-op
  context manager, no directory is made and no file written;
- ``1`` / ``auto``         -> ``$TIP_ASSETS/obs/<run_ts>/``, resolved once
  in the first process that emits and put back into ``os.environ``, so
  that child processes append into the same run directory;
- any other value          -> that directory, verbatim.

Each process owns one stream (``events-<pid>-<token>.jsonl``) opened on
the first real event; its first line is a ``meta`` event (pid, argv,
``TIP_OBS_WORKER`` / ``TIP_OBS_PLATFORM`` when set). Every write is one
``json.dumps`` line and a flush, so a crashed process leaves a file whose
complete lines all parse.

``TIP_OBS_MAX_BYTES`` caps this process's bytes on disk (default 64 MiB;
suffixes ``k``/``m``/``g``; ``0``/``off``/``unlimited`` for no cap): the
stream rotates into ``SEGMENTS`` segments, the oldest is deleted past the
cap and an ``obs.evicted`` event says how much is gone.
``TIP_OBS_SAMPLE`` (``name=N[,name=N...]``) keeps 1 in N spans of each
named span (kept spans carry ``sample_1_in: N``); the others are no-ops
whose children attach to the nearest kept ancestor. A span opened at
depth 0 parents onto the study root span whose id ``TIP_OBS_ROOT`` holds
(set by ``study_root``, in this process or a parent: children inherit the
environment).

Spans are context managers (``with span("fit", variant="dsa"):``) or
decorators (``@traced()``); nesting is tracked per thread; each span
records its wall-clock start (``time.time``), a monotonic duration
(``time.perf_counter``), its parent id, depth and attributes, and is
written on exit only. Stdlib only.
"""

import atexit
import json
import os
import secrets
import sys
import threading
import time

_lock = threading.RLock()
_local = threading.local()

#: Event-stream schema version, stamped into every stream's ``meta`` head
#: line (the JAX package's, whose readers parse these streams).
SCHEMA = 1

# Resolved lazily on first use; _State.pid lets a forked child detect that it
# inherited the parent's handle and must re-resolve (spawn re-imports anyway).
_state = None

#: Default per-process on-disk cap (64 MiB). Chosen for 100-run studies:
#: one scheduler parent + a handful of workers stays comfortably under a
#: GB even with per-badge spans sampled in.
DEFAULT_MAX_BYTES = 64 * 1024 * 1024

#: Rotation granularity: the cap is split across this many segments, so
#: eviction drops at most 1/Nth of the history at a time.
SEGMENTS = 8

#: Env var carrying the study root span id across the spawn boundary.
ROOT_ENV = "TIP_OBS_ROOT"


def _parse_max_bytes(raw: str):
    """``TIP_OBS_MAX_BYTES`` -> byte count or None (uncapped)."""
    raw = (raw or "").strip().lower()
    if not raw:
        return DEFAULT_MAX_BYTES
    if raw in ("0", "off", "unlimited", "none"):
        return None
    mult = 1
    if raw[-1] in "kmg":
        mult = {"k": 1024, "m": 1024**2, "g": 1024**3}[raw[-1]]
        raw = raw[:-1]
    try:
        n = int(float(raw) * mult)
    except ValueError:
        return DEFAULT_MAX_BYTES
    return n if n > 0 else None


def _parse_sample(raw: str) -> dict:
    """``TIP_OBS_SAMPLE`` (``name=N,name2=M``) -> {span name: keep-1-in-N}."""
    out = {}
    for part in (raw or "").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        name, _, n = part.rpartition("=")
        try:
            n = int(n)
        except ValueError:
            continue
        if name.strip() and n > 1:
            out[name.strip()] = n
    return out


class _State:
    """Per-process tracer state: resolved directory, lazy rotating stream."""

    __slots__ = (
        "enabled", "dir", "path", "fh", "pid", "next_id", "meta_written",
        "token", "seq", "cur_bytes", "segments", "max_bytes", "seg_bytes",
        "sample", "sample_counts", "evicted_segments", "evicted_bytes",
    )

    def __init__(self, enabled, directory):
        self.enabled = enabled
        self.dir = directory
        self.path = None
        self.fh = None
        self.pid = os.getpid()
        self.next_id = 0
        self.meta_written = False
        self.token = secrets.token_hex(4) if enabled else ""
        self.seq = 0
        self.cur_bytes = 0
        self.segments = []  # this process's live segment paths, oldest first
        self.max_bytes = _parse_max_bytes(os.environ.get("TIP_OBS_MAX_BYTES", "")) if enabled else None
        # Floor keeps a tiny cap from rotating on every line; the cap still
        # holds because eviction runs on segment COUNT, not byte totals.
        self.seg_bytes = (
            max(1024, self.max_bytes // SEGMENTS) if self.max_bytes else None
        )
        self.sample = _parse_sample(os.environ.get("TIP_OBS_SAMPLE", "")) if enabled else {}
        self.sample_counts = {}
        self.evicted_segments = 0
        self.evicted_bytes = 0


def _resolve():
    """Build this process's ``_State`` from ``TIP_OBS_DIR`` (see module doc)."""
    raw = os.environ.get("TIP_OBS_DIR", "").strip()
    if not raw or raw.lower() in ("0", "off"):
        return _State(False, None)
    if raw.lower() in ("1", "auto"):
        assets = os.environ.get("TIP_ASSETS", os.path.join(os.getcwd(), "assets"))
        raw = os.path.join(assets, "obs", time.strftime("%Y%m%d-%H%M%S"))
        # Children (spawned workers / pools) inherit os.environ: pinning the
        # resolved path here is what merges the whole study into one run dir.
        os.environ["TIP_OBS_DIR"] = raw
    return _State(True, os.path.abspath(raw))


def _get_state():
    """The process-wide tracer state, (re)resolved on first use or after fork."""
    global _state
    st = _state
    if st is None or st.pid != os.getpid():
        with _lock:
            st = _state
            if st is None or st.pid != os.getpid():
                st = _resolve()
                _state = st
    return st


def enabled() -> bool:
    """Whether telemetry is active for this process (``TIP_OBS_DIR`` set)."""
    return _get_state().enabled


def obs_dir():
    """The resolved event-stream directory, or None when disabled."""
    return _get_state().dir


def reset() -> None:
    """Close the stream and drop cached state so the env is re-read.

    Test/tooling hook: production processes resolve once and never reset.
    """
    global _state
    with _lock:
        if _state is not None and _state.fh is not None:
            try:
                _state.fh.close()
            except OSError:
                pass
        _state = None
        _local.__dict__.clear()


def _close_at_exit() -> None:
    """atexit hook: flush the metrics registry, then close the stream."""
    from simple_tip_tpu_torch.obs import metrics

    metrics.flush()
    st = _state
    if st is not None and st.fh is not None:
        try:
            st.fh.close()
        except OSError:
            pass
        st.fh = None


def _meta_event() -> dict:
    """The stream-head ``meta`` event stamping this process's identity."""
    worker = os.environ.get("TIP_OBS_WORKER", "").strip()
    platform = os.environ.get("TIP_OBS_PLATFORM", "").strip()
    rec = {
        "type": "meta",
        "schema": SCHEMA,
        "ts": time.time(),
        "pid": os.getpid(),
        "argv": list(sys.argv),
    }
    if worker:
        rec["worker"] = worker
    if platform:
        rec["platform"] = platform
    return rec


def _segment_name(st) -> str:
    """Filename of segment ``st.seq`` (the first keeps the legacy name)."""
    base = f"events-{st.pid}-{st.token}"
    return f"{base}.jsonl" if st.seq == 0 else f"{base}-{st.seq:03d}.jsonl"


def _open_segment(st) -> None:
    """Open the current segment file and stamp its ``meta`` head line."""
    os.makedirs(st.dir, exist_ok=True)
    st.path = os.path.join(st.dir, _segment_name(st))
    st.fh = open(st.path, "a", encoding="utf-8")
    st.segments.append(st.path)
    st.cur_bytes = 0
    line = json.dumps(_meta_event(), default=repr) + "\n"
    st.fh.write(line)
    st.cur_bytes += len(line.encode("utf-8"))
    st.meta_written = True


def _rotate(st) -> None:
    """Close the full segment, evict past the cap, open the next one."""
    try:
        st.fh.close()
    except OSError:
        pass
    st.fh = None
    st.seq += 1
    # Evict oldest segments until the live count fits the cap again. The
    # about-to-open segment counts toward the budget, hence >= SEGMENTS.
    while len(st.segments) >= SEGMENTS:
        victim = st.segments.pop(0)
        try:
            st.evicted_bytes += os.path.getsize(victim)
            os.remove(victim)
            st.evicted_segments += 1
        except OSError:
            break  # cannot evict (already gone / perms): stop trying
    _open_segment(st)
    if st.evicted_segments:
        # Self-describing truncation: the first real line after the meta
        # stamp says what the retention policy has dropped so far.
        marker = {
            "type": "event",
            "name": "obs.evicted",
            "ts": time.time(),
            "pid": st.pid,
            "tid": threading.get_ident(),
            "attrs": {
                "segments": st.evicted_segments,
                "bytes": st.evicted_bytes,
                "max_bytes": st.max_bytes,
            },
        }
        line = json.dumps(marker, default=repr) + "\n"
        st.fh.write(line)
        st.cur_bytes += len(line.encode("utf-8"))


def write(rec: dict) -> None:
    """Append one event line to this process's stream (no-op when disabled).

    Rotates into a fresh segment when the current one would exceed its
    share of ``TIP_OBS_MAX_BYTES``. Never raises: a full disk or revoked
    directory degrades telemetry to silence, not the pipeline to failure.
    """
    st = _get_state()
    if not st.enabled:
        return
    with _lock:
        try:
            if st.fh is None:
                _open_segment(st)
                atexit.register(_close_at_exit)
            line = json.dumps(rec, default=repr) + "\n"
            nbytes = len(line.encode("utf-8"))
            if st.seg_bytes is not None and st.cur_bytes + nbytes > st.seg_bytes:
                _rotate(st)
            st.fh.write(line)
            st.cur_bytes += nbytes
            st.fh.flush()
        except OSError:
            # Telemetry must never take the instrumented pipeline down.
            st.enabled = False


def _span_stack():
    """This thread's open-span stack (span ids)."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _new_span_id(st) -> str:
    """Process-unique span id (``pid:n``)."""
    with _lock:
        st.next_id += 1
        return f"{st.pid}:{st.next_id}"


class _NoopSpan:
    """Shared do-nothing span for the disabled path (near-zero overhead)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        """Ignore attribute updates on the disabled path."""
        return self


_NOOP = _NoopSpan()


class Span:
    """One live span: records wall start, monotonic duration, nesting."""

    __slots__ = ("name", "attrs", "_id", "_parent", "_depth", "_t0", "_wall")

    def __init__(self, name, attrs):
        self.name = name
        self.attrs = attrs

    def set(self, **attrs):
        """Attach/overwrite attributes while the span is open."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        st = _get_state()
        stack = _span_stack()
        self._id = _new_span_id(st)
        if stack:
            self._parent = stack[-1]
            self._depth = len(stack)
        else:
            # Stack-root span: attach under the study root pinned into the
            # environment (by study_root, possibly in
            # another process: children inherit os.environ), so top spans
            # merge into one study tree.
            root = os.environ.get(ROOT_ENV, "").strip() or None
            self._parent = root if root != self._id else None
            self._depth = 1 if self._parent else 0
        stack.append(self._id)
        self._wall = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        dur = time.perf_counter() - self._t0
        stack = _span_stack()
        if stack and stack[-1] == self._id:
            stack.pop()
        rec = {
            "type": "span",
            "name": self.name,
            "ts": self._wall,
            "dur": dur,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "id": self._id,
            "depth": self._depth,
        }
        if self._parent is not None:
            rec["parent"] = self._parent
        if exc_type is not None:
            rec["error"] = repr(exc_val)
        if self.attrs:
            rec["attrs"] = self.attrs
        write(rec)
        return False


class _RootSpan(Span):
    """The study root span: pins its id into the env for every child process."""

    __slots__ = ("_prev_root",)

    def __enter__(self):
        self._prev_root = os.environ.get(ROOT_ENV)
        super().__enter__()
        os.environ[ROOT_ENV] = self._id
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        # Un-pin only our own id: a crashed inner study must not clear an
        # outer root's pin.
        if os.environ.get(ROOT_ENV) == self._id:
            if self._prev_root is None:
                os.environ.pop(ROOT_ENV, None)
            else:
                os.environ[ROOT_ENV] = self._prev_root
        return super().__exit__(exc_type, exc_val, exc_tb)


def study_root(name: str = "study", **attrs):
    """Open the study-level root span and export its id to child processes.

    Every span later opened at stack depth 0, in this process or any
    spawned child that inherits the environment, parents onto this span, so
    a whole multi-phase, multi-worker study merges into one tree. No-op when
    telemetry is disabled.
    """
    if not _get_state().enabled:
        return _NOOP
    attrs.setdefault("kind", "study_root")
    return _RootSpan(name, attrs)


def span(name: str, **attrs):
    """A context-manager span; the shared no-op when telemetry is disabled.

    With ``TIP_OBS_SAMPLE`` naming this span, only 1-in-N occurrences are
    recorded (kept spans carry ``sample_1_in: N``); the rest are full
    no-ops whose children attach to the nearest kept ancestor.
    """
    st = _get_state()
    if not st.enabled:
        return _NOOP
    rate = st.sample.get(name)
    if rate is not None:
        with _lock:
            count = st.sample_counts.get(name, 0)
            st.sample_counts[name] = count + 1
        if count % rate:
            return _NOOP
        attrs.setdefault("sample_1_in", rate)
    return Span(name, attrs)


def traced(name=None, **attrs):
    """Decorator form of ``span`` (span name defaults to the qualname)."""

    def deco(fn):
        label = name or fn.__qualname__

        def wrapper(*args, **kwargs):
            with span(label, **attrs):
                return fn(*args, **kwargs)

        wrapper.__name__ = fn.__name__
        wrapper.__doc__ = fn.__doc__
        wrapper.__qualname__ = fn.__qualname__
        wrapper.__wrapped__ = fn
        return wrapper

    return deco


def event(name: str, **attrs) -> None:
    """One instantaneous lifecycle event (scheduler announce/done/requeue...)."""
    if not _get_state().enabled:
        return
    rec = {
        "type": "event",
        "name": name,
        "ts": time.time(),
        "pid": os.getpid(),
        "tid": threading.get_ident(),
    }
    if attrs:
        rec["attrs"] = attrs
    write(rec)


def record_span(name: str, wall_start: float, dur: float, **attrs) -> None:
    """Record an externally-timed span (the ``Timer`` mirror path).

    The caller owns the measurement (``wall_start`` from ``time.time``,
    ``dur`` in seconds); nesting attaches to this thread's current open span.
    """
    st = _get_state()
    if not st.enabled:
        return
    stack = _span_stack()
    span_id = _new_span_id(st)
    parent = stack[-1] if stack else (
        os.environ.get(ROOT_ENV, "").strip() or None
    )
    rec = {
        "type": "span",
        "name": name,
        "ts": wall_start,
        "dur": dur,
        "pid": os.getpid(),
        "tid": threading.get_ident(),
        "id": span_id,
        "depth": len(stack) if stack else (1 if parent else 0),
    }
    if parent is not None and parent != span_id:
        rec["parent"] = parent
    if attrs:
        rec["attrs"] = attrs
    write(rec)
