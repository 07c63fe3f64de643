"""Splice profiler timelines under their host obs spans.

Counterpart of the JAX package's ``obs/splice.py``. ``utils/profiling.
maybe_trace`` records, on each phase span, the ``xla_trace_dir`` its
profiler trace went to and ``xla_started_ts``, the wall-clock instant the
profiler had started (the JAX package's attribute names, kept so that one
reader splices both packages' spans). Here the trace is ``torch.profiler``'s
Chrome-trace JSON (``trace-<pid>-<n>.pt.trace.json``, gz or plain, anywhere
under the directory): host operator events and, on the card, the device's
kernel, memcpy and memset events (``cat`` ``kernel`` / ``gpu_memcpy`` /
``gpu_memset``). This module shifts that trace's own microsecond clock
onto the span clock, remaps its process ids into a reserved range so
device tracks cannot collide with host pids, and returns Chrome
``trace_event`` entries ready to merge into the host export: one Perfetto
file where each device timeline sits under the host span that captured
it.

Alignment is approximate by construction: the trace's clock origin is its
own, so its earliest event is pinned to the span's ``xla_started_ts``
(fallback: span start). That is exact enough to read "which kernels ran
inside this phase".

Stdlib only (gzip/json/os).
"""

import gzip
import json
import os

#: Synthetic pid base for spliced device tracks (host pids are real OS
#: pids, far below this).
XLA_PID_BASE = 9_000_000

#: Per-spliced-capture pid stride (one capture's internal pids stay
#: grouped and ordered).
XLA_PID_STRIDE = 1_000


def find_trace_files(trace_dir):
    """Every ``*.trace.json[.gz]`` under ``trace_dir`` (``maybe_trace``
    writes ``*.pt.trace.json``), sorted, recursive."""
    found = []
    for root, _dirs, files in os.walk(trace_dir):
        for name in files:
            if name.endswith(".trace.json") or name.endswith(".trace.json.gz"):
                found.append(os.path.join(root, name))
    return sorted(found)


def load_trace_events(path):
    """The ``traceEvents`` list of one profiler JSON (gz or plain).

    Returns ``[]`` on unreadable/unparsable files — a torn capture must
    not take the whole export down.
    """
    try:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return []
    if isinstance(doc, dict):
        evs = doc.get("traceEvents", [])
    elif isinstance(doc, list):  # bare-array trace_event files are legal
        evs = doc
    else:
        return []
    return [e for e in evs if isinstance(e, dict)]


def _xla_spans(events):
    """Host spans carrying an existing ``xla_trace_dir``, ts-ordered."""
    spans = []
    for rec in events:
        if rec.get("type") != "span":
            continue
        attrs = rec.get("attrs") or {}
        d = attrs.get("xla_trace_dir")
        if isinstance(d, str) and os.path.isdir(d):
            spans.append(rec)
    spans.sort(key=lambda r: r.get("ts") or 0)
    return spans


def splice(events, t0):
    """Spliced device trace events for the merged host ``events``.

    ``t0`` is the host export's epoch (earliest host event ts, seconds);
    returned events use the same relative-microsecond clock the host
    export emits. Returns ``(trace_events, report)`` where ``report`` is a
    list of human-readable lines (one per spliced or skipped capture).
    """
    out, report = [], []
    capture_idx = 0
    seen_files = set()
    for span_rec in _xla_spans(events):
        attrs = span_rec.get("attrs") or {}
        trace_dir = attrs["xla_trace_dir"]
        files = [
            f for f in find_trace_files(trace_dir) if f not in seen_files
        ]
        seen_files.update(files)
        if not files:
            report.append(
                f"skip {span_rec.get('name')!r}: no *.trace.json under {trace_dir}"
            )
            continue
        anchor_s = attrs.get("xla_started_ts")
        if not isinstance(anchor_s, (int, float)):
            anchor_s = span_rec.get("ts") or t0
        anchor_us = int(round((anchor_s - t0) * 1e6))
        for path in files:
            xla_events = load_trace_events(path)
            timed = [
                e for e in xla_events if isinstance(e.get("ts"), (int, float))
            ]
            if not timed:
                report.append(f"skip {os.path.basename(path)}: no timed events")
                continue
            offset = anchor_us - min(e["ts"] for e in timed)
            pid_base = XLA_PID_BASE + capture_idx * XLA_PID_STRIDE
            capture_idx += 1
            pid_map, names = {}, {}
            for e in xla_events:
                if e.get("ph") == "M" and e.get("name") == "process_name":
                    names[e.get("pid")] = (e.get("args") or {}).get("name", "")
            label = str(span_rec.get("name", "xla"))
            for e in xla_events:
                pid = e.get("pid", 0)
                new_pid = pid_map.setdefault(pid, pid_base + len(pid_map))
                if e.get("ph") == "M":
                    if e.get("name") == "process_name":
                        orig = names.get(pid) or f"pid {pid}"
                        out.append(
                            {
                                "ph": "M",
                                "name": "process_name",
                                "pid": new_pid,
                                "tid": e.get("tid", 0),
                                "args": {"name": f"xla:{label} · {orig}"},
                            }
                        )
                    else:  # thread names etc. pass through, re-pidded
                        moved = dict(e)
                        moved["pid"] = new_pid
                        out.append(moved)
                    continue
                ts = e.get("ts")
                if not isinstance(ts, (int, float)):
                    continue
                moved = dict(e)
                moved["pid"] = new_pid
                moved["ts"] = max(0, int(round(ts + offset)))
                moved.setdefault("cat", "xla")
                out.append(moved)
            report.append(
                f"spliced {os.path.basename(path)} under span "
                f"{label!r} ({len(xla_events)} events, pid base {pid_base})"
            )
    return out, report
