"""Atomic writes for artifacts and cache entries, and the sweep of their orphans.

Own copy of the JAX package's ``utils/artifacts_io.py``:
``atomic_write_bytes`` writes ``<path>.<pid>.tmp``, fsyncs it and renames it
over ``path``, so a reader (or another process sharing a cache directory)
sees the old file or the new one, never part of one. A process killed
between the write and the rename leaves its tmp behind; ``sweep_orphan_tmp``
removes such files once they are older than an hour
(``TIP_TMP_SWEEP_AGE_S``, counted in ``artifacts.tmp_swept``), and matches
only the ``.<pid>.tmp`` shape, so it never touches another program's file.

Fault seam ``artifact.write`` (``resilience/faults.py``): a ``torn`` fault
writes half the payload to the tmp file and raises ``InjectedFault`` (the
tmp is removed, the destination untouched); a ``kill`` fault writes half
and exits the process before the rename.
"""

import logging
import os
import re
import time

logger = logging.getLogger(__name__)

#: The tmp name of every atomic writer: ``<base>.<pid>.tmp``.
_ORPHAN_TMP_RE = re.compile(r"\.\d+\.tmp$")

#: Age past which a tmp file is a kill's leftover and not a live writer's.
DEFAULT_TMP_SWEEP_AGE_S = 3600.0


def sweep_orphan_tmp(directory: str, max_age_s: float = None) -> int:
    """Remove ``*.<pid>.tmp`` files older than ``max_age_s`` (default
    ``TIP_TMP_SWEEP_AGE_S``, else 3600 s) from ``directory`` itself, not its
    subdirectories. Returns how many were removed."""
    if max_age_s is None:
        raw = os.environ.get("TIP_TMP_SWEEP_AGE_S", "").strip()
        try:
            max_age_s = float(raw) if raw else DEFAULT_TMP_SWEEP_AGE_S
        except ValueError:
            max_age_s = DEFAULT_TMP_SWEEP_AGE_S
    try:
        names = os.listdir(directory)
    except OSError:
        return 0
    removed = 0
    now = time.time()
    for name in names:
        if not _ORPHAN_TMP_RE.search(name):
            continue
        path = os.path.join(directory, name)
        try:
            if now - os.stat(path).st_mtime < max_age_s:
                continue
            os.remove(path)
            removed += 1
        except OSError:
            continue  # raced another sweep or writer
    if removed:
        from simple_tip_tpu_torch import obs

        obs.counter("artifacts.tmp_swept").inc(removed)
        logger.info("swept %d orphan tmp file(s) from %s", removed, directory)
    return removed


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` through ``<path>.<pid>.tmp``: write, fsync,
    rename. On any failure the tmp is removed and ``path`` is untouched."""
    from simple_tip_tpu_torch.resilience import faults

    tmp = f"{path}.{os.getpid()}.tmp"
    fault = faults.maybe_inject("artifact.write", path=path)
    torn = fault is not None and fault.kind in ("torn", "kill")
    try:
        with open(tmp, "wb") as f:
            if torn:
                f.write(data[: max(1, len(data) // 2)])
                f.flush()
                os.fsync(f.fileno())
                if fault.kind == "kill":
                    os._exit(1)  # the process dies mid-write
                raise faults.InjectedFault(f"torn write injected for {path}")
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
