"""Crash-safe resume journal of completed (case study, phase, run) units.

Counterpart of the JAX package's ``resilience/journal.py``, with its path,
line format and rules, so both packages read and append one journal on one
``TIP_ASSETS``: every run a scheduled phase completes appends one JSON line
(``case_study``, ``phase``, ``model_id``, ``ts``, ``pid`` and, in fleet
mode, ``epoch``), and a restarted phase skips the journaled ids.

Writes: append-only JSONL, one ``os.write`` a line on an ``O_APPEND`` fd
with fsync, so a kill mid-append leaves at most one torn tail line, which
the reader skips and the next append heals (it starts on a new line).

Fencing (fleet mode): ``mark_done(fence=...)`` validates the caller's lease
token under the journal lock just before the append and skips a unit that
is already journaled, so a host whose lease was stolen cannot commit, and
every unit commits once; a fenced-out commit raises ``LeaseLost``.

Compaction: with ``TIP_JOURNAL_MAX_BYTES`` set, an append that takes the
file past the cap rewrites it as one record a (case study, phase, id),
through tmp + fsync + rename under the journal lock.

Resolution (``journal_from_env``): ``TIP_JOURNAL`` = ``off`` / ``0``
disables; a path is used as given; unset / ``auto`` journals under
``$TIP_ASSETS/journal/runs.jsonl``, but only when ``TIP_ASSETS`` is set.
Opening the journal sweeps aged orphan ``*.<pid>.tmp`` files beside it
(``utils/artifacts_io.sweep_orphan_tmp``). Delete the file to re-run
everything. Stdlib only.
"""

import json
import logging
import os
import time
from typing import Optional, Set

from simple_tip_tpu_torch import obs
from simple_tip_tpu_torch.resilience import faults

try:
    import fcntl
except ImportError:  # pragma: no cover — non-POSIX
    fcntl = None

logger = logging.getLogger(__name__)


def journal_max_bytes() -> int:
    """The ``TIP_JOURNAL_MAX_BYTES`` compaction trigger (0 = off)."""
    raw = os.environ.get("TIP_JOURNAL_MAX_BYTES", "").strip()
    if not raw:
        return 0
    try:
        return max(0, int(float(raw)))
    except ValueError:
        logger.warning("TIP_JOURNAL_MAX_BYTES=%r is not a number; ignoring", raw)
        return 0


class RunJournal:
    """Append-only completion ledger for one (case study, phase) pair."""

    def __init__(self, path: str, case_study: str, phase: str):
        self.path = path
        self.case_study = case_study
        self.phase = phase

    # -- reading -----------------------------------------------------------

    def _records(self) -> list:
        """Every parseable record in the journal, torn tails skipped."""
        out = []
        try:
            with open(self.path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue  # torn tail from a crash mid-append
                    if isinstance(rec, dict):
                        out.append(rec)
        except OSError:
            return []
        return out

    def completed(self) -> Set:
        """Model ids journaled as done for this (case study, phase).

        Torn tail lines (a kill mid-append) and foreign entries are
        skipped; a missing journal is simply the empty set.
        """
        done: Set = set()
        for rec in self._records():
            if (
                rec.get("case_study") == self.case_study
                and rec.get("phase") == self.phase
                and "model_id" in rec
            ):
                done.add(rec["model_id"])
        return done

    # -- locking -----------------------------------------------------------

    def _locked(self):
        """Journal flock (sidecar ``.lock`` file): held by fenced commits
        and by compaction, so neither can race the other's rename."""
        path = self.path + ".lock"
        journal = self

        class _Lock:
            def __enter__(self):
                os.makedirs(os.path.dirname(journal.path) or ".", exist_ok=True)
                self.fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
                if fcntl is not None:
                    fcntl.flock(self.fd, fcntl.LOCK_EX)
                return self

            def __exit__(self, *exc):
                try:
                    if fcntl is not None:
                        fcntl.flock(self.fd, fcntl.LOCK_UN)
                finally:
                    os.close(self.fd)
                return False

        return _Lock()

    def wedged(self) -> bool:
        """Non-blocking probe: is the journal flock held right now?

        The health-plane input behind ``/healthz``'s "journal wedged"
        verdict. The flock is held only for the microseconds of a fenced
        append or a compaction rename, so one True is ordinary contention
        — but a holder that died or stalled with the fd open (the wedge
        failure mode this deployment actually sees) keeps the lock held
        across every probe. Publishers debounce: the scheduler flags the
        journal unhealthy only after several consecutive True polls.
        Never raises; no fcntl (non-POSIX) means never wedged.
        """
        if fcntl is None:
            return False
        try:
            fd = os.open(self.path + ".lock", os.O_CREAT | os.O_RDWR, 0o644)
        except OSError:
            return False
        try:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                return True
            fcntl.flock(fd, fcntl.LOCK_UN)
            return False
        finally:
            os.close(fd)

    # -- writing -----------------------------------------------------------

    def mark_done(self, model_id, fence=None) -> None:
        """Append one completion line (fsync'd).

        Plain appends warn and never raise — the journal accelerates
        restarts, it must not fail the phase. With ``fence`` (a lease
        :class:`~..lease.FenceToken`), this is the fleet commit point:
        under the journal lock the fence is validated (raising
        ``LeaseLost`` for a stolen lease — the stale host cannot commit)
        and an already-journaled unit is skipped, so every unit commits
        exactly once no matter how many hosts raced it.
        """
        if fence is not None:
            with self._locked():
                if model_id in self.completed():
                    # A stealer (or the original holder) already committed
                    # this unit; a second line would be a double completion.
                    obs.counter("journal.dup_skips").inc()
                    logger.info(
                        "journal: unit %s already committed; skipping duplicate",
                        model_id,
                    )
                    return
                fence.check()  # raises LeaseLost for a fenced-out holder
                self._append(model_id, epoch=fence.epoch)
                self._maybe_compact_locked()
            return
        if journal_max_bytes():
            with self._locked():
                self._append(model_id)
                self._maybe_compact_locked()
        else:
            self._append(model_id)

    def _append(self, model_id, epoch: Optional[int] = None) -> None:
        rec = {
            "case_study": self.case_study,
            "phase": self.phase,
            "model_id": model_id,
            "ts": time.time(),
            "pid": os.getpid(),
        }
        if epoch is not None:
            rec["epoch"] = int(epoch)
        line = json.dumps(rec, sort_keys=True) + "\n"
        data = line.encode("utf-8")
        fault = faults.maybe_inject(
            "journal.append", phase=self.phase, model_id=model_id
        )
        if fault is not None and fault.kind == "torn":
            data = data[: max(1, len(data) // 2)]  # simulated mid-append kill
        try:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            fd = os.open(self.path, os.O_APPEND | os.O_CREAT | os.O_RDWR, 0o644)
            try:
                # Heal a torn tail left by a previous kill mid-append: a
                # new line appended straight after half a line would merge
                # into one unparsable record, losing THIS completion too.
                if os.lseek(fd, 0, os.SEEK_END) > 0:
                    os.lseek(fd, -1, os.SEEK_END)
                    if os.read(fd, 1) != b"\n":
                        data = b"\n" + data
                os.write(fd, data)
                os.fsync(fd)
            finally:
                os.close(fd)
            obs.counter("journal.appends").inc()
        except OSError as e:
            logger.warning("resume journal append failed (%s): %s", self.path, e)

    def _maybe_compact_locked(self) -> None:
        """Compact the journal if it outgrew ``TIP_JOURNAL_MAX_BYTES``.

        Caller holds the journal lock. The snapshot keeps ONE record per
        (case_study, phase, model_id) across ALL pairs sharing the file
        (first completion wins — later lines are restart duplicates), and
        lands via tmp + fsync + atomic rename, so a kill mid-compaction
        leaves the old journal intact.
        """
        cap = journal_max_bytes()
        if not cap:
            return
        try:
            size = os.stat(self.path).st_size
        except OSError:
            return
        if size <= cap:
            return
        try:
            seen, kept = set(), []
            for rec in self._records():
                key = (rec.get("case_study"), rec.get("phase"), rec.get("model_id"))
                if "model_id" not in rec or key in seen:
                    continue
                seen.add(key)
                kept.append(rec)
            tmp = f"{self.path}.{os.getpid()}.tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                for rec in kept:
                    f.write(json.dumps(rec, sort_keys=True) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            after = os.stat(self.path).st_size
            obs.counter("journal.compactions").inc()
            obs.event(
                "journal.compact", path=self.path, before_bytes=size,
                after_bytes=after, records=len(kept),
            )
            logger.info(
                "journal compacted: %s %d -> %d bytes (%d unique completions)",
                self.path, size, after, len(kept),
            )
        except OSError as e:
            logger.warning("journal compaction failed (%s): %s", self.path, e)


def journal_from_env(case_study: str, phase: str) -> Optional[RunJournal]:
    """The configured journal, or None when journaling is off (see module
    docstring for the ``TIP_JOURNAL`` / ``TIP_ASSETS`` resolution)."""
    raw = os.environ.get("TIP_JOURNAL", "").strip()
    if raw.lower() in ("off", "0"):
        return None
    if raw and raw.lower() not in ("auto", "1", "on"):
        return _opened(RunJournal(raw, case_study, phase))
    if not os.environ.get("TIP_ASSETS", "").strip():
        return None  # no pinned bus: journaling would leak across runs
    from simple_tip_tpu_torch.config import output_folder

    path = os.path.join(output_folder(), "journal", "runs.jsonl")
    return _opened(RunJournal(path, case_study, phase))


def _opened(journal: RunJournal) -> RunJournal:
    """Open-path hygiene: sweep aged orphan tmp files next to the journal
    (an atomic writer killed between write and rename leaks them)."""
    from simple_tip_tpu_torch.utils.artifacts_io import sweep_orphan_tmp

    sweep_orphan_tmp(os.path.dirname(journal.path) or ".")
    return journal
