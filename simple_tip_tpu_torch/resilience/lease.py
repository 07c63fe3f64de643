"""File-backed work leases with fencing epochs, plus host membership.

Counterpart of the JAX package's ``resilience/lease.py``, with its file
layout, so the fleet's members share one directory:

- **Lease**: one JSON file a work unit (``lease_<unit>.json``). A claim
  creates it ``O_CREAT|O_EXCL`` (one winner); the holder renews it; a lease
  past its ``expires_ts`` is stealable, and every steal (or reclaim of a
  released lease) bumps a **fencing epoch** that only grows.
- **Fencing**: a ``FenceToken`` holds (unit, owner, epoch) from the claim;
  the journal validates it just before it commits, so a holder whose lease
  was stolen gets ``LeaseLost`` instead of a second completion.
- **Membership**: hosts heartbeat a per-host JSON file; ``alive()`` is the
  set that beat within the TTL; a clean leaver releases its claims.

Mutations are serialized per unit by an ``fcntl.flock`` on a sidecar lock
file. Expiry rides the wall clock (it crosses hosts), plus
``TIP_FLEET_CLOCK_SKEW_S`` (``fleet_now``) to skew one host on purpose.
Fault seams: ``lease.steal`` (``fail`` denies a takeover, ``error``
raises) and ``heartbeat.drop`` (``fail`` skips a beat). Stdlib only.
"""

import errno
import json
import logging
import os
import time
from typing import Dict, List, Optional

from simple_tip_tpu_torch import obs
from simple_tip_tpu_torch.resilience import faults

try:
    import fcntl
except ImportError:  # pragma: no cover — non-POSIX; leases need flock
    fcntl = None

logger = logging.getLogger(__name__)

#: Lease held by the member currently acting as coordinator (same
#: machinery as unit leases: kill the holder and a standby steals it).
COORDINATOR_UNIT = "__coordinator__"


def fleet_now() -> float:
    """Wall clock + ``TIP_FLEET_CLOCK_SKEW_S`` (chaos knob, default 0).

    Cross-host expiry decisions must ride the wall clock; the skew knob
    makes "this host's clock is wrong" a deterministic test input rather
    than an untestable deployment hazard.
    """
    raw = os.environ.get("TIP_FLEET_CLOCK_SKEW_S", "").strip()
    skew = 0.0
    if raw:
        try:
            skew = float(raw)
        except ValueError:
            logger.warning("TIP_FLEET_CLOCK_SKEW_S=%r is not a number", raw)
    return time.time() + skew


class LeaseLost(RuntimeError):
    """This holder's lease was stolen/released: its fence is invalid and
    any commit it attempts must be rejected."""


def _safe(unit: str) -> str:
    return "".join(c if c.isalnum() or c in "._-" else "_" for c in str(unit))


class FenceToken:
    """Proof of one claim: (unit, owner, epoch) at claim time.

    ``check()`` re-reads the lease and raises :class:`LeaseLost` unless
    this owner still holds this epoch — the journal calls it immediately
    before the commit append (RunJournal.mark_done(fence=...)).
    """

    def __init__(self, manager: "LeaseManager", unit: str, owner: str, epoch: int):
        self.manager = manager
        self.unit = unit
        self.owner = owner
        self.epoch = int(epoch)

    def check(self) -> None:
        """Raise :class:`LeaseLost` unless the lease is still ours."""
        self.manager.validate(self)

    def __repr__(self) -> str:  # diagnostics in scheduler logs
        return f"FenceToken({self.unit!r}, owner={self.owner!r}, epoch={self.epoch})"


class LeaseManager:
    """Claim/renew/steal/release leases for one fleet root directory."""

    def __init__(self, root: str, owner: str, ttl_s: float = 30.0):
        self.root = root
        self.owner = str(owner)
        self.ttl_s = float(ttl_s)

    # -- paths and serialization ------------------------------------------

    def _path(self, unit: str) -> str:
        return os.path.join(self.root, f"lease_{_safe(unit)}.json")

    def _lock_path(self, unit: str) -> str:
        return os.path.join(self.root, "locks", f"{_safe(unit)}.lock")

    def _read(self, unit: str) -> Optional[Dict]:
        try:
            with open(self._path(unit), encoding="utf-8") as f:
                rec = json.load(f)
            return rec if isinstance(rec, dict) else None
        except (OSError, ValueError):
            return None

    def _write(self, unit: str, rec: Dict) -> None:
        """Replace the lease file atomically (pid-unique tmp + rename)."""
        path = self._path(unit)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(rec, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def _locked(self, unit: str):
        """Context manager: the per-unit mutation lock (flock).

        Serializes claim/steal/renew/release so a renewal racing a steal
        cannot resurrect a fenced-out lease. Advisory and per-unit, so
        unrelated units never contend.
        """
        mgr = self

        class _Lock:
            def __enter__(self):
                os.makedirs(os.path.dirname(mgr._lock_path(unit)), exist_ok=True)
                self.fd = os.open(mgr._lock_path(unit), os.O_CREAT | os.O_RDWR, 0o644)
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

    def _fresh(self, unit: str, epoch: int) -> Dict:
        now = fleet_now()
        return {
            "unit": str(unit),
            "owner": self.owner,
            "epoch": int(epoch),
            "claimed_ts": now,
            "renewed_ts": now,
            "expires_ts": now + self.ttl_s,
            "released": False,
        }

    # -- protocol ----------------------------------------------------------

    def claim(self, unit: str) -> Optional[FenceToken]:
        """Claim ``unit``: fresh (O_EXCL), reclaim of a released lease, or
        steal of an expired one. None when someone else validly holds it.
        """
        os.makedirs(self.root, exist_ok=True)
        with self._locked(unit):
            rec = self._read(unit)
            if rec is None:
                # First claim: O_CREAT|O_EXCL is the atomic winner-takes-it
                # even if a non-locking writer raced us.
                try:
                    fd = os.open(
                        self._path(unit), os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644
                    )
                    os.close(fd)
                except OSError as e:
                    if e.errno != errno.EEXIST:
                        raise
                    return None  # lost the creation race
                fresh = self._fresh(unit, epoch=1)
                self._write(unit, fresh)
                obs.counter("lease.claims").inc()
                return FenceToken(self, unit, self.owner, 1)
            if rec.get("released"):
                # Reclaim: the epoch keeps growing across release/claim
                # cycles so a fence from ANY earlier tenancy stays dead.
                return self._take(unit, rec, reason="reclaim")
            if fleet_now() >= float(rec.get("expires_ts", 0)):
                return self._take(unit, rec, reason="steal")
            if rec.get("owner") == self.owner:
                # Our own live lease (a restarted claim loop): hand the
                # current epoch back rather than treating it as foreign.
                return FenceToken(self, unit, self.owner, int(rec.get("epoch", 1)))
            return None

    def _take(self, unit: str, rec: Dict, reason: str) -> Optional[FenceToken]:
        """Take over an expired/released lease, bumping the fencing epoch.

        Caller holds the unit lock. ``lease.steal`` chaos seam: ``fail``
        denies the takeover (partitioned standby), ``error`` raises.
        """
        fault = faults.maybe_inject(
            "lease.steal", unit=str(unit), owner=self.owner,
            from_owner=str(rec.get("owner")), reason=reason,
        )
        if fault is not None and fault.kind in ("fail", "timeout"):
            return None
        epoch = int(rec.get("epoch", 1)) + 1
        fresh = self._fresh(unit, epoch=epoch)
        self._write(unit, fresh)
        if reason == "steal":
            obs.counter("lease.steals").inc()
            obs.event(
                "lease.steal", unit=str(unit), owner=self.owner,
                from_owner=str(rec.get("owner")), epoch=epoch,
            )
            logger.warning(
                "lease STOLEN: unit %s epoch %d (from %s, expired %.1fs ago)",
                unit, epoch, rec.get("owner"),
                fleet_now() - float(rec.get("expires_ts", 0)),
            )
        else:
            obs.counter("lease.claims").inc()
        return FenceToken(self, unit, self.owner, epoch)

    def renew(self, token: FenceToken) -> None:
        """Extend the expiry of a lease we still hold; :class:`LeaseLost`
        if it was stolen/released out from under us (fenced out)."""
        with self._locked(token.unit):
            rec = self._read(token.unit)
            self._validate_rec(token, rec)
            rec["renewed_ts"] = fleet_now()
            rec["expires_ts"] = rec["renewed_ts"] + self.ttl_s
            self._write(token.unit, rec)

    def release(self, token: FenceToken) -> None:
        """Mark our lease released (a tombstone keeping the epoch, so a
        later reclaim still bumps it). Losing the lease first is fine —
        release is how a clean leaver requeues its claims."""
        try:
            with self._locked(token.unit):
                rec = self._read(token.unit)
                try:
                    self._validate_rec(token, rec)
                except LeaseLost:
                    return  # already someone else's (or gone): nothing to release
                rec["released"] = True
                rec["expires_ts"] = fleet_now()
                self._write(token.unit, rec)
        except OSError as e:  # advisory cleanup, never fatal
            logger.warning("lease release failed for %s: %s", token.unit, e)

    def validate(self, token: FenceToken) -> None:
        """Raise :class:`LeaseLost` unless ``token`` matches the live lease."""
        self._validate_rec(token, self._read(token.unit))

    def _validate_rec(self, token: FenceToken, rec: Optional[Dict]) -> None:
        if rec is None:
            raise LeaseLost(f"lease file for {token.unit!r} is gone")
        if rec.get("released"):
            raise LeaseLost(f"lease for {token.unit!r} was released")
        if rec.get("owner") != token.owner or int(rec.get("epoch", -1)) != token.epoch:
            raise LeaseLost(
                f"lease for {token.unit!r} now owner={rec.get('owner')!r} "
                f"epoch={rec.get('epoch')} (ours: {token.owner!r}/{token.epoch})"
            )

    def expire_now(self, unit: str) -> bool:
        """Make ``unit``'s live lease immediately stealable (speculative
        re-lease of a straggler): expiry drops to now, owner/epoch stay —
        if the straggler is merely slow it may still commit first; the
        fencing epoch decides the race, never this hint."""
        try:
            with self._locked(unit):
                rec = self._read(unit)
                if rec is None or rec.get("released"):
                    return False
                rec["expires_ts"] = fleet_now()
                self._write(unit, rec)
                return True
        except OSError:
            return False

    def holder(self, unit: str) -> Optional[Dict]:
        """The live lease record for ``unit`` (tombstones included), or None."""
        return self._read(unit)

    def active(self) -> List[Dict]:
        """All unexpired, unreleased lease records under this root."""
        out: List[Dict] = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        now = fleet_now()
        for name in names:
            if not (name.startswith("lease_") and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(self.root, name), encoding="utf-8") as f:
                    rec = json.load(f)
            except (OSError, ValueError):
                continue
            if (
                isinstance(rec, dict)
                and not rec.get("released")
                and now < float(rec.get("expires_ts", 0))
            ):
                out.append(rec)
        return out


class Membership:
    """Heartbeat-file membership table for one fleet root."""

    def __init__(self, root: str, host_id: str, ttl_s: float = 10.0):
        self.root = root
        self.host_id = str(host_id)
        self.ttl_s = float(ttl_s)
        self._joined = False

    def _path(self, host_id: str) -> str:
        return os.path.join(self.root, f"member_{_safe(host_id)}.json")

    def beat(self, **info) -> bool:
        """Write this host's heartbeat (atomic replace). Returns False when
        the ``heartbeat.drop`` chaos seam ate the beat — the partition
        stand-in: the host is alive but the fleet stops seeing it."""
        fault = faults.maybe_inject("heartbeat.drop", host=self.host_id)
        if fault is not None and fault.kind in ("fail", "timeout"):
            obs.counter("fleet.heartbeats_dropped").inc()
            return False
        rec = {
            "host": self.host_id,
            "pid": os.getpid(),
            "ts": fleet_now(),
            **info,
        }
        try:
            os.makedirs(self.root, exist_ok=True)
            path = self._path(self.host_id)
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(rec, f)
            os.replace(tmp, path)
        except OSError as e:
            logger.warning("heartbeat write failed for %s: %s", self.host_id, e)
            return False
        if not self._joined:
            self._joined = True
            obs.counter("fleet.members").inc()
            obs.event("fleet.join", host=self.host_id, pid=os.getpid())
            logger.info("fleet member %s joined (pid %d)", self.host_id, os.getpid())
        return True

    def leave(self) -> None:
        """Clean departure: drop the heartbeat file (claims are requeued by
        the leaver releasing its leases — see the scheduler's fleet path)."""
        try:
            os.remove(self._path(self.host_id))
        except OSError:
            pass
        if self._joined:
            obs.event("fleet.leave", host=self.host_id)
            logger.info("fleet member %s left", self.host_id)
        self._joined = False

    def table(self) -> Dict[str, Dict]:
        """host_id -> last heartbeat record, stale hosts INCLUDED.

        ``alive()`` is the membership *decision* (TTL-filtered); this is
        the operator *view* behind the exporter's ``/fleet`` route — a
        host that stopped beating must show up with its heartbeat age so
        the coordinator can mark it ``stale=true``, not silently vanish
        from the table.
        """
        out: Dict[str, Dict] = {}
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for name in names:
            if not (name.startswith("member_") and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(self.root, name), encoding="utf-8") as f:
                    rec = json.load(f)
            except (OSError, ValueError):
                continue
            if isinstance(rec, dict) and rec.get("host") is not None:
                out[str(rec["host"])] = rec
        return out

    def alive(self) -> Dict[str, Dict]:
        """host_id -> heartbeat record, for hosts beating within the TTL."""
        now = fleet_now()
        return {
            host: rec
            for host, rec in self.table().items()
            if now - float(rec.get("ts", 0)) <= self.ttl_s
        }
