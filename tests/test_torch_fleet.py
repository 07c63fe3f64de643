"""The port's fleet layer (``parallel/fleet.py``, ``resilience/lease.py``)
on the CPU, mirroring ``tests/test_fleet.py``: lease claim, steal, fence,
renew and release (fencing epochs that only grow, a skewed clock's steal
fenced at the journal in both commit orders); membership and heartbeat
drops; two contexts partition the units disjointly; the fleet view, the
attempt budget and the coordinator handoff; the straggler timeout (the
knob, else None: the port has no cost model); leases shared with the JAX
package on one directory; and one fleet run of the synthetic phase with two
spawned members that survives a ``host.die`` kill of the coordinator.
"""

import json
import os
import time

import pytest

from simple_tip_tpu.resilience import lease as jax_lease
from simple_tip_tpu_torch import obs
from simple_tip_tpu_torch.obs import metrics
from simple_tip_tpu_torch.parallel.fleet import FleetContext, run_phase_fleet
from simple_tip_tpu_torch.resilience import (
    COORDINATOR_UNIT,
    LeaseLost,
    LeaseManager,
    Membership,
    RunJournal,
)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _clean_fleet_env(monkeypatch):
    """Isolate every test from inherited chaos/retry/fleet/obs state."""
    for var in ("TIP_FAULT_PLAN", "TIP_FAULT_STATE", "TIP_JOURNAL",
                "TIP_JOURNAL_MAX_BYTES", "TIP_ASSETS", "TIP_OBS_DIR"):
        monkeypatch.delenv(var, raising=False)
    for var in list(os.environ):
        if var.startswith("TIP_RETRY_") or var.startswith("TIP_FLEET_"):
            monkeypatch.delenv(var, raising=False)
    metrics.reset()
    yield
    metrics.reset()


# --- lease protocol ----------------------------------------------------------


def test_first_claim_single_winner(tmp_path):
    a = LeaseManager(str(tmp_path), owner="A", ttl_s=30.0)
    b = LeaseManager(str(tmp_path), owner="B", ttl_s=30.0)
    tok = a.claim("7")
    assert tok is not None and tok.epoch == 1
    assert b.claim("7") is None, "a live lease must have exactly one holder"
    # A restarted claim loop on the holder gets its current epoch back.
    again = a.claim("7")
    assert again is not None and again.epoch == 1
    tok.check()  # still valid


def test_steal_after_expiry_bumps_epoch_and_fences_old_holder(tmp_path):
    a = LeaseManager(str(tmp_path), owner="A", ttl_s=0.05)
    b = LeaseManager(str(tmp_path), owner="B", ttl_s=30.0)
    tok_a = a.claim("x")
    assert tok_a is not None
    time.sleep(0.1)
    tok_b = b.claim("x")
    assert tok_b is not None and tok_b.epoch == 2, "steal must bump the epoch"
    with pytest.raises(LeaseLost):
        tok_a.check()
    with pytest.raises(LeaseLost):
        a.renew(tok_a)  # a renewal cannot resurrect a stolen lease
    tok_b.check()
    assert metrics.snapshot()["counters"].get("lease.steals") == 1


def test_release_tombstone_keeps_epochs_growing(tmp_path):
    a = LeaseManager(str(tmp_path), owner="A", ttl_s=30.0)
    b = LeaseManager(str(tmp_path), owner="B", ttl_s=30.0)
    tok1 = a.claim("u")
    a.release(tok1)
    tok2 = b.claim("u")  # reclaim of the tombstone
    assert tok2 is not None and tok2.epoch == 2
    b.release(tok2)
    tok3 = a.claim("u")
    assert tok3 is not None and tok3.epoch == 3, (
        "epochs must grow across release/claim cycles so a fence from ANY "
        "earlier tenancy stays dead"
    )
    with pytest.raises(LeaseLost):
        tok1.check()


def test_renew_extends_expiry(tmp_path):
    a = LeaseManager(str(tmp_path), owner="A", ttl_s=1.0)
    b = LeaseManager(str(tmp_path), owner="B", ttl_s=1.0)
    tok = a.claim("u")
    time.sleep(0.6)
    a.renew(tok)
    time.sleep(0.6)  # past the original expiry, within the renewed one
    assert b.claim("u") is None, "a renewed lease must not be stealable"
    tok.check()


def test_expire_now_is_a_hint_not_a_revocation(tmp_path):
    a = LeaseManager(str(tmp_path), owner="A", ttl_s=30.0)
    b = LeaseManager(str(tmp_path), owner="B", ttl_s=30.0)
    tok_a = a.claim("s")
    assert a.expire_now("s") is True
    rec = a.holder("s")
    # Owner and epoch survive the speculation: if nobody steals, the
    # original holder's fence is still the live one.
    assert rec["owner"] == "A" and rec["epoch"] == 1
    tok_a.check()
    tok_b = b.claim("s")  # the speculative re-lease
    assert tok_b is not None and tok_b.epoch == 2
    with pytest.raises(LeaseLost):
        tok_a.check()


# --- the fencing pin: wedged host cannot commit ------------------------------


def _skewed_steal(tmp_path, monkeypatch):
    """A holds a live 30s lease; B's clock runs 60s ahead and steals it.
    Returns (journal, tok_a, tok_b) — the stale and the live fence."""
    leases = str(tmp_path / "leases")
    a = LeaseManager(leases, owner="A", ttl_s=30.0)
    b = LeaseManager(leases, owner="B", ttl_s=30.0)
    journal = RunJournal(str(tmp_path / "runs.jsonl"), "cs", "ph")
    tok_a = a.claim("5")
    assert tok_a is not None
    # fleet_now() reads the skew knob per call, so setting it around B's
    # claim simulates one host with a fast clock (additive expiry
    # comparisons make this a shifted window, not a corrupted duration).
    monkeypatch.setenv("TIP_FLEET_CLOCK_SKEW_S", "60")
    tok_b = b.claim("5")
    monkeypatch.delenv("TIP_FLEET_CLOCK_SKEW_S")
    assert tok_b is not None and tok_b.epoch == 2, (
        "the skewed host must see the lease expired and steal it"
    )
    return journal, tok_a, tok_b


def test_wedged_holder_fenced_when_stealer_has_not_committed(tmp_path, monkeypatch):
    """The wedged-but-alive host wakes FIRST: its commit must be rejected
    at the journal and nothing must land."""
    journal, tok_a, tok_b = _skewed_steal(tmp_path, monkeypatch)
    with pytest.raises(LeaseLost):
        journal.mark_done("5", fence=tok_a)
    assert journal.completed() == set(), "a fenced commit must not append"
    journal.mark_done("5", fence=tok_b)  # the live fence commits
    assert journal.completed() == {"5"}
    recs = [r for r in journal._records() if r.get("model_id") == "5"]
    assert len(recs) == 1 and recs[0]["epoch"] == 2


def test_wedged_holder_dup_skips_when_stealer_committed_first(tmp_path, monkeypatch):
    """Opposite order: the stealer already committed, so the stale host's
    commit is a silent dup-skip (not an error) — still exactly one line."""
    journal, tok_a, tok_b = _skewed_steal(tmp_path, monkeypatch)
    journal.mark_done("5", fence=tok_b)
    journal.mark_done("5", fence=tok_a)  # no raise: already-journaled wins
    recs = [r for r in journal._records() if r.get("model_id") == "5"]
    assert len(recs) == 1, "the race must resolve to exactly one commit"
    assert recs[0]["epoch"] == 2, "and it is the stealer's, not the stale host's"
    assert metrics.snapshot()["counters"].get("journal.dup_skips") == 1


# --- membership --------------------------------------------------------------


def test_heartbeat_drop_partitions_host(tmp_path, monkeypatch):
    monkeypatch.setenv("TIP_FAULT_STATE", str(tmp_path / "fstate"))
    monkeypatch.setenv("TIP_FAULT_PLAN", json.dumps({"faults": [
        {"site": "heartbeat.drop", "kind": "fail",
         "match": {"host": "h1"}, "times": 0},
    ]}))
    members = str(tmp_path / "members")
    m1 = Membership(members, "h1", ttl_s=5.0)
    m2 = Membership(members, "h2", ttl_s=5.0)
    assert m1.beat() is False, "the dropped beat must be reported"
    assert m2.beat() is True
    alive = m2.alive()
    assert "h2" in alive and "h1" not in alive, (
        "a partitioned host is alive but invisible to the fleet"
    )
    assert metrics.snapshot()["counters"].get("fleet.heartbeats_dropped") == 1


def test_membership_join_and_leave(tmp_path):
    members = str(tmp_path / "members")
    m = Membership(members, "h1", ttl_s=5.0)
    assert m.beat(role="member") is True
    assert "h1" in m.alive()
    assert m.alive()["h1"]["role"] == "member"
    m.leave()
    assert m.alive() == {}


# --- FleetContext ------------------------------------------------------------


def test_two_contexts_partition_units_disjointly(tmp_path, monkeypatch):
    monkeypatch.setenv("TIP_JOURNAL", str(tmp_path / "runs.jsonl"))
    root = str(tmp_path / "fleet")
    a = FleetContext(root, "hA", "cs", "ph", lease_ttl_s=30.0, member_ttl_s=5.0)
    b = FleetContext(root, "hB", "cs", "ph", lease_ttl_s=30.0, member_ttl_s=5.0)
    ids = list(range(10))
    won = {"hA": set(), "hB": set()}
    for i in ids:
        first, second = (a, b) if i % 2 == 0 else (b, a)
        for ctx in (first, second):
            if ctx.try_claim(i) is not None:
                won[ctx.host_id].add(i)
    assert won["hA"] | won["hB"] == set(ids), "every unit must find a host"
    assert not (won["hA"] & won["hB"]), "no unit may have two live holders"
    assert won["hA"] and won["hB"]


def test_fleet_view_marks_stale_heartbeat_and_recovers(tmp_path, monkeypatch):
    """A host whose heartbeats stop (fault seam ``heartbeat.drop``) must
    show ``stale: true`` in the coordinator's
    /fleet view — while staying IN the view, unlike ``alive()`` which
    TTL-filters it — and must read fresh again after it rejoins."""
    monkeypatch.setenv("TIP_JOURNAL", str(tmp_path / "runs.jsonl"))
    root = str(tmp_path / "fleet")
    ctx = FleetContext(root, "h0", "cs", "ph",
                       lease_ttl_s=30.0, member_ttl_s=0.5)
    other = Membership(os.path.join(root, "members"), "h1", ttl_s=0.5)
    assert ctx.members.beat() is True
    assert other.beat() is True
    view = ctx.fleet_view()
    assert view["host"] == "h0" and view["member_ttl_s"] == 0.5
    assert view["members"]["h1"]["stale"] is False

    # Partition h1: its beats drop on the floor (times: 0 = every beat).
    monkeypatch.setenv("TIP_FAULT_STATE", str(tmp_path / "fstate"))
    monkeypatch.setenv("TIP_FAULT_PLAN", json.dumps({"faults": [
        {"site": "heartbeat.drop", "kind": "fail",
         "match": {"host": "h1"}, "times": 0},
    ]}))
    assert other.beat() is False
    time.sleep(0.6)  # h1's last landed beat ages past the 0.5s TTL
    assert ctx.members.beat() is True  # h0 keeps beating through it
    view = ctx.fleet_view()
    assert view["members"]["h0"]["stale"] is False
    assert view["members"]["h1"]["stale"] is True, (
        "a partitioned host must surface as stale, not vanish"
    )
    assert view["members"]["h1"]["age_s"] > 0.5
    # the cached copy the exporter serves is the same object, no bus walk
    assert ctx.last_fleet_view() is view

    # Rejoin: the fault plan lifts, h1 beats, staleness clears.
    monkeypatch.delenv("TIP_FAULT_PLAN")
    assert other.beat() is True
    view = ctx.fleet_view()
    assert view["members"]["h1"]["stale"] is False
    assert view["members"]["h1"]["age_s"] < 0.5


def test_fleet_view_reports_coordinator_and_straggler_leases(
    tmp_path, monkeypatch
):
    monkeypatch.setenv("TIP_JOURNAL", str(tmp_path / "runs.jsonl"))
    monkeypatch.setenv("TIP_FLEET_STRAGGLER_S", "100.0")
    root = str(tmp_path / "fleet")
    ctx = FleetContext(root, "h0", "cs", "ph",
                       lease_ttl_s=200.0, member_ttl_s=5.0)
    ctx.tick()  # beats + takes the coordinator lease + refreshes the view
    assert ctx.try_claim(7) is not None
    view = ctx.fleet_view()
    assert view["is_coordinator"] is True
    assert view["coordinator"]["owner"] == "h0"
    assert view["coordinator"]["epoch"] >= 1
    (lease,) = view["leases"]
    assert lease["unit"] == "7" and lease["verdict"] == "ok"
    assert view["in_flight"] == 1
    # age a lease past the straggler timeout: the verdict must flip
    monkeypatch.setattr(
        "simple_tip_tpu_torch.parallel.fleet.fleet_now",
        lambda: time.time() + 150.0,
    )
    (lease,) = ctx.fleet_view()["leases"]
    assert lease["verdict"] == "straggler"


def test_fleet_attempt_budget_exhausts_across_hosts(tmp_path, monkeypatch):
    monkeypatch.setenv("TIP_JOURNAL", str(tmp_path / "runs.jsonl"))
    monkeypatch.setenv("TIP_RETRY_FLEET_ATTEMPTS", "2")
    root = str(tmp_path / "fleet")
    a = FleetContext(root, "hA", "cs", "ph", lease_ttl_s=30.0, member_ttl_s=5.0)
    b = FleetContext(root, "hB", "cs", "ph", lease_ttl_s=30.0, member_ttl_s=5.0)
    tok = a.try_claim(3)
    assert tok is not None
    assert a.report_failure(3, tok, "boom") is None, (
        "under budget: the lease is released for another host to retry"
    )
    tok_b = b.try_claim(3)
    assert tok_b is not None, "the released lease must be reclaimable"
    final = b.report_failure(3, tok_b, "boom again")
    assert final is not None and "exhausted across hosts" in final
    b._last_elsewhere = 0.0  # bust the elsewhere() cache for the re-check
    assert b.try_claim(3) is None, "a fleet-wide failure is never re-claimed"
    _, failed = b.elsewhere()
    assert 3 in failed


def test_coordinator_handoff_promotes_standby(tmp_path, monkeypatch):
    monkeypatch.setenv("TIP_JOURNAL", str(tmp_path / "runs.jsonl"))
    root = str(tmp_path / "fleet")
    a = FleetContext(root, "hA", "cs", "ph", lease_ttl_s=30.0, member_ttl_s=0.3)
    b = FleetContext(root, "hB", "cs", "ph", lease_ttl_s=30.0, member_ttl_s=0.3)
    a.tick()
    assert a._coord_tok is not None and a._coord_tok.epoch == 1
    b.tick()
    assert b._coord_tok is None, "the founding coordinator still holds the lease"
    # hA stops ticking (a dead host just stops renewing). After the member
    # TTL, hB's next beat steals the coordinator lease and promotes.
    time.sleep(0.4)
    b.tick()
    assert b._coord_tok is not None and b._coord_tok.epoch == 2
    assert metrics.snapshot()["counters"].get("fleet.handoffs") == 1
    # The resurrected hA notices it was fenced out and demotes itself.
    a.tick()
    assert a._coord_tok is None
    assert b.leases is not a.leases
    assert a._coord_mgr.holder(COORDINATOR_UNIT)["owner"] == "hB"


def test_straggler_timeout_is_the_knob_or_none(tmp_path, monkeypatch):
    """Without ``TIP_FLEET_STRAGGLER_S`` the port has no estimate (no cost
    model: the JAX answer on an empty index), so nothing is speculated."""
    monkeypatch.setenv("TIP_JOURNAL", str(tmp_path / "runs.jsonl"))
    ctx = FleetContext(str(tmp_path / "fleet"), "h0", "cs", "ph")
    assert ctx._straggler_timeout() is None
    monkeypatch.setenv("TIP_FLEET_STRAGGLER_S", "12.5")
    assert FleetContext(str(tmp_path / "fleet"), "h1", "cs", "ph")._straggler_timeout() == 12.5
    monkeypatch.setenv("TIP_FLEET_STRAGGLER_S", "0")
    assert FleetContext(str(tmp_path / "fleet"), "h2", "cs", "ph")._straggler_timeout() is None


@pytest.mark.parametrize("first", ["jax", "port"])
def test_leases_are_shared_with_the_jax_package(tmp_path, first):
    """One lease directory, both packages: a live lease of either is not
    claimable by the other, an expired one is stolen with the epoch bumped,
    and the old holder's fence is dead in both."""
    managers = {"jax": jax_lease.LeaseManager, "port": LeaseManager}
    second = "port" if first == "jax" else "jax"
    a = managers[first](str(tmp_path), owner="A", ttl_s=0.2)
    b = managers[second](str(tmp_path), owner="B", ttl_s=30.0)
    tok_a = a.claim("9")
    assert tok_a is not None and b.claim("9") is None
    time.sleep(0.3)
    tok_b = b.claim("9")
    assert tok_b is not None and tok_b.epoch == 2
    with pytest.raises(Exception) as e:
        tok_a.check()
    assert type(e.value).__name__ == "LeaseLost"
    journal = RunJournal(str(tmp_path / "runs.jsonl"), "cs", "ph")
    journal.mark_done("9", fence=tok_b)
    assert journal.completed() == {"9"}


def test_run_phase_fleet_requires_a_journal(tmp_path):
    with pytest.raises(ValueError, match="journal"):
        run_phase_fleet("cs", "_test_sleep", [0], root=str(tmp_path / "fleet"))


# --- acceptance: a real 2-member fleet survives a coordinator kill -----------


def test_fleet_survives_coordinator_kill(tmp_path, monkeypatch):
    """Kill the coordinator host mid-phase: the survivor promotes, steals
    the dead host's expired leases, and every unit lands in the journal
    exactly once."""
    monkeypatch.setenv("TIP_ASSETS", str(tmp_path / "assets"))
    monkeypatch.setenv("TIP_OBS_DIR", str(tmp_path / "obs"))
    monkeypatch.setenv("TIP_FAULT_STATE", str(tmp_path / "fstate"))
    monkeypatch.setenv("TIP_FAULT_PLAN", json.dumps({"faults": [
        {"site": "host.die", "kind": "kill",
         "match": {"role": "coordinator"}, "times": 1},
    ]}))
    obs.reset_all()
    ids = list(range(8))
    try:
        run_phase_fleet(
            "fleetacc", "_test_sleep", ids,
            root=str(tmp_path / "fleet"),
            n_hosts=2, workers_per_host=1,
            phase_kwargs={"seconds": 0.3},
            lease_ttl_s=2.0, member_ttl_s=2.0, deadline_s=180.0,
        )
    finally:
        obs.reset_all()

    journal = RunJournal(
        str(tmp_path / "assets" / "journal" / "runs.jsonl"),
        "fleetacc", "_test_sleep",
    )
    committed = [
        r["model_id"] for r in journal._records()
        if r.get("case_study") == "fleetacc"
    ]
    assert sorted(committed) == ids, "every unit must be journaled"
    assert len(committed) == len(set(committed)), (
        "no unit may be journaled twice (fenced commits are exactly-once)"
    )

    blob = ""
    for name in sorted(os.listdir(tmp_path / "obs")):
        if name.startswith("events-") and name.endswith(".jsonl"):
            blob += (tmp_path / "obs" / name).read_text()
    assert '"fleet.host_die"' in blob, "the kill fault must have fired"
    assert '"fleet.handoff"' in blob, "the survivor must promote to coordinator"
    assert '"lease.steal"' in blob, "the dead host's expired leases are stolen"
