"""The port's scoring service over its real backend, ``FusedChainExecutor``.

On the CPU a chain program is the eager closure over the same buffers that
the card's CUDA graph replays, so these tests hold the service's wiring and
values; ``chip_smoke.py`` phase 7c holds them on the card. The MNIST
convnet (28x28) and the IMDB transformer of ``test_torch_run_program.py``,
flax weights from the JAX package's own initial trees through
``bridge.params_from_jax``, and ``test_torch_slice``'s inputs (on which the
two packages' taps cross no threshold apart) go through:

- (a) the port's engine, requests cut at uneven boundaries (some longer
  than a badge): ``pred``, uncertainties and coverage scores byte-equal to
  the port's ``FusedChainRunner.evaluate_dataset`` on the same rows;
- (b) the JAX package's ``ScoringEngine`` and ``FusedChainExecutor`` on
  the same rows and weights: ``pred`` and coverage scores byte-equal,
  uncertainties within ``UNCERTAINTY_ATOL``;
- (c) two tenants in one engine, each byte-equal to its own offline walk,
  both served by the fair rotation;
- (d) two threads calling ``run_badge`` on one model at once: each the
  serial result, byte for byte.

Also: the launch counters' read and add under two hammering threads, the
card gate (a capture waits for dispatches in flight, and runs alone), and
the executor's refusals.
"""

import asyncio
import sys
import threading
import time

import numpy as np
import pytest
import torch

from simple_tip_tpu.models import ImdbTransformer as FlaxImdbTransformer
from simple_tip_tpu.models import MnistConvNet as FlaxMnistConvNet
from simple_tip_tpu.serving import ScoringEngine as JaxScoringEngine
from simple_tip_tpu.serving import ServingKnobs as JaxServingKnobs
from simple_tip_tpu.serving.executor import FusedChainExecutor as JaxFusedChainExecutor
import simple_tip_tpu.obs as jax_obs
import simple_tip_tpu_torch.obs as obs
from simple_tip_tpu_torch.bridge import params_from_jax
from simple_tip_tpu_torch.engine import run_program as rp
from simple_tip_tpu_torch.models import ImdbTransformer, MnistConvNet
from simple_tip_tpu_torch.serving import FusedChainExecutor, ScoringEngine, ServingKnobs
from test_torch_model import flax_params
from test_torch_slice import _data as slice_data
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_transformer import imdb_flax_params

UNCERTAINTY_ATOL = 1e-5
BADGE = 16
# request boundaries over the 48 test rows: 3, 7, 19, 2 and 17 rows
CUTS = (0, 3, 10, 29, 31, 48)
FAMILIES = {
    "mnist": (FlaxMnistConvNet, MnistConvNet, flax_params, [0, 1, 2, 3]),
    "imdb": (FlaxImdbTransformer, ImdbTransformer, imdb_flax_params, [3, 5]),
}


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    for var in ("TIP_SA_CACHE_DIR", "TIP_COV_STATS_CACHE_DIR", "TIP_PROGRAM_CACHE_DIR",
                "TIP_BREAKER_STATE"):
        monkeypatch.setenv(var, "off")
    for var in ("TIP_FUSED_CHAIN", "TIP_CHAIN_GROUP", "TIP_INT8_PROFILES", "TIP_OBS_DIR",
                "TIP_OBS_HTTP"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("TIP_ASSETS", str(tmp_path))
    obs.reset_all()
    yield
    obs.reset_all()


def _family(family: str):
    """(flax tree, port params, train x, test x) of one family."""
    x_train, x_test, _, _ = slice_data(family)
    tree = FAMILIES[family][2](4)
    return tree, params_from_jax(tree), x_train, x_test


def _spec(family: str):
    tree, params, x_train, _ = _family(family)
    return dict(model_def=FAMILIES[family][1](), params=params, training_set=x_train,
                nc_layers=FAMILIES[family][3], batch_size=32)


def run(coro, timeout=300.0):
    async def bounded():
        return await asyncio.wait_for(coro, timeout)

    return asyncio.run(bounded())


async def _serve(engine, requests):
    """Score ``[(model, rows)]`` all at once through a started engine."""
    return await asyncio.gather(*(engine.score(m, rows) for m, rows in requests))


def _joined(parts):
    return {
        "pred": np.concatenate([p["pred"] for p in parts]),
        "uncertainties": {k: np.concatenate([p["uncertainties"][k] for p in parts])
                          for k in parts[0]["uncertainties"]},
        "scores": {k: np.concatenate([p["scores"][k] for p in parts])
                   for k in parts[0]["scores"]},
    }


def _assert_same(got, want, label, unc_atol=0.0):
    np.testing.assert_array_equal(got["pred"], np.asarray(want["pred"]), err_msg=label)
    assert set(got["uncertainties"]) == set(want["uncertainties"]), label
    for name, u in want["uncertainties"].items():
        if unc_atol:
            np.testing.assert_allclose(got["uncertainties"][name], np.asarray(u), rtol=0,
                                       atol=unc_atol, err_msg=f"{label} {name}")
        else:
            assert got["uncertainties"][name].dtype == np.asarray(u).dtype
            np.testing.assert_array_equal(got["uncertainties"][name], np.asarray(u),
                                          err_msg=f"{label} {name}")
    assert set(got["scores"]) == set(want["scores"]) and len(want["scores"]) == 12, label
    for mid, s in want["scores"].items():
        np.testing.assert_array_equal(got["scores"][mid], np.asarray(s), err_msg=f"{label} {mid}")


@pytest.fixture(scope="module")
def online():
    """Both families served by one port engine (two tenants), requests of
    both in flight together; with each model's offline walk."""
    with pytest.MonkeyPatch.context() as mp:
        for var in ("TIP_SA_CACHE_DIR", "TIP_COV_STATS_CACHE_DIR", "TIP_BREAKER_STATE"):
            mp.setenv(var, "off")
        executor = FusedChainExecutor(device="cpu")
        order = []
        run_badge = executor.run_badge
        executor.run_badge = lambda key, segments: (order.append(key), run_badge(key, segments))[1]

        async def scenario():
            knobs = ServingKnobs(max_badge=BADGE, flush_deadline_s=0.01)
            async with ScoringEngine(executor, knobs=knobs) as eng:
                tests = {}
                for family in FAMILIES:
                    eng.register_model(family, **_spec(family))
                    tests[family] = _family(family)[3]
                requests = [(f, tests[f][a:b]) for a, b in zip(CUTS, CUTS[1:]) for f in FAMILIES]
                parts = await _serve(eng, requests)
                return tests, requests, parts

        obs.reset_all()
        tests, requests, parts = run(scenario())
        log = (dict(executor.dispatches), order,
               obs.metrics_snapshot()["counters"]["serving.chain_dispatches"])
        del executor.run_badge
        offline = {f: executor.runner(f).evaluate_dataset(tests[f]) for f in FAMILIES}
    yield executor, tests, requests, parts, offline, log


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_online_equals_port_offline_walk(online, family):
    """(a) and (c): every family's responses, joined in request order,
    byte-equal to its own ``evaluate_dataset`` (and to ``score_dataset``);
    each response has its request's rows."""
    executor, tests, requests, parts, offline, _ = online
    mine = [p for (f, rows), p in zip(requests, parts) if f == family]
    assert [len(p["pred"]) for p in mine] == [b - a for a, b in zip(CUTS, CUTS[1:])]
    _assert_same(_joined(mine), offline[family], family)
    # the walk without the ranks (the card check's reference) is the same
    _assert_same(executor.runner(family).score_dataset(tests[family]), offline[family], family)


def test_two_tenants_share_the_rotation(online):
    """(c): both tenants got badges, the first two one each (the fair
    rotation); a request longer than a badge split into chunks that
    coalesced with others (fewer badges than chunks)."""
    dispatches, order, counted = online[5]
    chunks = sum(-(-(b - a) // BADGE) for a, b in zip(CUTS, CUTS[1:]))
    assert set(dispatches) == set(FAMILIES) and set(order[:2]) == set(FAMILIES)
    for family in FAMILIES:
        assert 48 // BADGE <= dispatches[family] == order.count(family) < chunks
    assert counted == len(order)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_online_equals_jax_serving(online, family, monkeypatch):
    """(b): the JAX package's engine and executor on the same rows and
    weights: ``pred`` and coverage scores byte-equal, uncertainties within
    ``UNCERTAINTY_ATOL``."""
    _, tests, requests, parts, _, _ = online
    tree, _, x_train, _ = _family(family)
    flax_model, _, _, layers = FAMILIES[family]
    monkeypatch.setenv("TIP_BREAKER_STATE", "off")
    jax_obs.reset_all()
    executor = JaxFusedChainExecutor(cache=None)

    async def scenario():
        knobs = JaxServingKnobs(max_badge=BADGE, flush_deadline_s=0.01)
        async with JaxScoringEngine(executor, knobs=knobs) as eng:
            eng.register_model(family, model_def=flax_model(), params=tree,
                               training_set=x_train, nc_layers=layers, batch_size=32)
            return await _serve(eng, [(f, rows) for f, rows in requests if f == family])

    theirs = run(scenario())
    jax_obs.reset_all()
    mine = [p for (f, _), p in zip(requests, parts) if f == family]
    _assert_same(_joined(mine), _joined(theirs), family, unc_atol=UNCERTAINTY_ATOL)


def test_concurrent_run_badge_equals_serial(online):
    """(d): two threads dispatching badges of one model at once (the engine
    runs up to ``max_inflight`` dispatches in worker threads, over one
    program) get the serial results byte for byte."""
    executor, tests, _, _, _, _ = online
    x = tests["mnist"]
    badges = [[x[0:5], x[9:20]], [x[20:36]], [x[1:2], x[40:48], x[30:33]], [x[5:9]]]
    serial = [executor.run_badge("mnist", b) for b in badges]
    results = {}
    barrier = threading.Barrier(2)

    def worker(t):
        barrier.wait()
        results[t] = [executor.run_badge("mnist", b) for b in badges[t::2] * 3]

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    for t in range(2):
        for got, want in zip(results[t], serial[t::2] * 3):
            for g, w in zip(got, want):
                _assert_same(g, w, f"thread {t}")


def test_register_is_idempotent_and_run_badge_refuses_overflow(online):
    executor = online[0]
    program = executor.program("mnist")
    executor.register_model("mnist", badge_size=BADGE, **_spec("mnist"))
    assert executor.program("mnist") is program
    x = online[1]["mnist"]
    with pytest.raises(ValueError, match="badge overflow: 17 rows"):
        executor.run_badge("mnist", [x[:10], x[10:17]])


def test_badge_takes_the_layout_of_the_requests(online):
    """The program's badge buffer takes ``layout_like``'s upload layout
    (a one-channel image set made with ``[..., None]`` has channel stride
    0), the offline walk's for the same set."""
    images = np.random.default_rng(0).random((40, 28, 28), dtype=np.float32)[..., None]
    executor = FusedChainExecutor(device="cpu")
    spec = _spec("mnist")
    executor.register_model("m", badge_size=BADGE, layout_like=images, **spec)
    buf = executor.program("m").args[1]
    assert buf.stride() == (784, 28, 1, 0)
    runner = executor.runner("m")
    assert executor.program("m") is runner.chain_program(*rp.badge_layout(images, BADGE,
                                                                          torch.device("cpu")))
    got = _joined(executor.run_badge("m", [images[:7], images[7:16]]))
    _assert_same(got, runner.evaluate_dataset(images[:16]), "layout")


def test_imdb_rows_upload_as_int64_with_zeroed_padding(online):
    """Token ids reach the badge as int64 whatever their host dtype, and the
    padding rows are zero (a valid token id, masked by ``valid``)."""
    executor, tests, _, _, _, _ = online
    x = tests["imdb"]
    want = executor.run_badge("imdb", [x[:5]])
    got = executor.run_badge("imdb", [x[:5].astype(np.int32)])
    _assert_same(got[0], want[0], "int32 ids")
    _, x_buf, valid = executor.program("imdb").args
    assert x_buf.dtype == torch.int64 and int(valid) == 5 and not x_buf[5:].any()


# -- threads: counters and the card gate -------------------------------------------


def test_launch_counters_survive_two_hammering_threads(monkeypatch):
    """``_add_counters`` from two threads at once (graph replays on the
    engine's worker threads) loses no update, and ``_read_counters`` reads
    whole sets."""
    monkeypatch.setattr(sys, "getswitchinterval", sys.getswitchinterval)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    before = rp._read_counters()
    reps, deltas = 20_000, [1, 0, 2, 3, 0, 1]
    try:
        threads = [threading.Thread(target=lambda: [rp._add_counters(deltas) for _ in range(reps)])
                   for _ in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    finally:
        sys.setswitchinterval(old)
    after = rp._read_counters()
    assert [a - b for a, b in zip(after, before)] == [2 * reps * d for d in deltas]
    rp._add_counters([-2 * reps * d for d in deltas])
    assert rp._read_counters() == before


def test_gate_capture_waits_for_walks_and_runs_alone():
    gate = rp.DeviceGate()
    events = []
    in_walk, release = threading.Event(), threading.Event()

    def walk():
        with gate.shared():
            with gate.shared():  # a thread may nest its walks
                events.append("walk")
                in_walk.set()
                release.wait(10)
            events.append("walk done")

    def capture():
        with gate.exclusive():
            events.append("capture")

    def late_walk():
        with gate.shared():
            events.append("late walk")

    w = threading.Thread(target=walk)
    w.start()
    in_walk.wait(10)
    c = threading.Thread(target=capture)
    c.start()
    time.sleep(0.05)
    late = threading.Thread(target=late_walk)
    late.start()
    time.sleep(0.05)
    assert events == ["walk"]  # the capture waits, and a new walk waits behind it
    release.set()
    for th in (w, c, late):
        th.join(10)
    assert events == ["walk", "walk done", "capture", "late walk"]
    with gate.shared():
        with pytest.raises(RuntimeError, match="inside a program walk"):
            with gate.exclusive():
                pass


def test_program_captures_under_the_gate(monkeypatch):
    """A program on the card captures with ``DEVICE_GATE`` held alone."""
    seen = []
    monkeypatch.setattr(rp.Program, "_capture",
                        lambda self: seen.append((rp.DEVICE_GATE._writer,
                                                  rp.DEVICE_GATE._readers)))
    prog = rp.Program(lambda *a: None, (), torch.device("cuda"))
    assert seen == [(True, 0)] and not rp.DEVICE_GATE._writer
    assert prog.bound is None and not prog.lock.locked()


def test_register_waits_for_a_dispatch_in_flight(online):
    """A capture (a second tenant's registration) cannot start while a
    dispatch holds the card: it waits for the dispatch to finish."""
    executor, tests, _, _, _, _ = online
    prog = executor.program("mnist")
    entered, release = threading.Event(), threading.Event()
    fn = prog.fn

    def slow(*args):
        entered.set()
        release.wait(10)
        return fn(*args)

    events = []
    prog.fn = slow
    try:
        d = threading.Thread(target=executor.run_badge, args=("mnist", [tests["mnist"][:3]]))
        d.start()
        entered.wait(10)

        def capture():
            with rp.DEVICE_GATE.exclusive():
                events.append(("capture", prog.lock.locked(), rp.DEVICE_GATE._readers))

        c = threading.Thread(target=capture)
        c.start()
        time.sleep(0.05)
        events.append("released")
        release.set()
        d.join(30)
        c.join(30)
    finally:
        prog.fn = fn
    assert events == ["released", ("capture", False, 0)]


@pytest.mark.skipif(torch.cuda.is_available(), reason="holds the refusal where no card is visible")
def test_executor_refuses_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FusedChainExecutor()
