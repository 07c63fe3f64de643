"""Run programs of the fused route: the whole per-run chain resolved once.

Counterpart of the JAX package's ``engine/run_program.py``.
``ops/fused_chain.py`` provides the chain (predict -> quantify ->
profile-pack) and rank (greedy CAM) functions; this module resolves the
chain into a program per (badge shape, dtype), or per group of models,
keyed by content fingerprints, and drives the badge walk for
``eval_prioritization`` behind ``TIP_FUSED_CHAIN=1``.

What a program is here: on the card, a CUDA graph, captured when the
program is resolved (a runner's first walk, or ``chain_program``), after a
warm-up on a side stream, and replayed once per badge over static input
and output buffers; on the CPU, the eager closure over the same buffers.
Every badge is padded to one shape (a 0-dim ``valid`` tensor masks the
padding), so a badge never pays setup. A capture that fails raises; nothing
runs the eager chain on the card instead. The rank runs eagerly: the greedy
reads the host every 32 picks.

A program owns its slots: its own copy of the model (for a group, one a
member, and the members' cut tables), built as ``BaseModel`` builds its
module so that the card runs the per-phase route's convolution algorithms
(weights of the same values in other tensors, through
``torch.func.functional_call``, made cuDNN pick other ones for MNIST's
second convolution). A runner binds its own weights into the slots by
device-to-device copies (``load_state_dict``) before its walk, so one
resolved program serves every model with the same fingerprint. Resolved programs are kept in
this process (``MAX_RESOLVED`` of them, least recently used out), keyed by
the fingerprints. The JAX package's on-disk executable store
(``TIP_PROGRAM_CACHE_DIR``, ``TIP_PROGRAM_CACHE_MAX_BYTES``) is not ported:
a captured CUDA graph cannot be serialised. Nor are its sharding arguments:
the port runs on one card.

A replay launches the kernels that its capture recorded (kernel B4 in the
IMDB chain) without calling their wrappers, so the program keeps the
wrappers' launch counters true: the capture's own increments are taken back
(a capture records a launch, it runs none) and each replay adds them again.
The runners count their dispatches as plain attributes
(``chain_dispatches``, ``rank_dispatches``, ``group_chain_dispatches``,
``select_dispatches``).

Device cost (``obs/devicemeter.py``): a CUDA graph has no XLA cost
analysis, so where a runner resolves or binds its chain program it stamps
the program's analytic cost (``devicemeter.chain_cost``: the family's
forward FLOPs and, for the convnets, its HBM bytes, plus the bytes of the
coverage metrics and the outputs, over the badge's rows; the grouped
chain's over every slot of the group) under ``chain`` / ``group_chain``. Each chain dispatch of a walk is timed (CUDA events on
the card, read after the walk's own synchronisation, so the timing adds
none; ``perf_counter`` on the CPU) and graded by
``devicemeter.observe_dispatch``. The rank (whose greedy picks depend on
the data) and the select record their latency only: they get no cost.

Threads (the scoring service dispatches from worker threads): a program
has one set of buffers, so a walk or a dispatch holds its ``lock`` from
binding weights to reading outputs; every walk holds ``DEVICE_GATE``
shared, and a capture holds it alone, because a CUDA graph capture fails,
or records another thread's work, while another thread uses the card. The
launch counters are read and added under a lock.

Env knobs: ``TIP_FUSED_CHAIN`` (off by default), ``TIP_INT8_PROFILES``
(the exact int8 coverage coding) and ``TIP_CHAIN_GROUP`` (models scored
per group dispatch), with the JAX package's grammar and messages.
"""

import collections
import contextlib
import copy
import hashlib
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from simple_tip_tpu_torch.device import DeviceLike, resolve
from simple_tip_tpu_torch.obs import devicemeter
from simple_tip_tpu_torch.engine.coverage_handler import PROFILE_BADGE_SIZE, CoverageWorker
from simple_tip_tpu_torch.engine.model_handler import DROPOUT_SAMPLE_SIZE, BaseModel
from simple_tip_tpu_torch.engine.sa_prep import BACKEND_TAG
from simple_tip_tpu_torch.models.predict import mc_dropout_votes, to_device
from simple_tip_tpu_torch.ops import dsa_cuda, flash_attention, fused_forward
from simple_tip_tpu_torch.ops.coverage import KMNC, NAC, NBC, SNAC
from simple_tip_tpu_torch.ops.fused_chain import (
    ThresholdCodebook,
    make_chain_fn,
    make_group_chain_fn,
    make_group_select_fn,
    make_select_fn,
    rank_badges,
    rank_badges_grouped,
)
from simple_tip_tpu_torch.ops.prioritizers import _with_score_tail
from simple_tip_tpu_torch.ops.timer import Timer
from simple_tip_tpu_torch.ops.uncertainty import POINT_PRED_QUANTIFIERS

#: Bump when the chain/rank program semantics change.
PROGRAM_FORMAT_VERSION = "run-program-torch-v1"
#: Resolved programs kept in the process (each holds its graph's memory).
MAX_RESOLVED = 4
#: Eager runs on a side stream before a capture (library handles, the
#: kernels' first build, the cut tables' upload).
WARMUP_RUNS = 2
#: The kernels' launch counters, kept true across graph replays.
KERNEL_COUNTERS = (
    (fused_forward, "LAUNCHES"),
    (fused_forward, "CIFAR_LAUNCHES"),
    (dsa_cuda, "LAUNCHES"),
    (flash_attention, "LAUNCHES"),
    (flash_attention, "BWD_DQ_LAUNCHES"),
    (flash_attention, "BWD_DKV_LAUNCHES"),
)

_RESOLVED: "collections.OrderedDict[str, Program]" = collections.OrderedDict()
_COUNTER_LOCK = threading.Lock()
#: (platform, device kind, count) per device, for dispatch grading.
_DEVICE_INFO: Dict[str, tuple] = {}


def _device_info(device: torch.device) -> tuple:
    key = str(device)
    if key not in _DEVICE_INFO:
        _DEVICE_INFO[key] = devicemeter.detect_device(device)
    return _DEVICE_INFO[key]


def _observe_dispatch(program: str, dt_s: float, device: torch.device) -> None:
    """Grade one measured dispatch against the program's analytic cost
    (the devicemeter registry, stamped where the program is bound)."""
    platform, kind, count = _device_info(device)
    devicemeter.observe_dispatch(program, dt_s, platform=platform, device_kind=kind,
                                 cores=count)


#: Bytes a chain writes per input besides its profiles: the int64
#: prediction and one f32 per uncertainty quantifier.
_HEAD_BYTES = 8 + 4 * len(POINT_PRED_QUANTIFIERS)


def _coverage_layout(metrics, n_neurons: int, int8: bool) -> tuple:
    """``(n_neurons, profile bits of each metric, threshold bytes)`` of one
    member's chain dispatch over ``n_neurons`` tapped neurons. With the
    int8 coding the threshold metrics read the codebook's cut table (an f32
    value, a bool and an int32 rank per neuron and cut) in place of their
    own thresholds; TKNC reads none."""
    n = int(n_neurons)
    bits, floats, cuts = [], 0, 0
    for m in metrics.values():
        if isinstance(m, NBC):
            bits.append(2 * n)
            floats, cuts = floats + 2 * n, cuts + 2
        elif isinstance(m, KMNC):
            bits.append(m.sections * n)
            floats, cuts = floats + 2 * n, cuts + m.sections + 1
        elif isinstance(m, SNAC):
            bits.append(n)
            floats, cuts = floats + n, cuts + 1
        else:
            bits.append(n)
            cuts += isinstance(m, NAC)
    return n, bits, 9 * n * cuts if int8 else 4 * floats


def _stamp_cost(program: str, model_def, rows: int, layout: tuple, members: int = 1) -> None:
    """Register ``program``'s analytic cost: ``members`` x ``rows`` chain
    rows of the family of ``model_def`` over the coverage ``layout``
    (``_coverage_layout``; none for a model without a count)."""
    n, bits, table_bytes = layout
    try:
        cost = devicemeter.chain_cost(getattr(model_def, "family", ""), members * rows, n, bits,
                                      table_bytes=members * table_bytes, head_bytes=_HEAD_BYTES)
    except ValueError:
        cost = None
    devicemeter.record_program_cost(program, cost)


class _DispatchClock:
    """Seconds of each dispatch of a walk: CUDA events on the card, read
    once the walk has synchronised; ``perf_counter`` on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []
        self._start = None

    def start(self) -> None:
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._start = time.perf_counter()

    def stop(self) -> None:
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        else:
            end = time.perf_counter()
        self.marks.append((self._start, end))

    def seconds(self) -> List[float]:
        if self.cuda:
            if self.marks:
                self.marks[-1][1].synchronize()
            return [s.elapsed_time(e) / 1e3 for s, e in self.marks]
        return [e - s for s, e in self.marks]


class DeviceGate:
    """A readers-writer gate over the card.

    Program walks and dispatches hold it ``shared()`` (many at once; a
    thread may nest them); a capture holds it ``exclusive()``, waiting for
    the walks in flight to leave, and new walks wait while a capture waits.
    A thread that holds it shared cannot capture: that would wait for
    itself, so it raises instead.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0
        self._local = threading.local()

    @contextlib.contextmanager
    def shared(self):
        depth = getattr(self._local, "depth", 0)
        if depth == 0:
            with self._cond:
                while self._writer or self._writers_waiting:
                    self._cond.wait()
                self._readers += 1
        self._local.depth = depth + 1
        try:
            yield
        finally:
            self._local.depth = depth
            if depth == 0:
                with self._cond:
                    self._readers -= 1
                    self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        if getattr(self._local, "depth", 0):
            raise RuntimeError("a capture was asked for by a thread inside a program walk")
        with self._cond:
            self._writers_waiting += 1
            while self._writer or self._readers:
                self._cond.wait()
            self._writers_waiting -= 1
            self._writer = True
        try:
            yield
        finally:
            with self._cond:
                self._writer = False
                self._cond.notify_all()


#: The process's gate over the card (``DeviceGate``).
DEVICE_GATE = DeviceGate()


def _knob_on(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in ("1", "on", "true")


def fused_chain_enabled() -> bool:
    """True when ``TIP_FUSED_CHAIN`` opts the prio path into fused dispatch."""
    return _knob_on("TIP_FUSED_CHAIN")


def int8_profiles_enabled() -> bool:
    """True when ``TIP_INT8_PROFILES`` opts into the exact int8 coding."""
    return _knob_on("TIP_INT8_PROFILES")


def chain_group_size() -> int:
    """Models scored per chain dispatch, from ``TIP_CHAIN_GROUP``.

    Empty / ``0`` / ``off`` / ``1`` means ungrouped (the per-model
    ``FusedChainRunner`` walk); a negative count is 1.
    """
    raw = os.environ.get("TIP_CHAIN_GROUP", "").strip().lower()
    if not raw or raw == "off":
        return 1
    try:
        g = int(raw)
    except ValueError:
        raise ValueError(
            f"TIP_CHAIN_GROUP={raw!r} not recognized "
            "(positive integer group size, or off)"
        )
    return max(g, 1)


def _update_array(h, arr: np.ndarray) -> None:
    h.update(str(arr.shape).encode() + str(arr.dtype).encode())
    h.update(np.ascontiguousarray(arr).tobytes())


def _metric_signature(metric) -> str:
    """Content hash of one coverage metric's configuration (its thresholds
    are read by the chain, so they key it)."""
    h = hashlib.sha256()
    h.update(type(metric).__name__.encode())
    for k in sorted(vars(metric)):
        v = vars(metric)[k]
        h.update(k.encode())
        if isinstance(v, torch.Tensor):
            _update_array(h, v.detach().cpu().numpy())
        elif isinstance(v, np.ndarray):
            _update_array(h, v)
        else:
            h.update(repr(v).encode())
    return h.hexdigest()


def _tags_and_versions(h, tags) -> None:
    h.update(BACKEND_TAG.encode())
    h.update(torch.__version__.encode())
    for tag in tags:
        h.update(str(tag).encode())


def program_fingerprint(
    model_def, params, layer_ids, metrics: Dict, x_shape, x_dtype, *tags
) -> str:
    """Fingerprint of one chain program: the format version, the module's
    ``repr`` (its layer configuration), the tap ids, every metric's
    threshold content, the parameter leaves' shapes and dtypes (their
    values are the program's inputs, bound before each walk), the badge
    shape and dtype, the ``torch`` tag, torch's version and the tags
    (``chain`` / ``group_chain``, the int8 mode, the device)."""
    h = hashlib.sha256()
    h.update(PROGRAM_FORMAT_VERSION.encode())
    h.update(repr(model_def).encode())
    h.update(repr(list(layer_ids)).encode())
    for mid in sorted(metrics):
        h.update(mid.encode())
        h.update(_metric_signature(metrics[mid]).encode())
    for name in sorted(params):
        leaf = params[name]
        h.update(name.encode())
        h.update(str(tuple(np.shape(leaf))).encode())
        h.update(str(getattr(leaf, "dtype", type(leaf).__name__)).encode())
    h.update(str(tuple(x_shape)).encode() + str(x_dtype).encode())
    _tags_and_versions(h, tags)
    return h.hexdigest()


def select_fingerprint(n: int, k: int, *tags) -> str:
    """Fingerprint of one AL top-k select program (shape-keyed)."""
    h = hashlib.sha256()
    h.update(PROGRAM_FORMAT_VERSION.encode())
    h.update(f"select:{n}topk{k}".encode())
    _tags_and_versions(h, tags)
    return h.hexdigest()


def _read_counters() -> List[int]:
    with _COUNTER_LOCK:
        return [getattr(module, attr) for module, attr in KERNEL_COUNTERS]


def _add_counters(deltas: Sequence[int]) -> None:
    with _COUNTER_LOCK:
        for (module, attr), d in zip(KERNEL_COUNTERS, deltas):
            if d:
                setattr(module, attr, getattr(module, attr) + d)


class Program:
    """One resolved program: ``fn(*args)`` over static tensors ``args``
    (nested dicts and tuples of tensors).

    Callers write a badge's values (and a runner its weights) into ``args``
    in place and call the program; on the card it replays a CUDA graph and
    returns its static outputs (overwritten by the next replay), on the CPU
    it runs ``fn``. They hold ``lock`` from the first write to the last
    read; ``bound`` is the runner whose weights are in ``args``. The
    capture holds ``DEVICE_GATE`` alone.
    """

    def __init__(self, fn, args: tuple, device: torch.device):
        self.fn = fn
        self.args = args
        self.device = device
        self.graph = None
        self.outputs = None
        self.recorded = [0] * len(KERNEL_COUNTERS)
        self.lock = threading.Lock()
        self.bound = None
        if device.type == "cuda":
            with DEVICE_GATE.exclusive():
                self._capture()

    @torch.no_grad()
    def _capture(self) -> None:
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                self.fn(*self.args)
        stream.wait_stream(side)
        before = _read_counters()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outputs = self.fn(*self.args)
        after = _read_counters()
        self.recorded = [a - b for a, b in zip(after, before)]
        _add_counters([-d for d in self.recorded])
        self.graph, self.outputs = graph, outputs

    @torch.no_grad()
    def __call__(self):
        if self.graph is None:
            return self.fn(*self.args)
        self.graph.replay()
        _add_counters(self.recorded)
        return self.outputs


def resolve_program(key: str, build) -> Program:
    """The process's resolved program under fingerprint ``key``, or
    ``build()``'s, kept (least recently used out past ``MAX_RESOLVED``)."""
    prog = _RESOLVED.get(key)
    if prog is None:
        prog = build()
        _RESOLVED[key] = prog
        while len(_RESOLVED) > MAX_RESOLVED:
            _RESOLVED.popitem(last=False)
    else:
        _RESOLVED.move_to_end(key)
    return prog


def _net_on(model_def, state: Dict[str, torch.Tensor], device: torch.device):
    """A program's own copy of the model, built as ``BaseModel`` builds its
    module (so the card runs the same convolution algorithms for it as for
    the per-phase route's), with the weights ``state``."""
    net = copy.deepcopy(model_def).to(device).eval()
    net.load_state_dict(state)
    return net


def badge_layout(x: np.ndarray, badge_size: int, device: torch.device):
    """``(shape, dtype, strides)`` of one badge of ``x`` as ``to_device``
    lays it out on ``device``, the layout of the per-phase route's badges.

    The strides matter: a size-1 dimension's stride is free, and the
    convolutions read it. MNIST's one-channel images from the loaders upload
    with a channel stride of 0, and a badge buffer with the default stride
    1 made cuDNN take the channels-last path, whose other algorithms set 5
    rows' NAC_0 and NBC_0 bits apart from the per-phase route's.
    """
    sample = to_device(x[:1], device)
    shape = (badge_size,) + tuple(sample.shape[1:])
    strides = (int(np.prod(shape[1:])),) + tuple(sample.stride()[1:])
    return shape, sample.dtype, strides


def _badge_buffer(x_shape, x_dtype, x_strides, device: torch.device) -> torch.Tensor:
    """A zeroed badge buffer (zero is a valid token id) in the given layout
    (contiguous where ``x_strides`` is None)."""
    if x_strides is None:
        return torch.zeros(tuple(x_shape), dtype=x_dtype, device=device)
    return torch.empty_strided(tuple(x_shape), tuple(x_strides), dtype=x_dtype,
                               device=device).zero_()


def _load_badge(x_buf, valid_buf, xs, start: int) -> None:
    """The badge of ``xs`` at ``start`` into a program's buffers, its tail
    zeroed (zero is a valid token id) and counted out by ``valid``."""
    bs = x_buf.shape[0]
    valid = min(bs, xs.shape[0] - start)
    x_buf[:valid].copy_(xs[start : start + valid])
    if valid < bs:
        x_buf[valid:].zero_()
    valid_buf.fill_(valid)


def _sanity_check(order: np.ndarray, scores: np.ndarray) -> None:
    if not len(order) == len(set(order.tolist())) == scores.shape[0]:
        raise RuntimeError("CAM order is not unique or not complete")


def _variation_ratio(net, x, seed: int, batch_size: int, device):
    """MC-dropout VR as the per-phase route computes it (same vote function,
    generator seed and batch policy); returns (vr, [0, sampling, quant, 0])."""
    generator = torch.Generator(device=device).manual_seed(seed)
    with Timer(device=device) as sampling_timer:
        counts = mc_dropout_votes(
            net, x, n_samples=DROPOUT_SAMPLE_SIZE, generator=generator,
            batch_size=max(batch_size, 128), device=device,
        )
    with Timer(device=device) as quant_timer:
        majority_count = counts.max(dim=1).values.cpu().numpy()
        vr = 1.0 - majority_count / DROPOUT_SAMPLE_SIZE
    return vr, [0, sampling_timer.get(), quant_timer.get(), 0]


class _Walk:
    """Device accumulators of one badge walk: every output row of every
    badge (padding included) written in place after each dispatch."""

    def __init__(self):
        self.acc = None

    def add(self, start: int, outputs, rows: int) -> None:
        pred, unc, cov = outputs
        flat = {("pred",): pred, **{("unc", k): v for k, v in unc.items()}}
        for mid, (s, p) in cov.items():
            flat[("score", mid)] = s
            flat[("packed", mid)] = p
        if self.acc is None:
            # the badge axis is the last but the packed words' one
            self.acc = {}
            for key, v in flat.items():
                axis = v.dim() - (2 if key[0] == "packed" else 1)
                shape = list(v.shape)
                shape[axis] = rows
                self.acc[key] = (torch.empty(shape, dtype=v.dtype, device=v.device), axis)
        bs = pred.shape[-1]
        for key, v in flat.items():
            dst, axis = self.acc[key]
            dst.narrow(axis, start, bs).copy_(v)

    def host(self, key, n: int) -> np.ndarray:
        dst, axis = self.acc[key]
        return dst.narrow(axis, 0, n).cpu().numpy()

    def packed(self, mid: str) -> torch.Tensor:
        return self.acc[("packed", mid)][0]

    def uncertainties(self, n: int) -> Dict[str, np.ndarray]:
        return {key[1]: self.host(key, n) for key in self.acc if key[0] == "unc"}


class FusedChainRunner:
    """One model's fused prio evaluation.

    Owns a ``CoverageWorker`` for its configured metrics, training
    statistics (shared through the coverage-statistics cache) and per-metric
    setup debits, so the thresholds the chain reads are the per-phase
    route's. Resolves one chain program per badge shape (padded badges) and
    one select program per (padded n, k); the rank runs eagerly per metric.
    ``params`` is the bridge's output for ``model_def``.
    """

    def __init__(
        self,
        model_def,
        params,
        training_set: np.ndarray,
        nc_layers,
        batch_size: int = 32,
        badge_size: Optional[int] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve(device)
        self.batch_size = batch_size
        self.badge_size = badge_size or PROFILE_BADGE_SIZE
        self.layer_ids = tuple(i for i in nc_layers if isinstance(i, int))
        self.int8 = int8_profiles_enabled()
        self.base_model = BaseModel(
            model_def, params, activation_layers=nc_layers, batch_size=batch_size,
            device=self.device,
        )
        self.model_def = model_def
        self.net = self.base_model.net
        self.worker = CoverageWorker(base_model=self.base_model, training_set=training_set)
        # tapped neurons: the training statistics hold one tensor a layer
        self._layout = _coverage_layout(
            self.worker.metrics, sum(int(t.numel()) for t in self.worker.stats[0]), self.int8)
        self.weights = self.net.state_dict()
        self._programs: Dict[tuple, Program] = {}
        self._select_programs: Dict[tuple, Program] = {}
        self.chain_dispatches = 0
        self.rank_dispatches = 0
        self.select_dispatches = 0

    # -- program resolution --------------------------------------------------

    def chain_program(self, x_shape, x_dtype, x_strides=None) -> Program:
        """The chain program for one badge shape, dtype and layout
        (``badge_layout``; contiguous by default), resolved (on the card:
        captured) now if it is not yet, with this runner's weights bound."""
        key = (tuple(x_shape), str(x_dtype), x_strides)
        prog = self._programs.get(key)
        if prog is None:
            fp = program_fingerprint(
                self.net, self.weights, self.layer_ids, self.worker.metrics, x_shape,
                x_dtype, "chain", f"int8={self.int8}", f"device={self.device}",
                f"strides={x_strides}",
            )

            def build():
                chain = make_chain_fn(self.layer_ids, self.worker.metrics, int8_profiles=self.int8)
                net = _net_on(self.model_def, self.weights, self.device)
                x_buf = _badge_buffer(x_shape, x_dtype, x_strides, self.device)
                valid = torch.zeros((), dtype=torch.int32, device=self.device)
                return Program(chain, (net, x_buf, valid), self.device)

            prog = resolve_program(fp, build)
            self._programs[key] = prog
        _stamp_cost("chain", self.model_def, x_shape[0], self._layout)
        with prog.lock:
            self.bind(prog)
        return prog

    def bind(self, prog: Program) -> None:
        """This runner's weights into ``prog``'s model slot (by
        device-to-device copies) unless they are there already; the caller
        holds ``prog.lock``."""
        if prog.bound is not self:
            prog.args[0].load_state_dict(self.weights)
            prog.bound = self

    def select_program(self, n: int, k: int) -> Program:
        """The AL top-k select program over an [n] vector."""
        key = (int(n), int(k))
        prog = self._select_programs.get(key)
        if prog is None:
            fp = select_fingerprint(n, k, f"device={self.device}")

            def build():
                values = torch.zeros(int(n), dtype=torch.float32, device=self.device)
                valid = torch.zeros((), dtype=torch.int32, device=self.device)
                return Program(make_select_fn(int(k)), (values, valid), self.device)

            prog = resolve_program(fp, build)
            self._select_programs[key] = prog
        return prog

    def select_top_k(self, values: np.ndarray, k: int) -> np.ndarray:
        """AL top-k select of one host [n] score vector through the select
        program (padded to a badge multiple, so ragged sizes share one):
        equal to ``np.argsort(values, kind="stable")[-k:]``."""
        values = np.asarray(values, np.float32)
        n = values.shape[0]
        if not 0 < k <= n:
            raise ValueError(f"select_top_k: k={k} outside 1..{n}")
        padded_n = -(-n // self.badge_size) * self.badge_size
        prog = self.select_program(padded_n, k)
        buf, valid = prog.args
        buf.zero_()
        buf[:n].copy_(torch.from_numpy(values))
        valid.fill_(n)
        t0 = time.perf_counter()
        picked = prog().cpu().numpy()
        _observe_dispatch("select", time.perf_counter() - t0, self.device)
        self.select_dispatches += 1
        return picked.astype(np.int64)

    # -- evaluation ----------------------------------------------------------

    def _walk(self, x: np.ndarray):
        """The chain over every badge of ``x``: host ``pred``, uncertainties
        and scores, the device accumulators (the packed profiles the ranks
        read) and the walk's seconds."""
        n = int(x.shape[0])
        bs = self.badge_size
        n_pad = -(-n // bs) * bs
        walk = _Walk()
        # resolved (captured) before the clock, as a compile is in the JAX
        # package: the chain's seconds are the badges'
        prog = self.chain_program(*badge_layout(x, bs, self.device))
        clock = _DispatchClock(self.device)
        with DEVICE_GATE.shared(), prog.lock, Timer(device=self.device) as chain_timer:
            self.bind(prog)
            xs = to_device(x, self.device)
            _, x_buf, valid_buf = prog.args
            for start in range(0, n, bs):
                _load_badge(x_buf, valid_buf, xs, start)
                clock.start()
                outputs = prog()
                clock.stop()
                walk.add(start, outputs, n_pad)
                self.chain_dispatches += 1
            pred = walk.host(("pred",), n)
            uncertainties = walk.uncertainties(n)
            scores = {mid: walk.host(("score", mid), n) for mid in self.worker.metrics}
        for dt in clock.seconds():
            _observe_dispatch("chain", dt, self.device)
        return pred, uncertainties, scores, walk, chain_timer.get()

    def score_dataset(self, x: np.ndarray) -> Dict:
        """``pred``, ``uncertainties`` and ``scores`` of one test set: what
        ``evaluate_dataset`` returns of them, from the same badge walk,
        without the ranks."""
        pred, uncertainties, scores, _, _ = self._walk(x)
        return {"pred": pred, "uncertainties": uncertainties, "scores": scores}

    def evaluate_dataset(self, x: np.ndarray, seed: Optional[int] = None, select_k=None) -> Dict:
        """Fused prio evaluation of one test set.

        Returns ``pred`` (host [n]), ``uncertainties`` / ``unc_times``,
        per-metric ``scores`` / ``cam_orders`` / ``cov_times``: the values
        and records the per-phase fault predictors and ``CoverageWorker``
        produce, from one chain dispatch per badge and one rank per metric.
        ``seed`` adds MC-dropout VR (a model with dropout) from the per-phase
        route's generator seed; ``select_k`` adds ``al_select``
        ({quantifier: indices of the k most uncertain inputs, ascending by
        value, best last}).
        """
        pred, uncertainties, scores, walk, chain_s = self._walk(x)

        # the one chain dispatch covers predict and quantify: its time is the
        # shared prediction time, with a zero quantify entry
        unc_times = {name: [0, chain_s, 0.0, 0] for name in uncertainties}
        cov_times = {mid: [self.worker.setup_times[mid], chain_s, 0.0] for mid in self.worker.metrics}
        cam_orders = {}
        for mid in self.worker.metrics:
            with Timer(device=self.device) as timer:
                picked = rank_badges((walk.packed(mid),)).cpu().numpy()
                order = _with_score_tail(scores[mid], picked)
            self.rank_dispatches += 1
            cov_times[mid].append(timer.get())
            _observe_dispatch("rank", timer.get(), self.device)
            _sanity_check(order, scores[mid])
            cam_orders[mid] = order
        if seed is not None and getattr(self.net, "has_dropout", False):
            uncertainties["VR"], unc_times["VR"] = _variation_ratio(
                self.net, x, seed, self.batch_size, self.device
            )
        result = {
            "pred": pred,
            "uncertainties": uncertainties,
            "unc_times": unc_times,
            "scores": scores,
            "cam_orders": cam_orders,
            "cov_times": cov_times,
        }
        if select_k:
            result["al_select"] = {
                name: self.select_top_k(u, int(select_k)) for name, u in uncertainties.items()
            }
        return result


class StagedParams:
    """A group's weights on their way to the device: one state dict a
    member, uploaded by non-blocking copies from pinned memory on a side
    stream, the padding members of a ragged tail sharing member 0's upload;
    ``ready()`` makes the current stream wait for them and returns the G
    state dicts."""

    def __init__(self, members: List[Dict[str, torch.Tensor]], group_size: int,
                 device: torch.device):
        self.device = device
        self.event = None
        pad = group_size - len(members)
        if device.type != "cuda":
            self.members = list(members) + [members[0]] * pad
            return
        self._pinned = [{k: v.contiguous().pin_memory() for k, v in m.items()} for m in members]
        uploaded = [
            {k: torch.empty(v.shape, dtype=v.dtype, device=device) for k, v in m.items()}
            for m in self._pinned
        ]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for src, dst in zip(self._pinned, uploaded):
                for k, v in src.items():
                    dst[k].copy_(v, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(side)
        self.members = uploaded + [uploaded[0]] * pad

    def ready(self) -> List[Dict[str, torch.Tensor]]:
        if self.event is not None:
            torch.cuda.current_stream(self.device).wait_event(self.event)
        return self.members


class GroupChainRunner:
    """G models' fused prio evaluation, one group dispatch per badge.

    The study walks R independently trained runs over the same test inputs;
    this runner stages G members' weights (``stage``) and scores a badge
    for all of them with one program, so R runs cost ceil(R/G) dispatches per
    badge instead of R. One ``CoverageWorker`` per member: each member's
    thresholds come from its own training statistics, exactly as the
    per-model walk computes them (the parity precondition); they ride the
    program as each member's ``ThresholdCodebook.table``, so one program
    serves every group of the same structure. A ragged last group
    (``len(params_list) < group_size``) is padded with member 0 and a
    ``members`` count zeroes the padding members' packed profiles.

    How a group's weights reach the program: the program owns one slot, G
    model copies and the stacked tables, and each walk starts with
    device-to-device copies into it from the staged upload (after its
    event). The upload is one state dict a member, not stacked per leaf as
    the JAX package's vmapped program needs: the program here runs the G
    module copies one after another (one graph replay, no arithmetic
    batched across members), so a stacked upload would only be split
    again. One graph then serves every group: two alternating slots would
    need two captures, each with its own memory pool, to save copies of
    well under a millisecond (G x 0.14 MB of MNIST weights), and the copies
    are stream-ordered after the previous group's last replay, so they
    cannot race it.

    ``evaluate_dataset`` returns one result per real member, each with
    ``FusedChainRunner.evaluate_dataset``'s contract.
    """

    def __init__(
        self,
        model_def,
        params_list,
        training_set: np.ndarray,
        nc_layers,
        batch_size: int = 32,
        badge_size: Optional[int] = None,
        group_size: Optional[int] = None,
        staged_params: Optional[StagedParams] = None,
        device: DeviceLike = None,
    ):
        if not params_list:
            raise ValueError("GroupChainRunner needs at least one member")
        self.device = resolve(device)
        self.params_list = list(params_list)
        self.n_members = len(self.params_list)
        self.group_size = int(group_size or self.n_members)
        if self.n_members > self.group_size:
            raise ValueError(f"{self.n_members} members exceed group_size={self.group_size}")
        self.batch_size = batch_size
        self.badge_size = badge_size or PROFILE_BADGE_SIZE
        self.layer_ids = tuple(i for i in nc_layers if isinstance(i, int))
        self.workers = [
            CoverageWorker(
                base_model=BaseModel(model_def, p, activation_layers=nc_layers,
                                     batch_size=batch_size, device=self.device),
                training_set=training_set,
            )
            for p in self.params_list
        ]
        self._codebooks = [ThresholdCodebook(w.metrics) for w in self.workers]
        sig0 = self._codebooks[0].spec_signature()
        for g, cb in enumerate(self._codebooks[1:], start=1):
            if cb.spec_signature() != sig0:
                raise ValueError(
                    f"member {g} metric structure differs from member 0; "
                    "group members must share metric configuration"
                )
        self._spec_sig = hashlib.sha256(repr(sig0).encode()).hexdigest()
        self.metrics = self.workers[0].metrics
        self.model_def = model_def
        self.net = self.workers[0].base_model.net
        self.staged = (
            staged_params
            if staged_params is not None
            else self.stage(self.params_list, self.group_size, self.device)
        )
        self._programs: Dict[tuple, Program] = {}
        self._select_programs: Dict[tuple, Program] = {}
        self._tables_bound = None
        self.group_chain_dispatches = 0
        self.rank_dispatches = 0
        self.select_dispatches = 0

    @staticmethod
    def stage(params_list, group_size: Optional[int] = None, device: DeviceLike = None):
        """Start the upload of the members' weights; a ragged tail is padded
        to ``group_size`` by repeating member 0. Staging group i+1 before
        walking group i lets the upload overlap the walk."""
        g = int(group_size or len(params_list))
        return StagedParams([p["module"] for p in params_list], g, resolve(device))

    # -- program resolution ---------------------------------------------------

    def _n_neurons(self, x: np.ndarray) -> int:
        """Width of the flattened taps (one row through member 0)."""
        acts = self.workers[0].base_model.get_activations(x[:1])
        return sum(int(np.prod(a.shape[1:])) for a in acts)

    def _tables(self, n_neurons: int):
        """The members' cut tables stacked over G (padding members repeat
        member 0's)."""
        per_member = [cb.table(n_neurons) for cb in self._codebooks]
        per_member += [per_member[0]] * (self.group_size - self.n_members)
        return tuple(np.stack([t[i] for t in per_member]) for i in range(3))

    def chain_program(self, x: np.ndarray, x_shape, x_dtype, x_strides=None) -> Program:
        """The group chain program for one badge shape, dtype and layout of
        ``x``'s rows, with this group's weights and tables bound."""
        n_neurons = self._n_neurons(x)
        tables = self._tables(n_neurons)
        key = (tuple(x_shape), str(x_dtype), x_strides)
        prog = self._programs.get(key)
        weights = self.staged.ready()
        if prog is None:
            # thresholds are inputs here, so only the coding structure keys
            # the program; the metrics the codebook does not cover (TKNC) are
            # read from member 0 and key it as usual
            baked = {mid: m for mid, m in self.metrics.items()
                     if not self._codebooks[0].covers(mid)}
            fp = program_fingerprint(
                self.net, weights[0], self.layer_ids, baked, x_shape, x_dtype, "group_chain",
                f"group={self.group_size}", f"spec={self._spec_sig}",
                f"table={n_neurons}x{self._codebooks[0].num_cuts}", f"device={self.device}",
                f"strides={x_strides}",
            )

            def build():
                group_chain = make_group_chain_fn(self.layer_ids, self.metrics)
                nets = [_net_on(self.model_def, w, self.device) for w in weights]
                table_slot = tuple(torch.from_numpy(t).to(self.device) for t in tables)
                x_buf = _badge_buffer(x_shape, x_dtype, x_strides, self.device)
                scalars = [torch.zeros((), dtype=torch.int32, device=self.device)
                           for _ in range(2)]
                return Program(group_chain,
                               (nets, table_slot, x_buf, *scalars), self.device)

            prog = resolve_program(fp, build)
            self._programs[key] = prog
        _stamp_cost("group_chain", self.model_def, x_shape[0],
                    _coverage_layout(self.metrics, n_neurons, int8=True), self.group_size)
        self._tables_bound = tables
        with prog.lock:
            prog.bound = None
            self.bind(prog)
        return prog

    def bind(self, prog: Program) -> None:
        """This group's staged weights and cut tables into ``prog``'s slots
        unless they are there already; the caller holds ``prog.lock``."""
        if prog.bound is not self:
            nets, table_slot = prog.args[:2]
            for net, w in zip(nets, self.staged.ready()):
                net.load_state_dict(w)
            for dst, src in zip(table_slot, self._tables_bound):
                dst.copy_(torch.from_numpy(src))
            prog.bound = self

    def select_program(self, n: int, k: int) -> Program:
        """The group AL top-k select program over a [G, n] matrix."""
        key = (int(n), int(k))
        prog = self._select_programs.get(key)
        if prog is None:
            fp = select_fingerprint(n, k, f"group={self.group_size}", f"device={self.device}")

            def build():
                values = torch.zeros((self.group_size, int(n)), dtype=torch.float32,
                                     device=self.device)
                valid = torch.zeros((), dtype=torch.int32, device=self.device)
                return Program(make_group_select_fn(int(k)), (values, valid),
                               self.device)

            prog = resolve_program(fp, build)
            self._select_programs[key] = prog
        return prog

    # -- evaluation -----------------------------------------------------------

    def evaluate_dataset(self, x: np.ndarray, seeds=None, select_k=None) -> List[Dict]:
        """Grouped prio evaluation of one test set: one chain dispatch per
        badge scores every member, then one rank per metric and member.

        Returns one result dict per real member, in constructor order, each
        with ``FusedChainRunner.evaluate_dataset``'s contract; ``seeds`` is
        the per-member VR seed list (the vote passes stay per member, so
        each member's generator stream is the per-model walk's). The group's
        chain and rank seconds are split evenly over the members.
        """
        n = int(x.shape[0])
        bs = self.badge_size
        m = self.n_members
        n_pad = -(-n // bs) * bs
        walk = _Walk()
        prog = self.chain_program(x, *badge_layout(x, bs, self.device))
        clock = _DispatchClock(self.device)
        with DEVICE_GATE.shared(), prog.lock, Timer(device=self.device) as chain_timer:
            self.bind(prog)
            xs = to_device(x, self.device)
            _, _, x_buf, valid_buf, members_buf = prog.args
            members_buf.fill_(m)
            for start in range(0, n, bs):
                _load_badge(x_buf, valid_buf, xs, start)
                clock.start()
                outputs = prog()
                clock.stop()
                walk.add(start, outputs, n_pad)
                self.group_chain_dispatches += 1
            pred = walk.host(("pred",), n)
            unc = walk.uncertainties(n)
            scores = {mid: walk.host(("score", mid), n) for mid in self.metrics}
        for dt in clock.seconds():
            _observe_dispatch("group_chain", dt, self.device)
        share = chain_timer.get() / m
        results = []
        for g in range(m):
            results.append({
                "pred": pred[g],
                "uncertainties": {name: u[g] for name, u in unc.items()},
                "unc_times": {name: [0, share, 0.0, 0] for name in unc},
                "scores": {mid: s[g] for mid, s in scores.items()},
                "cam_orders": {},
                "cov_times": {mid: [self.workers[g].setup_times[mid], share, 0.0]
                              for mid in self.metrics},
            })
        for mid in self.metrics:
            with Timer(device=self.device) as timer:
                picks = [p.cpu().numpy() for p in rank_badges_grouped((walk.packed(mid)[:m],))]
            self.rank_dispatches += 1
            _observe_dispatch("group_rank", timer.get(), self.device)
            for g in range(m):
                order = _with_score_tail(results[g]["scores"][mid], picks[g])
                _sanity_check(order, results[g]["scores"][mid])
                results[g]["cam_orders"][mid] = order
                results[g]["cov_times"][mid].append(timer.get() / m)
        if seeds is not None and getattr(self.net, "has_dropout", False):
            for g in range(m):
                r = results[g]
                r["uncertainties"]["VR"], r["unc_times"]["VR"] = _variation_ratio(
                    self.workers[g].base_model.net, x, seeds[g], self.batch_size, self.device
                )
        if select_k:
            padded_n = -(-n // bs) * bs
            sel = self.select_program(padded_n, int(select_k))
            buf, valid = sel.args
            valid.fill_(n)
            for name in results[0]["uncertainties"]:
                vals = np.zeros((self.group_size, padded_n), np.float32)
                for g in range(m):
                    vals[g, :n] = np.asarray(results[g]["uncertainties"][name], np.float32)
                buf.copy_(torch.from_numpy(vals))
                t0 = time.perf_counter()
                picked = sel().cpu().numpy()
                _observe_dispatch("group_select", time.perf_counter() - t0, self.device)
                self.select_dispatches += 1
                for g in range(m):
                    results[g].setdefault("al_select", {})[name] = picked[g].astype(np.int64)
        return results
