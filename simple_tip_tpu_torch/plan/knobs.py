"""The typed knob space the execution planner searches.

Counterpart of the JAX package's ``plan/knobs.py``. Each :class:`Knob`
declares its env var, its **legal values** (the planner never invents a
value a consumer would reject), its default, and **which cost-model
features it moves** (``obs/costmodel.py`` fits ``[1, cpu?, log1p(count),
log1p(batch), log(group)]`` per phase, divided by workers), so
``plan/search.py`` knows which knobs the learned model can distinguish and
which it scores identically (those keep their default, and ``plan
explain`` says so).

The space is the knobs a module of the port reads: ``fused_chain``,
``group_size``, ``max_badge``, ``worker_platforms`` and ``workers``, each
with the JAX package's legal values and default. The JAX package's
``batch`` (a batch size quoted to its benchmark, which the port does not
have yet), ``cluster_backend``, ``sa_fanout``, ``sa_mem_frac`` and
``sa_pool`` (the sklearn backend, the SA fit pool) steer nothing in the
port: they are in ``NOT_PORTED``, and a plan or a ``--set`` naming one is
refused with a message that says so. Without a ``batch`` knob every
prediction is made at ``batch=None``, as the port's own rows carry none.

Library code must not write these env vars into ``os.environ`` directly:
a hardcoded knob is invisible to the planner, to ``plan explain`` and to
the plan-vs-actual audit. Stdlib only.
"""

from typing import Dict, Iterable, Optional, Tuple

#: Cost-model feature names a knob may move (see ``costmodel._features``
#: plus the ``workers`` divisor in ``predict_study``).
FEATURES = ("platform", "batch", "workers", "group")


class Knob:
    """One tunable: env var, legal values, and its cost-model effect.

    ``param`` names the prediction parameter the value maps onto
    identically (``workers`` / ``group``); ``effects`` maps specific
    values to prediction-parameter overrides (e.g. ``worker_platforms:
    cpu -> {"platform": "cpu"}``). A knob with neither moves no feature
    the model fits: the search keeps its default and the plan records
    that honestly.
    """

    __slots__ = ("name", "env", "values", "default", "features", "param",
                 "effects", "doc")

    def __init__(self, name: str, env: str, values: Tuple, default,
                 doc: str, features: Tuple[str, ...] = (),
                 param: Optional[str] = None, effects: Optional[dict] = None):
        if default not in values:
            raise ValueError(f"knob {name}: default {default!r} not legal")
        for f in features:
            if f not in FEATURES:
                raise ValueError(f"knob {name}: unknown feature {f!r}")
        self.name = name
        self.env = env
        self.values = tuple(values)
        self.default = default
        self.features = tuple(features)
        self.param = param
        self.effects = dict(effects or {})
        self.doc = doc

    def legal(self, value) -> bool:
        """Whether ``value`` is one of this knob's declared legal values."""
        return value in self.values

    def prediction_overrides(self, value) -> dict:
        """Cost-model parameter overrides this knob value implies."""
        out = dict(self.effects.get(value, {}))
        if self.param is not None:
            out[self.param] = value
        return out

    def coerce(self, raw: str):
        """Parse a CLI/env string into this knob's typed legal value.

        Raises ``ValueError`` (naming the legal values) on anything else —
        the planner never silently accepts a value a consumer would
        reject at launch time.
        """
        for v in self.values:
            if str(v) == str(raw).strip():
                return v
        raise ValueError(
            f"knob {self.name}: {raw!r} is not legal "
            f"(legal: {', '.join(str(v) for v in self.values)})"
        )


#: The knob space, in the deterministic order the search walks it.
KNOBS: Tuple[Knob, ...] = (
    Knob(
        "fused_chain", "TIP_FUSED_CHAIN", ("0", "1"), "0",
        doc="the fused chain route: CUDA-graph run programs "
            "(engine/run_program.py); "
            "indistinguishable to the current cost-model features, so the "
            "default is kept unless pinned",
    ),
    Knob(
        "group_size", "TIP_CHAIN_GROUP", (1, 2, 4, 8), 1,
        doc="cross-run dispatch fusion: models scored per chain dispatch "
            "(engine/run_program.GroupChainRunner; effective only with "
            "fused_chain on); moves the cost model's log(group) feature "
            "and adds ~G x param-bytes stacked-weights residency to the "
            "device-memory constraint",
        features=("group",), param="group",
    ),
    Knob(
        "max_badge", "TIP_SERVE_MAX_BADGE", (256, 512, 1024, 2048), 2048,
        doc="serving badge size bound (serving/knobs.py); the admission "
            "backlog bound divides by it",
    ),
    Knob(
        "worker_platforms", "TIP_WORKER_PLATFORMS", ("default", "cpu"),
        "default",
        doc="scheduler worker platform policy (parallel/run_scheduler.py); "
            "'cpu' pins every worker off the card",
        features=("platform",), effects={"cpu": {"platform": "cpu"}},
    ),
    Knob(
        "workers", "TIP_NUM_WORKERS", (1, 2, 4, 8), 1,
        doc="per-host scheduler worker processes; divides every per-phase "
            "wall-clock prediction (ideal packing)",
        features=("workers",), param="workers",
    ),
)

_BY_NAME: Dict[str, Knob] = {k.name: k for k in KNOBS}

#: The JAX package's knobs whose code the port does not have: name ->
#: (env var, why). A plan naming one is refused, never half-applied.
NOT_PORTED: Dict[str, Tuple[str, str]] = {
    "batch": (
        "TIP_PLAN_BATCH",
        "no module of the port reads it: it is the batch size the JAX "
        "package's benchmark quotes, and the port has no benchmark yet",
    ),
    "cluster_backend": (
        "TIP_CLUSTER_BACKEND",
        "the port's SA fits run one backend (ops/cluster.py); the sklearn "
        "backend is not ported",
    ),
    "sa_fanout": ("TIP_SA_FANOUT", "the SA fit fan-out is not ported"),
    "sa_mem_frac": ("TIP_SA_MEM_FRAC", "the SA fit pool is not ported"),
    "sa_pool": ("TIP_SA_POOL", "the SA fit pool is not ported"),
}


def knob(name: str) -> Knob:
    """The knob named ``name``; ``KeyError`` with the catalogue for an
    unknown name, and with the reason for one of ``NOT_PORTED``."""
    try:
        return _BY_NAME[name]
    except KeyError:
        if name in NOT_PORTED:
            env, why = NOT_PORTED[name]
            raise KeyError(
                f"knob {name!r} ({env}) is not ported: {why}"
            ) from None
        raise KeyError(
            f"unknown knob {name!r} (knobs: {', '.join(sorted(_BY_NAME))})"
        ) from None


def all_knobs() -> Tuple[Knob, ...]:
    """Every registered knob, in search order."""
    return KNOBS


def planned_env_vars() -> frozenset:
    """Env vars owned by the plan/knobs registry: library code writes
    none of them into ``os.environ`` directly."""
    return frozenset(k.env for k in KNOBS)


_BY_ENV: Dict[str, Knob] = {k.env: k for k in KNOBS}


def knob_for_env(env: str) -> Optional[Knob]:
    """The registry knob owning env var ``env``, or None."""
    return _BY_ENV.get(env)


def default_assignment() -> Dict[str, object]:
    """The all-defaults knob assignment (the search's starting point)."""
    return {k.name: k.default for k in KNOBS}


def validate_assignment(assignment: dict) -> Dict[str, object]:
    """Check names and values against the registry; returns a sorted copy.

    Raises ``ValueError`` naming the first offense — a plan carrying an
    illegal value must fail at load/build time, not at consumer-launch
    time.
    """
    out = {}
    for name in sorted(assignment):
        k = knob(name)  # KeyError -> caller surfaces the catalogue
        value = assignment[name]
        if not k.legal(value):
            raise ValueError(
                f"knob {name}: {value!r} is not legal "
                f"(legal: {', '.join(str(v) for v in k.values)})"
            )
        out[name] = value
    return out


def assignment_env(assignment: dict) -> Dict[str, str]:
    """The env-var view of ``assignment`` (what ``plan apply`` exports)."""
    return {
        knob(name).env: str(value)
        for name, value in sorted(validate_assignment(assignment).items())
    }


def prediction_params(assignment: dict, platform=None) -> dict:
    """Fold ``assignment`` into cost-model prediction parameters.

    Starts from the study's target ``platform`` (None = the default
    backend), workers=1, batch=None, then applies each knob's declared
    overrides in knob order — the single mapping both the search scorer
    and ``plan explain`` use, so a plan's stored predictions are exactly
    what scoring saw.
    """
    params = {"platform": platform, "workers": 1, "batch": None, "group": 1}
    for k in KNOBS:
        if k.name in assignment:
            params.update(k.prediction_overrides(assignment[k.name]))
    return params
