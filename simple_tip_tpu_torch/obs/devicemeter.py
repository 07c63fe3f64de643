"""Device cost observatory: analytic FLOPs/bytes accounting per program.

Counterpart of the JAX package's ``obs/devicemeter.py``. The hot path is a
handful of run programs (the fused chain and the grouped chain: CUDA
graphs on the card; the rank and select dispatches); the telemetry plane
times them, and this module grades each dispatch against the work it
represents. Stdlib only, so the meter math runs without torch:

- **cost** — a CUDA graph has no ``cost_analysis()``, so a program's cost
  is analytic: ``analytic_cost(family, rows)`` from ``utils/flops.py``'s
  counts for the rows of a badge (the forward's FLOPs, and for the
  convnets the mandatory HBM bytes of a forward that materializes its f32
  activations), and ``chain_cost`` for a fused-chain dispatch (that
  forward plus the bytes of its coverage metrics and outputs).
  ``normalize_cost`` keeps the JAX package's key grammar.
- **peak tables + grading** — ``resolve_peaks`` maps (platform,
  device_kind) to peak FLOP/s and HBM bytes/s: a ``TIP_DEVICE_PEAKS``
  JSON env override first, then the bundled table: the H100 SXM
  (``utils/flops.CARD_PEAKS``: 3xTF32 tensor-core FLOP/s, HBM3 bytes/s)
  and a nominal CPU core. Any other device resolves to
  ``analytic_only=True``: achieved FLOP/s and bytes/s are still reported,
  but MFU and the roofline verdict are withheld rather than graded
  against an assumed chip. ``grade(cost, dt_s, ...)`` turns one measured
  dispatch into achieved FLOP/s, achieved HBM GB/s, MFU, HBM fraction and
  a compute-bound vs HBM-bound verdict.
- **live attribution** — ``record_program_cost`` keeps an in-process
  registry of per-program costs (stamped by ``engine/run_program.py``
  where a program is resolved); ``observe_dispatch`` feeds per-program
  dispatch-latency quantile windows plus MFU / bandwidth gauges into the
  metrics registry, so they flow to ``/metrics`` and to ``obs roofline``.

``build_breakdown`` composes the schema-stamped ``mfu_breakdown``
document (per-program cost × measured dispatch time) that ``obs/store.py``
and ``obs/regress.py`` consume.
"""

import json
import os
import threading
from typing import Dict, List, Optional, Tuple

from simple_tip_tpu_torch import obs
from simple_tip_tpu_torch.utils import flops as _flops

SCHEMA = 1
KIND = "mfu_breakdown"

# Bundled peak table. Deliberately small: the cards of
# ``utils/flops.CARD_PEAKS`` (the H100 SXM: 3xTF32 tensor-core FLOP/s, the
# precision the port's kernels compute in, and HBM3 bandwidth), keyed by a
# lowercase device-kind substring, and a nominal CPU core (f32 FMA peak per
# core, single-socket DDR bandwidth). Anything else must come in through
# TIP_DEVICE_PEAKS or be graded analytic_only: a wrong peak table produces
# confidently-wrong MFU, which is worse than none.
_BUILTIN_PEAKS = {
    needle: {"flops_per_s": flops, "hbm_bytes_per_s": hbm, "label": label}
    for needle, flops, hbm, label in _flops.CARD_PEAKS
}
_BUILTIN_PEAKS.update({
    "cpu": {
        "flops_per_s": 96e9,  # per core; scaled by ``cores``
        "hbm_bytes_per_s": 25.6e9,
        "label": "cpu-core-f32-nominal",
        "per_core_flops": True,
    },
})

_COST_KEY_ALIASES = {
    "flops": "flops",
    "bytes accessed": "bytes_accessed",
    "bytes_accessed": "bytes_accessed",
    "peak memory": "peak_memory_bytes",
    "peak_memory_bytes": "peak_memory_bytes",
    "optimal seconds": "optimal_seconds",
    "optimal_seconds": "optimal_seconds",
}

_lock = threading.Lock()
_program_costs: Dict[str, dict] = {}


# -- cost extraction ---------------------------------------------------------


def normalize_cost(raw) -> Optional[dict]:
    """Normalize one ``cost_analysis()`` result to canonical keys.

    Tolerates every shape the API has had: a dict, a list of per-device
    dicts (first entry wins), missing keys (→ absent, never KeyError),
    and junk values (non-numeric entries are dropped). Returns None when
    nothing usable survives.
    """
    if isinstance(raw, (list, tuple)):
        raw = raw[0] if raw else None
    if not isinstance(raw, dict):
        return None
    out = {}
    for key, value in raw.items():
        name = _COST_KEY_ALIASES.get(str(key).lower())
        if name is None:
            continue
        try:
            value = float(value)
        except (TypeError, ValueError):
            continue
        if value >= 0:
            out[name] = value
    return out or None


def analytic_cost(family: str, rows: int) -> dict:
    """The analytic cost of one forward over ``rows`` inputs of ``family``.

    ``flops`` from ``utils/flops``' forward counts (the convnets', or the
    IMDB transformer's at its registry shapes); ``bytes_accessed`` for the
    convnets: each input read once and each f32 activation written and read
    once (``conv_net_forward_hbm_bytes`` at 4 bytes an element). The IMDB
    count has no bytes: its grade is by FLOPs alone.
    """
    rows = int(rows)
    if family in ("mnist", "fmnist", "cifar10"):
        return {
            "flops": float(_flops.conv_net_forward_flops(family) * rows),
            "bytes_accessed": float(
                _flops.conv_net_forward_hbm_bytes(family, act_bytes=4, in_bytes=4)
                * rows
            ),
        }
    if family == "imdb":
        return {"flops": float(_flops.transformer_forward_flops() * rows)}
    raise ValueError(f"no analytic cost for {family!r}")


def chain_cost(family: str, rows: int, taps: int, profile_bits, table_bytes: int = 0,
               head_bytes: int = 0) -> dict:
    """The analytic cost of one fused-chain dispatch over ``rows`` inputs.

    ``flops``: the forward's (``analytic_cost``): matmul and conv FLOPs
    only, the MFU convention, so the coverage's comparisons and the
    quantifiers are not in it. ``bytes_accessed``: the forward's (none for
    IMDB), plus per input the coverage's (``utils/flops.coverage_hbm_bytes``:
    ``taps`` tap activations read once, each metric's packed profile of
    ``profile_bits`` bits and its score written once) and ``head_bytes``
    (the prediction and uncertainties written), plus ``table_bytes`` once
    (the thresholds the dispatch reads).
    """
    cost = analytic_cost(family, rows)
    per_input = _flops.coverage_hbm_bytes(taps, profile_bits) + int(head_bytes)
    cost["bytes_accessed"] = cost.get("bytes_accessed", 0.0) + float(
        per_input * int(rows) + int(table_bytes)
    )
    return cost


# -- peak tables -------------------------------------------------------------


def _env_peaks() -> Dict[str, dict]:
    """The ``TIP_DEVICE_PEAKS`` override table: a JSON object mapping a
    lowercase device-kind substring (or platform name) to
    ``{"flops_per_s": ..., "hbm_bytes_per_s": ..., "label": ...}``.
    Malformed JSON or entries are ignored (the bundled table still
    applies) — a typo'd override must not take the meter down."""
    raw = os.environ.get("TIP_DEVICE_PEAKS", "")
    if not raw.strip():
        return {}
    try:
        table = json.loads(raw)
    except (ValueError, TypeError):
        return {}
    if not isinstance(table, dict):
        return {}
    out = {}
    for key, entry in table.items():
        if not isinstance(entry, dict):
            continue
        peaks = {}
        for field in ("flops_per_s", "hbm_bytes_per_s"):
            try:
                peaks[field] = float(entry[field])
            except (KeyError, TypeError, ValueError):
                continue
        if not peaks:
            continue
        peaks["label"] = str(entry.get("label", f"env:{key}"))
        out[str(key).lower()] = peaks
    return out


def resolve_peaks(
    platform: Optional[str],
    device_kind: Optional[str],
    cores: int = 1,
) -> dict:
    """Peak FLOP/s + HBM bytes/s for one device, or an analytic_only stub.

    Resolution order: longest-matching ``TIP_DEVICE_PEAKS`` key (matched
    as a substring of the lowercased device kind, falling back to the
    platform name), then the bundled card/CPU defaults. An unrecognized
    device returns ``{"analytic_only": True}`` with no peaks — loud by
    design, so a new card gets an explicit table entry rather than a
    silently-wrong MFU.
    """
    platform = (platform or "").lower()
    kind = (device_kind or "").lower()
    haystack = kind or platform
    env = _env_peaks()
    for key in sorted(env, key=len, reverse=True):
        if key and (key in haystack or key == platform):
            entry = dict(env[key])
            entry.setdefault("analytic_only", False)
            return entry
    for needle, *_rest in _flops.CARD_PEAKS:
        if needle in kind:
            return dict(_BUILTIN_PEAKS[needle], analytic_only=False)
    if platform == "cpu" or "cpu" in haystack:
        entry = dict(_BUILTIN_PEAKS["cpu"], analytic_only=False)
        entry["flops_per_s"] *= max(1, int(cores))
        entry.pop("per_core_flops", None)
        return entry
    return {
        "analytic_only": True,
        "label": f"unknown:{device_kind or platform or 'device'}",
    }


# -- grading -----------------------------------------------------------------


def grade(
    cost: Optional[dict],
    dt_s: Optional[float],
    platform: Optional[str] = None,
    device_kind: Optional[str] = None,
    cores: int = 1,
    peaks: Optional[dict] = None,
) -> dict:
    """Grade one measured dispatch against the device roofline.

    Returns a JSON-safe dict: achieved FLOP/s and HBM bytes/s (whenever
    the cost and a positive dt are known), MFU and HBM fraction
    (additionally requiring peaks), and ``bound`` — ``"compute"`` or
    ``"hbm"`` by whichever roofline ceiling the dispatch sits closer to,
    ``"unknown"`` when the verdict cannot be computed. ``analytic_only``
    is True whenever the peak table did not recognize the chip.
    """
    if peaks is None:
        peaks = resolve_peaks(platform, device_kind, cores=cores)
    cost = cost or {}
    out = {
        "flops": cost.get("flops"),
        "bytes_accessed": cost.get("bytes_accessed"),
        "peak_memory_bytes": cost.get("peak_memory_bytes"),
        "dispatch_s": dt_s,
        "achieved_flops_per_s": None,
        "achieved_hbm_bytes_per_s": None,
        "mfu": None,
        "hbm_frac": None,
        "bound": "unknown",
        "analytic_only": bool(peaks.get("analytic_only", False)),
        "peak_label": peaks.get("label"),
        "peak_flops_per_s": peaks.get("flops_per_s"),
        "peak_hbm_bytes_per_s": peaks.get("hbm_bytes_per_s"),
    }
    if not dt_s or dt_s <= 0:
        return out
    flops = cost.get("flops")
    bytes_accessed = cost.get("bytes_accessed")
    if flops is not None:
        out["achieved_flops_per_s"] = flops / dt_s
        if peaks.get("flops_per_s"):
            out["mfu"] = out["achieved_flops_per_s"] / peaks["flops_per_s"]
    if bytes_accessed is not None:
        out["achieved_hbm_bytes_per_s"] = bytes_accessed / dt_s
        if peaks.get("hbm_bytes_per_s"):
            out["hbm_frac"] = (
                out["achieved_hbm_bytes_per_s"] / peaks["hbm_bytes_per_s"]
            )
    if out["mfu"] is not None and out["hbm_frac"] is not None:
        out["bound"] = "compute" if out["mfu"] >= out["hbm_frac"] else "hbm"
    elif out["mfu"] is not None:
        out["bound"] = "compute"
    elif out["hbm_frac"] is not None:
        out["bound"] = "hbm"
    return out


# -- the in-process cost registry -------------------------------------------


def record_program_cost(
    program: str, cost: Optional[dict], fingerprint: Optional[str] = None
) -> None:
    """Remember one program's analytic cost (stamped where the program is
    resolved). A None cost forgets the entry, so a stale cost of another
    program under the same name cannot grade this one's dispatches."""
    cost = normalize_cost(cost) if cost else None
    with _lock:
        if cost is None:
            _program_costs.pop(str(program), None)
        else:
            _program_costs[str(program)] = {
                "cost": cost,
                "fingerprint": fingerprint,
            }


def program_cost(program: str) -> Optional[dict]:
    """The registered analytic cost for ``program``, or None."""
    with _lock:
        entry = _program_costs.get(str(program))
        return dict(entry["cost"]) if entry else None


def program_costs() -> Dict[str, dict]:
    """Snapshot of every registered program cost (JSON-safe copy)."""
    with _lock:
        return {
            name: {"cost": dict(e["cost"]), "fingerprint": e["fingerprint"]}
            for name, e in _program_costs.items()
        }


def reset() -> None:
    """Forget every registered program cost (test isolation)."""
    with _lock:
        _program_costs.clear()


def observe_dispatch(
    program: str,
    dt_s: float,
    platform: Optional[str] = None,
    device_kind: Optional[str] = None,
    cores: int = 1,
) -> None:
    """Feed one measured dispatch into the live metrics registry.

    Always lands the dispatch-latency quantile; when the program's cost
    is registered and the chip is recognized, also sets the per-program
    MFU / bandwidth / HBM-fraction gauges (last-dispatch values — the
    quantile window carries the distribution). Never raises: dispatch
    paths must not fail on telemetry.
    """
    try:
        program = str(program)
        obs.quantile(f"run_program.dispatch_s.{program}").observe(float(dt_s))
        cost = program_cost(program)
        if cost is None:
            return
        graded = grade(
            cost, dt_s, platform=platform, device_kind=device_kind, cores=cores
        )
        if graded["mfu"] is not None:
            obs.gauge(f"run_program.mfu.{program}").set(round(graded["mfu"], 6))
        if graded["hbm_frac"] is not None:
            obs.gauge(f"run_program.hbm_frac.{program}").set(
                round(graded["hbm_frac"], 6)
            )
        if graded["achieved_hbm_bytes_per_s"] is not None:
            obs.gauge(f"run_program.hbm_gbps.{program}").set(
                round(graded["achieved_hbm_bytes_per_s"] / 1e9, 3)
            )
    except Exception:  # noqa: BLE001 — telemetry must not fail a dispatch
        pass


def detect_device(device=None) -> Tuple[str, str, int]:
    """(platform, device_kind, count) of ``device``: ``("gpu",
    torch.cuda.get_device_name(index), 1)`` for a CUDA device (the card by
    default, when there is one) and ``("cpu", "cpu", cores)`` for the CPU.
    torch is imported here only: the meter itself stays stdlib only."""
    try:
        import torch

        if device is None:
            dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
        else:
            dev = torch.device(device)
        if dev.type == "cuda":
            index = dev.index if dev.index is not None else torch.cuda.current_device()
            return ("gpu", torch.cuda.get_device_name(index), 1)
    except ImportError:
        pass
    return ("cpu", "cpu", os.cpu_count() or 1)


# -- MFU_BREAKDOWN documents -------------------------------------------------


def build_breakdown(
    programs: Dict[str, dict],
    platform: str,
    device_kind: str,
    cores: int = 1,
    degraded: bool = False,
    captured_unix: Optional[float] = None,
    extra: Optional[dict] = None,
) -> dict:
    """Compose the schema-stamped MFU_BREAKDOWN document.

    ``programs`` maps a program name (free-form; grouped-chain entries use
    e.g. ``group_chain@g4``) to ``{"cost": <normalized cost
    dict>, "dispatch_s": <seconds | quantile summary dict>}`` plus any
    extra fields (``models_per_dispatch``, ``n_dispatches``...). Each
    entry is graded here against one shared peak resolution, so the doc
    is self-contained for ``obs roofline`` / store / regress.
    """
    peaks = resolve_peaks(platform, device_kind, cores=cores)
    doc = {
        "schema": SCHEMA,
        "kind": KIND,
        "platform": platform,
        "device_kind": device_kind,
        "cores": int(cores),
        "degraded": bool(degraded),
        "peaks": peaks,
        "programs": {},
    }
    if captured_unix is not None:
        doc["captured_unix"] = float(captured_unix)
    for name, entry in sorted(programs.items()):
        entry = dict(entry or {})
        cost = normalize_cost(entry.get("cost"))
        dispatch = entry.get("dispatch_s")
        summary = None
        if isinstance(dispatch, dict):
            summary = dispatch
            dt_s = dispatch.get("p50") or dispatch.get("mean")
        else:
            dt_s = dispatch
        graded = grade(cost, dt_s, peaks=peaks)
        row = {
            "cost": cost,
            "grade": graded,
        }
        if summary is not None:
            row["dispatch_s"] = summary
        elif dt_s is not None:
            row["dispatch_s"] = {"mean": float(dt_s)}
        for key, value in entry.items():
            if key not in ("cost", "dispatch_s"):
                row[key] = value
        doc["programs"][str(name)] = row
    if extra:
        for key, value in extra.items():
            doc.setdefault(key, value)
    return doc


# -- roofline rows + rendering ----------------------------------------------


def rows_from_breakdown(doc: dict) -> List[dict]:
    """Flatten one MFU_BREAKDOWN document into roofline table rows."""
    rows = []
    programs = doc.get("programs")
    if not isinstance(programs, dict):
        return rows
    for name, entry in sorted(programs.items()):
        graded = (entry or {}).get("grade") or {}
        dispatch = (entry or {}).get("dispatch_s") or {}
        rows.append(
            {
                "program": str(name),
                "mfu": graded.get("mfu"),
                "hbm_frac": graded.get("hbm_frac"),
                "hbm_gbps": (
                    graded["achieved_hbm_bytes_per_s"] / 1e9
                    if graded.get("achieved_hbm_bytes_per_s") is not None
                    else None
                ),
                "gflops_per_s": (
                    graded["achieved_flops_per_s"] / 1e9
                    if graded.get("achieved_flops_per_s") is not None
                    else None
                ),
                "p50_ms": (
                    dispatch["p50"] * 1e3 if dispatch.get("p50") is not None
                    else (
                        dispatch["mean"] * 1e3
                        if dispatch.get("mean") is not None
                        else None
                    )
                ),
                "p99_ms": (
                    dispatch["p99"] * 1e3
                    if dispatch.get("p99") is not None
                    else None
                ),
                "count": dispatch.get("count"),
                "bound": graded.get("bound", "unknown"),
                "analytic_only": bool(graded.get("analytic_only", False)),
                "models_per_dispatch": (entry or {}).get("models_per_dispatch"),
            }
        )
    return rows


def rows_from_metrics(snapshot: dict) -> List[dict]:
    """Roofline rows from one live metrics snapshot (gauges + quantiles
    as ``observe_dispatch`` lands them) — the run-directory path of
    ``obs roofline``, where no MFU_BREAKDOWN document exists yet."""
    gauges = snapshot.get("gauges") or {}
    quantiles = snapshot.get("quantiles") or {}
    programs = set()
    for key in gauges:
        for prefix in (
            "run_program.mfu.", "run_program.hbm_frac.", "run_program.hbm_gbps."
        ):
            if key.startswith(prefix):
                programs.add(key[len(prefix):])
    for key in quantiles:
        if key.startswith("run_program.dispatch_s."):
            programs.add(key[len("run_program.dispatch_s."):])
    rows = []
    for name in sorted(programs):
        summary = quantiles.get(f"run_program.dispatch_s.{name}") or {}
        mfu = gauges.get(f"run_program.mfu.{name}")
        hbm_frac = gauges.get(f"run_program.hbm_frac.{name}")
        if mfu is not None and hbm_frac is not None:
            bound = "compute" if mfu >= hbm_frac else "hbm"
        elif mfu is not None:
            bound = "compute"
        elif hbm_frac is not None:
            bound = "hbm"
        else:
            bound = "unknown"
        rows.append(
            {
                "program": name,
                "mfu": mfu,
                "hbm_frac": hbm_frac,
                "hbm_gbps": gauges.get(f"run_program.hbm_gbps.{name}"),
                "gflops_per_s": None,
                "p50_ms": (
                    summary["p50"] * 1e3
                    if summary.get("p50") is not None
                    else None
                ),
                "p99_ms": (
                    summary["p99"] * 1e3
                    if summary.get("p99") is not None
                    else None
                ),
                "count": summary.get("count"),
                "bound": bound,
                "analytic_only": mfu is None and hbm_frac is None,
                "models_per_dispatch": None,
            }
        )
    return rows


def _fmt(value, spec: str = ".3f", none: str = "-") -> str:
    if value is None:
        return none
    try:
        return format(value, spec)
    except (TypeError, ValueError):
        return str(value)


def render_roofline(rows: List[dict], header: str = "") -> str:
    """The ``obs roofline`` table: one line per program, verdict last."""
    lines = []
    if header:
        lines.append(header)
    lines.append(
        f"{'program':<24} {'mfu':>8} {'hbm%':>8} {'GB/s':>9} "
        f"{'p50 ms':>9} {'p99 ms':>9} {'n':>6}  verdict"
    )
    for row in rows:
        verdict = row.get("bound", "unknown")
        if verdict == "compute":
            verdict = "compute-bound"
        elif verdict == "hbm":
            verdict = "HBM-bound"
        if row.get("analytic_only"):
            verdict += " [analytic_only]"
        mpd = row.get("models_per_dispatch")
        if mpd:
            verdict += f" (G={mpd})"
        lines.append(
            f"{row.get('program', '?'):<24} "
            f"{_fmt(row.get('mfu'), '.4f'):>8} "
            f"{_fmt(row.get('hbm_frac'), '.4f'):>8} "
            f"{_fmt(row.get('hbm_gbps'), '.2f'):>9} "
            f"{_fmt(row.get('p50_ms'), '.3f'):>9} "
            f"{_fmt(row.get('p99_ms'), '.3f'):>9} "
            f"{_fmt(row.get('count'), 'd'):>6}  {verdict}"
        )
    return "\n".join(lines)
