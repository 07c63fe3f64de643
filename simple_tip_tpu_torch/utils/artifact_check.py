"""Artifact-bus completeness checking (the ``check`` phase).

The port's own copy of the JAX package's ``utils/artifact_check.py``: scan
the bus and report which (case study, run) pairs are missing which
artifacts, so that a partial or aborted sweep can be resumed with exactly
the runs that need re-running. The expected names come from the port's
copy of the approach list (``plotters/utils.APPROACHES``), the data-source
verdict from the port's loaders (``data/loaders.dataset_presence``).
"""

import os
from typing import Dict, List, Set

from simple_tip_tpu_torch.config import output_folder
from simple_tip_tpu_torch.data.loaders import dataset_presence
from simple_tip_tpu_torch.plotters.utils import APPROACHES


def expected_priority_types(has_dropout: bool) -> List[str]:
    """The artifact type-suffixes one complete prio run writes per dataset."""
    types = ["is_misclassified"]
    for unc in ["softmax", "pcs", "softmax_entropy", "deep_gini"] + (
        ["VR"] if has_dropout else []
    ):
        types.append(f"uncertainty_{unc}")
    for approach in APPROACHES:
        if approach.endswith("-cam") or approach in (
            "deep_gini",
            "softmax",
            "pcs",
            "softmax_entropy",
            "VR",
        ):
            continue
        types.append(f"{approach}_scores")
        types.append(f"{approach}_cam_order")
    return types


def _usable_files(folder: str) -> Set[str]:
    """Artifact names present AND non-empty: a crash can cut a write short,
    and a zero-byte .npy/.pickle would pass a pure name-membership audit only
    to fail at aggregation time."""
    if not os.path.isdir(folder):
        return set()
    usable = set()
    for e in os.scandir(folder):
        try:
            if e.stat().st_size > 0:
                usable.add(e.name)
        except FileNotFoundError:
            # vanished between listing and stat (a writer is replacing it
            # mid-audit): not usable right now
            continue
    return usable


def check_prio_artifacts(
    case_study: str, runs: range, has_dropout: bool = True
) -> Dict[int, Set[str]]:
    """Missing or truncated prio artifacts per run id (empty dict = complete)."""
    existing = _usable_files(os.path.join(output_folder(), "priorities"))
    missing: Dict[int, Set[str]] = {}
    for run in runs:
        for ds in ["nominal", "ood"]:
            for t in expected_priority_types(has_dropout):
                name = f"{case_study}_{ds}_{run}_{t}.npy"
                if name not in existing:
                    missing.setdefault(run, set()).add(name)
    return missing


def check_al_artifacts(
    case_study: str, runs: range, has_dropout: bool = True
) -> Dict[int, int]:
    """Missing active-learning pickles per run id (empty dict = complete).

    One complete AL run writes 40 selections x {nominal, ood} + 1 original
    evaluation (reference: src/dnn_test_prio/eval_active_learning.py:97-147);
    the VR selection exists only for models with dropout layers.
    """
    existing = _usable_files(os.path.join(output_folder(), "active_learning"))
    approaches = [a for a in APPROACHES if has_dropout or a != "VR"]
    expected_names = ["original_na"] + [
        f"{approach}_{oodnom}"
        for approach in approaches + ["random"]
        for oodnom in ("nominal", "ood")
    ]
    missing: Dict[int, int] = {}
    for run in runs:
        n = sum(
            1
            for name in expected_names
            if f"{case_study}_{run}_{name}.pickle" not in existing
        )
        if n:
            missing[run] = n
    return missing


def expected_times_metrics(has_dropout: bool) -> List[str]:
    """Metric keys that get a ``[setup, pred, quant, cam]`` times pickle per
    (case study, dataset, run): 12 NC configs + 5 SA variants + the
    uncertainty quantifiers (VR only for models with dropout). Matches the
    reference's file-per-metric layout (src/dnn_test_prio/
    eval_prioritization.py:46-52). Derived from the canonical APPROACHES
    list (its non-CAM entries are exactly the timed metric keys), so new
    metrics are picked up here automatically."""
    return [
        a
        for a in APPROACHES
        if not a.endswith("-cam") and (has_dropout or a != "VR")
    ]


def check_times_artifacts(
    case_study: str, runs: range, has_dropout: bool = True
) -> Dict[int, int]:
    """Missing times pickles per run id (empty dict = complete).

    The APFD table's runtime columns average over the first 10 runs
    (plotters/times_collector.py), so audit at least those.
    """
    existing = _usable_files(os.path.join(output_folder(), "times"))
    missing: Dict[int, int] = {}
    for run in runs:
        n = sum(
            1
            for ds in ("nominal", "ood")
            for metric in expected_times_metrics(has_dropout)
            if f"{case_study}_{ds}_{run}_{metric}" not in existing
        )
        if n:
            missing[run] = n
    return missing


def check_model_checkpoints(case_study: str, runs: range) -> List[int]:
    """Run ids without a usable (present, non-empty) model checkpoint."""
    existing = _usable_files(os.path.join(output_folder(), "models", case_study))
    return [r for r in runs if f"{r}.msgpack" not in existing]


def data_source(case_study: str) -> str:
    """Human-readable data-source verdict for the check phase.

    Paper-comparable runs require REAL; a SYNTHETIC verdict means results
    are structurally valid only. Presence semantics come from the loaders
    themselves (loaders.dataset_presence), so this report cannot drift from
    what load_* actually does."""
    state = dataset_presence(case_study)
    if case_study == "imdb":
        return {
            "real": "REAL (tokenized caches)",
        }.get(state, "SYNTHETIC stand-in (mount imdb/*.npy, built by data/imdb_prep.py)")
    return {
        "real": "REAL (nominal + corruption cache)",
        "nominal-only": (
            "REAL nominal; corruption cache will be GENERATED "
            "(not the *-C benchmark)"
        ),
        "incomplete-cache": (
            f"BROKEN corruption cache (exactly one of {case_study}_c_images/"
            f"_c_labels present) — the loader refuses to overwrite it and "
            f"uses a generated set in-memory; fix or remove the stray file"
        ),
    }.get(state, f"SYNTHETIC stand-in (mount {case_study}.npz)")


def report(case_study: str, num_runs: int = 100, has_dropout: bool = True) -> str:
    """Human-readable completeness report for one case study."""
    lines = [f"artifact check: {case_study} (runs 0..{num_runs - 1})"]
    lines.append(f"  data: {data_source(case_study)}")
    missing_models = check_model_checkpoints(case_study, range(num_runs))
    lines.append(
        f"  models: {num_runs - len(missing_models)}/{num_runs} trained"
        + (f" (missing: {missing_models[:10]}...)" if missing_models else "")
    )
    missing_prio = check_prio_artifacts(case_study, range(num_runs), has_dropout)
    complete = num_runs - len(missing_prio)
    lines.append(f"  prio artifacts: {complete}/{num_runs} runs complete")
    for run, names in sorted(missing_prio.items())[:5]:
        lines.append(f"    run {run}: {len(names)} artifacts missing")
    missing_al = check_al_artifacts(case_study, range(num_runs), has_dropout)
    lines.append(
        f"  active-learning artifacts: {num_runs - len(missing_al)}/{num_runs} runs complete"
    )
    for run, n in sorted(missing_al.items())[:5]:
        lines.append(f"    run {run}: {n} pickles missing")
    timed_runs = min(num_runs, 10)  # the APFD table times the first 10 runs
    missing_times = check_times_artifacts(
        case_study, range(timed_runs), has_dropout
    )
    lines.append(
        f"  times pickles (first {timed_runs} runs): "
        f"{timed_runs - len(missing_times)}/{timed_runs} runs complete"
    )
    for run, n in sorted(missing_times.items())[:5]:
        lines.append(f"    run {run}: {n} pickles missing")
    return "\n".join(lines)
