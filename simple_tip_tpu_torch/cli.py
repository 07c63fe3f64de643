"""Command line of the port: the experiment phases on the card.

Counterpart of the JAX package's ``cli.py`` with the same phases, case
studies and run-id syntax:

    python -m simple_tip_tpu_torch.cli --phase training --case-study mnist --runs 0-4
    python -m simple_tip_tpu_torch.cli --phase test_prio --case-study mnist --runs 0
    python -m simple_tip_tpu_torch.cli --phase test_prio --case-study mnist --runs 0-9 --workers 2
    python -m simple_tip_tpu_torch.cli --phase evaluation --eval test_prio
    python -m simple_tip_tpu_torch.cli --phase check --case-study mnist

The phases that run models (training, test_prio, active_learning,
at_collection) run on the CUDA card unless ``--device cpu`` is given; with
no card and no ``--device cpu`` the command fails before it reads or writes
anything. On the card the device watchdog
(``utils/device_watchdog.ensure_responsive_backend``) first runs a small op
in a subprocess; an unresponsive card (or an open breaker) exits 2 with the
reason. There is no fallback to the CPU. ``--workers N`` above 1 (default
``TIP_NUM_WORKERS``) runs test_prio, active_learning and at_collection over
N worker processes (``parallel/run_scheduler.py``; ``TIP_WORKER_PLATFORMS``
places them, ``TIP_JOURNAL`` / ``TIP_ASSETS`` journal them, and with
``--device cpu`` every worker is a CPU worker); training ignores it, as in
the JAX package. ``evaluation`` and ``check`` read
the artifact bus on the host: ``--eval test_prio`` and ``active_learning``
write the two tables (CSV and the paper subset's LaTeX),
``test_prio_statistics`` and ``active_learning_statistics`` the pairwise
Wilcoxon and effect-size CSVs (their heatmaps are not ported).
"""

import argparse
import logging
import os
import sys
from typing import List

PHASES = ["training", "test_prio", "active_learning", "evaluation", "at_collection", "check"]
CASE_STUDIES = ["mnist", "cifar10", "fmnist", "imdb"]
EVALS = ["test_prio", "active_learning", "test_prio_statistics", "active_learning_statistics"]
ALL_CASE_STUDIES = ("mnist", "fmnist", "cifar10", "imdb")


def _parse_runs(spec: str) -> List[int]:
    """Parse '0', '0-4', '0,3,7' or '-1' (= all 100) into run-id lists."""
    spec = spec.strip()
    if spec == "-1":
        return list(range(100))
    runs: List[int] = []
    for part in spec.split(","):
        if "-" in part and not part.startswith("-"):
            lo, hi = part.split("-")
            if int(hi) < int(lo):
                raise SystemExit(
                    f"--runs: inverted range {part!r} selects nothing "
                    f"(did you mean {hi}-{lo}?)"
                )
            runs.extend(range(int(lo), int(hi) + 1))
        else:
            runs.append(int(part))
    if not runs:
        raise SystemExit(f"--runs: {spec!r} selects no run ids")
    return runs


def _run_eval(which: str, case_studies=ALL_CASE_STUDIES):
    if which == "test_prio":
        from simple_tip_tpu_torch.plotters import eval_apfd_table

        eval_apfd_table.run(case_studies=case_studies)
    elif which == "active_learning":
        from simple_tip_tpu_torch.plotters import eval_active_learning_table

        eval_active_learning_table.run(case_studies=case_studies)
    elif which == "test_prio_statistics":
        from simple_tip_tpu_torch.plotters import eval_apfd_correlation

        eval_apfd_correlation.run(case_studies=case_studies)
    elif which == "active_learning_statistics":
        from simple_tip_tpu_torch.plotters import eval_active_correlation

        eval_active_correlation.run(case_studies=case_studies)
    else:
        raise ValueError(f"Unknown eval type: {which}")


def dispatch_phase(cs, phase: str, runs, device, num_workers: int = 1):
    """Run one model phase on a ``CaseStudy`` on ``device``; returns what
    the phase returns (its records per run; nothing when ``num_workers``
    above 1 sends the runs to worker processes). Training ignores
    ``num_workers``."""
    if phase == "training":
        return cs.train(runs, device=device)
    if phase == "test_prio":
        return cs.run_prio_eval(runs, device=device, num_workers=num_workers)
    if phase == "active_learning":
        return cs.run_active_learning_eval(runs, device=device, num_workers=num_workers)
    if phase == "at_collection":
        return cs.collect_activations(runs, device=device, num_workers=num_workers)
    raise ValueError(f"Unknown phase: {phase}")


def main(argv=None) -> int:
    """CLI entry point; returns the exit code."""
    parser = argparse.ArgumentParser(
        description="PyTorch/CUDA port of the simple-tip experiments."
    )
    parser.add_argument("--phase", choices=PHASES, required=True)
    parser.add_argument("--case-study", choices=CASE_STUDIES)
    parser.add_argument(
        "--runs",
        default="0",
        help="run ids: '0', '0-4', '0,3,7', or -1 for all 100",
    )
    parser.add_argument("--eval", choices=EVALS, help="evaluation to run (phase=evaluation)")
    parser.add_argument(
        "--workers",
        type=int,
        default=int(os.environ.get("TIP_NUM_WORKERS", "1")),
        help="worker processes for the test_prio/active_learning/at_collection "
        "phases (default TIP_NUM_WORKERS or 1)",
    )
    parser.add_argument(
        "--device",
        default=None,
        help="torch device of the model phases: the CUDA card by default, 'cpu' when asked",
    )
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO if args.verbose else logging.WARNING)

    if args.phase == "check":
        from simple_tip_tpu_torch.utils.artifact_check import report

        for cs_name in [args.case_study] if args.case_study else CASE_STUDIES:
            print(report(cs_name, has_dropout=cs_name != "cifar10"))
        return 0

    if args.phase == "evaluation":
        _run_eval(args.eval or "test_prio")
        print("Done. Check your assets results folder for the reproduced result files.")
        return 0

    if not args.case_study:
        parser.error("--case-study is required for non-evaluation phases")
    runs = _parse_runs(args.runs)

    from simple_tip_tpu_torch.device import resolve

    try:
        device = resolve(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"--device: {e}", file=sys.stderr)
        return 2

    from simple_tip_tpu_torch.resilience import BackendUnavailable

    num_workers = max(1, args.workers)
    try:
        if device.type == "cuda":
            from simple_tip_tpu_torch.utils.device_watchdog import ensure_responsive_backend

            ensure_responsive_backend()
        from simple_tip_tpu_torch.casestudies.base import get_case_study

        cs = get_case_study(args.case_study)
        dispatch_phase(cs, args.phase, runs, device, num_workers=num_workers)
    except BackendUnavailable as e:
        workers = f" ({num_workers} worker processes)" if num_workers > 1 else ""
        print(f"{args.phase}{workers}: {e}", file=sys.stderr)
        return 2
    print("Done.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
