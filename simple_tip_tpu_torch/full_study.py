"""One-command full study: every phase x case study x run, across hosts.

Counterpart of the JAX package's ``scripts/full_study.py``. Each host takes
a contiguous slice of the run ids (``parallel.distributed.host_local_model_ids``),
runs each phase on its runs through the command line's ``dispatch_phase``
(on the CUDA card unless ``--device cpu``), and writes its artifacts to the
shared ``TIP_ASSETS`` bus. A rendezvous before the evaluation phase
(``distributed.barrier``, not a collective) holds process 0, the only one
that aggregates, until every host has written; a second one after it holds
the others until the aggregation is done.

    python -m simple_tip_tpu_torch.full_study --runs -1
    python -m simple_tip_tpu_torch.full_study --runs -1 \\
        --coordinator host0:8476 --num-processes M --process-id N

(the three flags on every host of a multi-host run, or none). Default
phases: training, test_prio, active_learning, evaluation; add
``at_collection`` by name. On one host with a card the device watchdog
probes the card first (an unresponsive card exits 2); on several hosts
there is no probe, as in the JAX package. ``TIP_OBS_DIR`` defaults to
``auto`` when ``TIP_ASSETS`` is set; the study's root span
(``obs.study_root``) holds every phase span, each evaluation has a span,
each rendezvous an event, and the host's kernel launches are gauges.

``--plan FILE`` (or an inherited ``TIP_PLAN_FILE``) activates an execution
plan (``python -m simple_tip_tpu_torch.plan suggest``) before anything
reads a knob: its assignment goes into the environment and its id onto the
root span. A file that is not a valid plan, or one naming a knob the port
does not read (``plan/knobs.NOT_PORTED``), exits 2. Before the study the
cost model (``obs/costmodel.py``) quotes its seconds over the feature store
(``predicted_s`` on the root span, beside ``actual_s``); after it the
store's index is refreshed with the study's trace (``obs/store.py``).
Both are advisory: an empty index changes nothing.
"""

import argparse
import logging
import os
import sys
import time

import torch
import torch.distributed as dist

from simple_tip_tpu_torch import obs
from simple_tip_tpu_torch.casestudies.base import CASE_STUDIES, get_case_study
from simple_tip_tpu_torch.cli import EVALS, _parse_runs, _run_eval, dispatch_phase
from simple_tip_tpu_torch.device import resolve
from simple_tip_tpu_torch.ops import launch_counts
from simple_tip_tpu_torch.parallel import distributed
from simple_tip_tpu_torch.plan import PLAN_FILE_ENV
from simple_tip_tpu_torch.resilience import BackendUnavailable
from simple_tip_tpu_torch.utils.device_watchdog import ensure_responsive_backend

logger = logging.getLogger("full_study")
DEFAULT_PHASES = ("training", "test_prio", "active_learning", "evaluation")
ALL_PHASES = ("training", "test_prio", "active_learning", "at_collection", "evaluation")


def _apply_plan(argv):
    """Activate an execution plan before any knob-reading code runs.

    ``--plan FILE`` (pre-scanned here: argparse builds its defaults from the
    knob env) or an inherited ``TIP_PLAN_FILE`` is loaded and validated,
    and its knob assignment exported into the environment, so the
    scheduler's workers and the serving layer launch under it. Returns
    ``(plan document or None, error or None)``."""
    from simple_tip_tpu_torch.plan import knobs, plan as plan_mod

    path = None
    for i, arg in enumerate(argv):
        if arg == "--plan" and i + 1 < len(argv):
            path = argv[i + 1]
        elif arg.startswith("--plan="):
            path = arg.split("=", 1)[1]
    if path:
        os.environ[PLAN_FILE_ENV] = os.path.abspath(path)
    raw = os.environ.get(PLAN_FILE_ENV, "").strip()
    if not raw:
        return None, None
    try:
        doc = plan_mod.load(raw)
    except plan_mod.PlanError as e:
        return None, f"full_study: {raw} is not a valid plan: {e}"
    os.environ.update(knobs.assignment_env(doc["assignment"]))
    print(f"plan {doc['plan_id']}: applied "
          f"{','.join(f'{k}={v}' for k, v in sorted(doc['assignment'].items()))}")
    return doc, None


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--plan", default=None,
                        help="an execution plan file (python -m "
                        "simple_tip_tpu_torch.plan suggest); same as TIP_PLAN_FILE")
    parser.add_argument("--case-studies", default="mnist,fmnist,cifar10,imdb",
                        help="comma-separated subset of case studies")
    parser.add_argument("--runs", default="-1", help="'-1' = all 100, or '0-9', '0,3,7', '5'")
    parser.add_argument("--phases", default=",".join(DEFAULT_PHASES),
                        help=f"comma-separated ordered subset of {ALL_PHASES}")
    parser.add_argument("--coordinator", default=None, help="host:port of process 0")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--workers", type=int,
                        default=int(os.environ.get("TIP_NUM_WORKERS", "1")),
                        help="per-host worker processes of the test_prio, active_learning "
                        "and at_collection phases")
    parser.add_argument("--device", default=None,
                        help="torch device of the model phases: the CUDA card by default, "
                        "'cpu' when asked")
    parser.add_argument("-v", "--verbose", action="store_true")
    return parser


def main(argv=None) -> int:
    """Run the study; returns the exit code."""
    active_plan, error = _apply_plan(sys.argv[1:] if argv is None else list(argv))
    if error:
        print(error, file=sys.stderr)
        return 2
    parser = _parser()
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO if args.verbose else logging.WARNING)
    if os.environ.get("TIP_ASSETS") and not os.environ.get("TIP_OBS_DIR"):
        os.environ["TIP_OBS_DIR"] = "auto"

    phases = [p.strip() for p in args.phases.split(",") if p.strip()]
    unknown = set(phases) - set(ALL_PHASES)
    if unknown:
        parser.error(f"unknown phases {sorted(unknown)}; choose from {ALL_PHASES}")

    case_studies = [c.strip() for c in args.case_studies.split(",") if c.strip()]
    unknown_cs = set(case_studies) - set(CASE_STUDIES)
    if not case_studies or unknown_cs:
        parser.error(f"--case-studies: unknown {sorted(unknown_cs)}; "
                     f"choose from {sorted(CASE_STUDIES)}")
    flags = (args.coordinator, args.num_processes, args.process_id)
    multi_host = (args.coordinator is not None or (args.num_processes or 1) > 1
                  or args.process_id is not None)
    if multi_host and None in flags:
        # Partial flags would leave every host running every run id.
        parser.error("multi-host runs need all three of --coordinator, --num-processes "
                     "and --process-id")

    try:
        device = resolve(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"--device: {e}", file=sys.stderr)
        return 2
    distributed.initialize(args.coordinator, args.num_processes, args.process_id)
    try:
        if device.type == "cuda" and not multi_host:
            try:
                ensure_responsive_backend()
            except BackendUnavailable as e:
                print(f"full_study: {e}", file=sys.stderr)
                return 2
        if device.type == "cpu":
            logger.warning("running on the CPU")
        run_study(phases, case_studies, _parse_runs(args.runs), device, max(1, args.workers),
                  plan_id=active_plan["plan_id"] if active_plan else None)
        return 0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def quote_study(phases, case_studies: int, runs: int, platform: str, workers: int):
    """The cost model's wall-clock estimate of the study over the feature
    store, printed; its seconds, or None (no index, or no phase with an
    estimate). Advisory: never raises."""
    try:
        from simple_tip_tpu_torch.obs import costmodel, store

        corpus = store.load_rows()
        if not corpus:
            return None
        prediction = costmodel.predict_study(
            costmodel.fit(corpus), [p for p in phases if p != "evaluation"],
            runs=runs, case_studies=case_studies, platform=platform, workers=workers,
        )
        if not prediction["ok"]:
            print("cost model: insufficient corpus for every phase: no wall-clock "
                  "prediction (grow the index with `python -m simple_tip_tpu_torch.obs runs`)")
            return None
        insufficient = prediction["insufficient"]
        print(f"cost model: predicted wall-clock {prediction['total_s']:.0f}s "
              f"(+/- {prediction['error_s']:.0f}s)"
              + (f"; insufficient corpus for {','.join(insufficient)}" if insufficient else ""))
        return prediction["total_s"]
    except Exception:  # noqa: BLE001 — advisory, never blocks a launch
        return None


def refresh_store() -> None:
    """Fold this study's trace into the feature-store index, so the next
    launch predicts from it. Advisory: never raises."""
    try:
        from simple_tip_tpu_torch.obs import store

        if obs.enabled() and obs.obs_dir():
            report = store.refresh([obs.obs_dir()])
            print(f"obs index: +{report['rows_appended']} rows -> "
                  f"{report['rows_total']} ({report['index']})")
    except Exception:  # noqa: BLE001 — advisory, never blocks the exit
        pass


def run_study(phases, case_studies, all_runs, device, workers: int = 1,
              plan_id=None) -> None:
    """This host's share of ``all_runs`` through ``phases`` for each case
    study, on ``device``; process 0 aggregates at ``evaluation``.
    ``plan_id`` (the active plan's) is stamped onto the root span."""
    rank, hosts = distributed.process_index(), distributed.process_count()
    my_runs = distributed.host_local_model_ids(all_runs)
    local = torch.cuda.device_count() if device.type == "cuda" else 1
    print(f"host {rank}/{hosts}: {len(my_runs)}/{len(all_runs)} runs, "
          f"{local} local device(s), platform {device.type}", flush=True)

    predicted_s = quote_study(phases, len(case_studies), len(my_runs),
                              "cpu" if device.type == "cpu" else "gpu", workers)
    stamps = {}
    if predicted_s:
        stamps["predicted_s"] = predicted_s
    if plan_id:
        stamps["plan"] = plan_id
    started = time.perf_counter()
    with obs.study_root("full_study", case_studies=",".join(case_studies),
                        phases=",".join(phases), runs=len(my_runs), host=rank,
                        **stamps) as study_span:
        for phase in phases:
            if phase == "evaluation":
                _evaluate(rank, case_studies, len(all_runs))
                continue
            for cs_name in case_studies if my_runs else ():  # more hosts than runs: none
                cs = get_case_study(cs_name)
                t0 = time.perf_counter()
                with obs.span(phase, cs=cs_name, runs=len(my_runs)):
                    dispatch_phase(cs, phase, my_runs, device, num_workers=workers)
                print(f"[{phase}:{cs_name}] runs {my_runs[0]}..{my_runs[-1]} "
                      f"in {time.perf_counter() - t0:.0f}s", flush=True)
        study_span.set(actual_s=round(time.perf_counter() - started, 3))
    obs.record_kernel_launches(launch_counts())
    obs.flush_metrics()
    refresh_store()
    if obs.enabled():
        print(f"obs events in {obs.obs_dir()}")


def _evaluate(rank: int, case_studies, n_runs: int) -> None:
    """The evaluation phase between its two rendezvous; process 0 alone
    aggregates."""
    # The slowest host may still be writing its shard, and afterwards
    # process 0 aggregates every host's: a fixed fuse shorter than that
    # work would end the study here.
    budget_s = max(3600.0, 120.0 * n_runs * len(case_studies))
    distributed.barrier("full_study_pre_evaluation", timeout_s=budget_s)
    if rank == 0:
        for which in EVALS:
            t0 = time.perf_counter()
            with obs.span("evaluation", which=which):
                _run_eval(which, case_studies=case_studies)
            print(f"[evaluation:{which}] {time.perf_counter() - t0:.0f}s", flush=True)
    distributed.barrier("full_study_post_evaluation", timeout_s=budget_s)


if __name__ == "__main__":
    sys.exit(main())
