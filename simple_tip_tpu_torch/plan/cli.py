"""``python -m simple_tip_tpu_torch.plan`` — suggest / explain / apply.

The operator surface of the planner. Exit codes follow the obs CLI
contract exactly:

- 0: plan produced / rendered / applied;
- 2: bad input (unknown knob, illegal value, unparseable plan, every
  candidate over the memory capacity);
- 3: insufficient corpus — a skip, not a failure, mirroring ``obs
  predict``/``obs trend``. Under ``--json`` stdout STILL carries one
  valid JSON document on the exit-3 path (diagnostics go to stderr), so
  piped consumers never parse an empty body.

``suggest`` writes deterministic bytes (same corpus + same arguments =>
byte-identical plan file): CI asserts that with ``cmp``, and the plan_id
fingerprint makes any hand edit loudly invalid.
"""

import argparse
import json
import os
import sys

#: Env var supplying the default memory capacity bound for ``suggest``.
MEM_ENV = "TIP_PLAN_MEM_BYTES"

_SUFFIX = {"k": 1024, "m": 1024 ** 2, "g": 1024 ** 3}


def parse_bytes(raw: str) -> int:
    """``"512m"``/``"8g"``/``"1073741824"`` -> bytes (ValueError otherwise)."""
    text = str(raw).strip().lower()
    if not text:
        raise ValueError("empty byte count")
    mult = 1
    if text[-1] in _SUFFIX:
        mult = _SUFFIX[text[-1]]
        text = text[:-1]
    return int(float(text) * mult)


def _capacity_bytes(args):
    """The capacity bound from ``--mem-bytes`` or ``TIP_PLAN_MEM_BYTES``."""
    raw = args.mem_bytes or os.environ.get(MEM_ENV, "").strip()
    if not raw:
        return None
    try:
        return parse_bytes(raw)
    except ValueError:
        raise ValueError(
            f"memory capacity {raw!r} is not a byte count "
            "(plain bytes or k/m/g suffix)"
        ) from None


def _pins(specs):
    """``["workers=4", ...]`` -> a typed, registry-validated assignment."""
    from simple_tip_tpu_torch.plan import knobs as knobs_mod

    pinned = {}
    for spec in specs or []:
        name, sep, raw = spec.partition("=")
        if not sep:
            raise ValueError(f"--set wants knob=value, got {spec!r}")
        pinned[name.strip()] = knobs_mod.knob(name.strip()).coerce(raw)
    return pinned


def render_plan(doc: dict) -> str:
    """One plan as a deterministic text summary (the ``suggest`` view)."""
    from simple_tip_tpu_torch.obs import costmodel

    req = doc["request"]
    out = [
        f"plan {doc['plan_id']} (schema {doc['schema']})",
        f"  request: phases={','.join(req['phases'])} runs={req['runs']} "
        f"case_studies={req['case_studies']} "
        f"platform={req['platform'] or 'default'}",
        "  assignment:",
    ]
    knobs = doc["search"]["knobs"]
    for name, value in sorted(doc["assignment"].items()):
        info = knobs.get(name, {})
        tag = " (pinned)" if info.get("pinned") else ""
        out.append(f"    {name:<18} = {value!s:<8} [{info.get('env', '?')}]{tag}")
    mem = doc["memory"]
    if mem["constraint"] == "enforced":
        out.append(
            f"  memory: predicted peak {mem['predicted_peak_bytes']} bytes "
            f"within capacity {mem['capacity_bytes']} "
            f"({doc['search']['rejected_memory']} candidate(s) rejected)"
        )
    else:
        out.append(
            "  memory: constraint off (no --mem-bytes / TIP_PLAN_MEM_BYTES)"
        )
    out.append("")
    out.append(costmodel.render_prediction(doc["predicted"]))
    return "\n".join(out)


def render_explain(doc: dict) -> str:
    """Per-knob alternatives table (the ``explain`` view)."""
    out = [
        f"plan {doc['plan_id']} — why each knob landed where it did",
        "",
        f"  {'knob':<18} {'value':>8} {'predicted s':>12}  verdict",
    ]
    for name, info in sorted(doc["search"]["knobs"].items()):
        moved = ",".join(info["features"]) or "none"
        for raw_value, entry in sorted(
            info["values"].items(),
            key=lambda kv: list(info["values"]).index(kv[0]),
        ):
            chosen = raw_value == str(info["chosen"])
            if entry.get("rejected"):
                verdict = "REJECTED: over memory capacity"
            elif chosen and info.get("pinned"):
                verdict = "chosen (pinned by operator)"
            elif chosen:
                verdict = "chosen"
            else:
                verdict = ""
            total = entry.get("total_s")
            out.append(
                f"  {name:<18} {raw_value:>8} "
                f"{(f'{total:.1f}' if total is not None else '-'):>12}  "
                f"{verdict}"
            )
        out.append(f"  {'':<18} {'':>8} {'':>12}  (moves: {moved})")
    out.append("")
    out.append(
        "knobs that move no cost-model feature keep their default: the "
        "model cannot rank their values, and the planner says so instead "
        "of guessing."
    )
    return "\n".join(out)


def _suggest(args) -> int:
    from simple_tip_tpu_torch.obs import store
    from simple_tip_tpu_torch.plan import plan as plan_mod
    from simple_tip_tpu_torch.plan import search as search_mod

    phases = [p.strip() for p in args.phases.split(",") if p.strip()]
    if not phases:
        print("plan suggest: --phases must name at least one phase",
              file=sys.stderr)
        return 2
    try:
        capacity = _capacity_bytes(args)
        pinned = _pins(args.set)
    except (KeyError, ValueError) as e:
        print(f"plan suggest: {e}", file=sys.stderr)
        return 2
    rows = store.load_corpus(args.index or store.default_index_dir())

    def _exit3(reason: str) -> int:
        if args.json:
            print(json.dumps(
                {"ok": False, "error": "insufficient_corpus",
                 "reason": reason, "plan_id": None},
                indent=2, sort_keys=True,
            ))
        print(
            f"plan suggest: INSUFFICIENT CORPUS — {reason} (exit 3)",
            file=sys.stderr,
        )
        return 3

    if not rows:
        return _exit3(
            "the feature-store index is empty — run "
            "`python -m simple_tip_tpu_torch.obs runs <roots>` first"
        )
    try:
        result = search_mod.search(
            rows, phases, runs=args.runs, case_studies=args.case_studies,
            platform=args.platform, capacity_bytes=capacity, pinned=pinned,
        )
    except search_mod.InsufficientCorpus as e:
        return _exit3(str(e))
    except search_mod.InfeasiblePlan as e:
        print(f"plan suggest: {e}", file=sys.stderr)
        return 2
    doc = plan_mod.build(
        assignment=result["assignment"],
        predicted=result["predicted"],
        request={
            "phases": phases,
            "runs": args.runs,
            "case_studies": args.case_studies,
            "platform": args.platform,
        },
        memory=result["memory"],
        search=result["search"],
    )
    if args.out:
        path = plan_mod.save(doc, args.out)
        print(f"plan {doc['plan_id']} -> {path}", file=sys.stderr)
    if args.json:
        sys.stdout.write(plan_mod.to_json(doc))
    else:
        print(render_plan(doc))
    return 0


def _load_target(target):
    """The plan doc for ``explain``: an explicit path or the active plan."""
    from simple_tip_tpu_torch.plan import plan as plan_mod

    if target:
        return plan_mod.load(target)
    doc = plan_mod.active_plan()
    if doc is None:
        raise plan_mod.PlanError(
            "no plan file given and TIP_PLAN_FILE names no readable plan"
        )
    return doc


def _explain(args) -> int:
    from simple_tip_tpu_torch.plan import plan as plan_mod

    try:
        doc = _load_target(args.plan)
    except plan_mod.PlanError as e:
        print(f"plan explain: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(doc["search"], indent=2, sort_keys=True))
    else:
        print(render_explain(doc))
    return 0


def _apply(args) -> int:
    from simple_tip_tpu_torch.plan import knobs as knobs_mod
    from simple_tip_tpu_torch.plan import plan as plan_mod

    try:
        doc = plan_mod.load(args.plan)
    except plan_mod.PlanError as e:
        print(f"plan apply: {e}", file=sys.stderr)
        return 2
    env = knobs_mod.assignment_env(doc["assignment"])
    env[plan_mod.PLAN_FILE_ENV] = os.path.abspath(args.plan)
    if args.command:
        cmd = list(args.command)
        if cmd and cmd[0] == "--":
            cmd = cmd[1:]
        if not cmd:
            print("plan apply: empty command after --", file=sys.stderr)
            return 2
        full_env = dict(os.environ)
        full_env.update(env)
        print(
            f"plan apply: {doc['plan_id']} -> exec {' '.join(cmd)}",
            file=sys.stderr,
        )
        os.execvpe(cmd[0], cmd, full_env)  # no return
    # No command: print shell-sourceable export lines (the override-
    # etiquette path — an operator can edit one line before sourcing).
    for key in sorted(env):
        print(f"export {key}={env[key]}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m simple_tip_tpu_torch.plan",
        description="self-tuning execution planner over the obs feature store",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser(
        "suggest", help="search the knob space, emit an ExecutionPlan"
    )
    s.add_argument("--phases", required=True,
                   help="comma-separated phase names to plan for")
    s.add_argument("--runs", type=int, required=True,
                   help="runs per case study")
    s.add_argument("--case-studies", type=int, default=1)
    s.add_argument("--platform", default=None,
                   help="target platform the study launches on "
                        "(cpu, or default for the card)")
    s.add_argument("--index", default=None,
                   help="feature-store index dir (default: obs default)")
    s.add_argument("--mem-bytes", default=None,
                   help=f"device memory capacity bound (k/m/g suffix ok; "
                        f"default ${MEM_ENV}; unset = constraint off)")
    s.add_argument("--set", action="append", metavar="KNOB=VALUE",
                   help="pin a knob (repeatable); pinned knobs skip search")
    s.add_argument("-o", "--out", default=None,
                   help="also write the plan JSON to this path")
    s.add_argument("--json", action="store_true",
                   help="print the plan document instead of the summary")
    s.set_defaults(fn=_suggest)

    e = sub.add_parser(
        "explain", help="render why each knob landed where it did"
    )
    e.add_argument("plan", nargs="?", default=None,
                   help="plan file (default: $TIP_PLAN_FILE)")
    e.add_argument("--json", action="store_true")
    e.set_defaults(fn=_explain)

    a = sub.add_parser(
        "apply",
        help="export the plan's knob env (or exec a command under it)",
    )
    a.add_argument("plan", help="plan file to activate")
    a.add_argument("command", nargs=argparse.REMAINDER,
                   help="optional -- command to exec under the plan env")
    a.set_defaults(fn=_apply)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
