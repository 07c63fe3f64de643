"""Self-tuning execution planner: knob space, search, ExecutionPlan.

Counterpart of the JAX package's ``plan`` package over the port's knob
space (``knobs.py``). The consumer-side readers are re-exported here so
call sites stay one cheap import: ``from simple_tip_tpu_torch import plan;
plan.phase_estimate(...)``. Stdlib only: it runs on hosts with no card and
no torch.
"""

from simple_tip_tpu_torch.plan.plan import (  # noqa: F401
    PLAN_FILE_ENV,
    UNPLANNED,
    PlanError,
    active_plan,
    active_plan_id,
    phase_estimate,
)
