"""The port stands alone: no module of ``simple_tip_tpu_torch``, not
``chip_smoke.py`` and not the port's card scripts import jax, flax,
anything of ``simple_tip_tpu``, pandas or sklearn (the card machine has
neither of the last two), checked on the source, so lazy imports inside
functions count too; every module imports without a card; and the study
execution layer (the run scheduler, the fleet, the resilience modules, the
log bridge and the device watchdog) imports neither torch nor numpy, so the
scheduler's synthetic-phase workers start without them, nor does the
observability and planning plane (``obs``' modules, ``plan``,
``utils/flops.py``, ``utils/profiling.py``); and the
sequence-parallel modules and the full-study command load in a fresh
interpreter without jax or the JAX package."""

import ast
import importlib
import os
import pkgutil
import subprocess
import sys

import pytest

import simple_tip_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "simple_tip_tpu", "pandas", "sklearn")


def _port_sources():
    pkg = os.path.join(ROOT, "simple_tip_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "scripts", "torch_flash_bwd_ab.py")
    yield os.path.join(ROOT, "scripts", "torch_cold_build_race.py")
    yield os.path.join(ROOT, "scripts", "torch_sched_phase.py")
    yield os.path.join(ROOT, "scripts", "torch_gloo_cuda_probe.py")
    yield os.path.join(ROOT, "scripts", "torch_sp_phase.py")
    yield os.path.join(ROOT, "scripts", "torch_profiler_probe.py")
    yield os.path.join(ROOT, "scripts", "torch_obs_phase.py")


def _imported_tops(path: str):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


@pytest.mark.parametrize(
    "path", sorted(_port_sources()), ids=lambda p: os.path.relpath(p, ROOT)
)
def test_no_jax_or_reference_imports(path):
    bad = [
        name
        for name in _imported_tops(path)
        if name.split(".")[0] in FORBIDDEN
    ]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_every_port_module_imports_without_a_card():
    failures = []
    for mod in pkgutil.walk_packages(
        simple_tip_tpu_torch.__path__, prefix="simple_tip_tpu_torch."
    ):
        try:
            importlib.import_module(mod.name)
        except Exception as e:  # noqa: BLE001 - report all, then fail once
            failures.append(f"{mod.name}: {type(e).__name__}: {e}")
    assert not failures, "\n".join(failures)


STDLIB_ONLY = (
    "simple_tip_tpu_torch.parallel.run_scheduler",
    "simple_tip_tpu_torch.parallel.fleet",
    "simple_tip_tpu_torch.resilience",
    "simple_tip_tpu_torch.resilience.faults",
    "simple_tip_tpu_torch.resilience.journal",
    "simple_tip_tpu_torch.resilience.lease",
    "simple_tip_tpu_torch.obs.logbridge",
    "simple_tip_tpu_torch.utils.device_watchdog",
    "simple_tip_tpu_torch.utils.artifacts_io",
    # the observability and planning plane: operators run the obs CLI, the
    # alerts and the planner on hosts with no card
    "simple_tip_tpu_torch.obs",
    "simple_tip_tpu_torch.obs.devicemeter",
    "simple_tip_tpu_torch.obs.store",
    "simple_tip_tpu_torch.obs.costmodel",
    "simple_tip_tpu_torch.obs.slo",
    "simple_tip_tpu_torch.obs.alerts",
    "simple_tip_tpu_torch.obs.regress",
    "simple_tip_tpu_torch.obs.live",
    "simple_tip_tpu_torch.obs.splice",
    "simple_tip_tpu_torch.obs.cli",
    "simple_tip_tpu_torch.plan",
    "simple_tip_tpu_torch.plan.knobs",
    "simple_tip_tpu_torch.plan.plan",
    "simple_tip_tpu_torch.plan.search",
    "simple_tip_tpu_torch.plan.cli",
    "simple_tip_tpu_torch.utils.flops",
    "simple_tip_tpu_torch.utils.profiling",
    "simple_tip_tpu_torch.serving.admission",
)


@pytest.mark.parametrize("module", STDLIB_ONLY)
def test_study_execution_modules_import_no_torch(module):
    code = (
        "import importlib, sys; importlib.import_module(sys.argv[1]); "
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'numpy', 'jax', 'simple_tip_tpu')))"
    )
    out = subprocess.run([sys.executable, "-c", code, module], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


SEQUENCE_PARALLEL = (
    "simple_tip_tpu_torch.parallel.exchange",
    "simple_tip_tpu_torch.parallel.ring_attention",
    "simple_tip_tpu_torch.parallel.ulysses_attention",
    "simple_tip_tpu_torch.parallel.distributed",
    "simple_tip_tpu_torch.full_study",
)


@pytest.mark.parametrize("module", SEQUENCE_PARALLEL)
def test_sequence_parallel_modules_import_no_jax(module):
    code = (
        "import importlib, sys; importlib.import_module(sys.argv[1]); "
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'simple_tip_tpu')))"
    )
    out = subprocess.run([sys.executable, "-c", code, module], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
