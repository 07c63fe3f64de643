"""The port stands alone: no module of ``simple_tip_tpu_torch``, not
``chip_smoke.py`` and not the port's card scripts import jax, flax,
anything of ``simple_tip_tpu``, pandas or sklearn (the card machine has
neither of the last two), checked on the source, so lazy imports inside
functions count too; and every module imports without a card."""

import ast
import importlib
import os
import pkgutil

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
