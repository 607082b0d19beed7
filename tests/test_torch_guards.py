"""Guards on the PyTorch/CUDA port's boundaries.

* No module of ``tpu_node_checker_torch`` (its probe child script included)
  and neither ``chip_smoke.py`` nor ``fabric_smoke.py`` imports ``jax`` or
  the JAX package: checked by an
  AST scan and by a fresh interpreter that imports every port module.
* Every port module imports on a box without CUDA, nvcc or triton.

The port is reached through ``importlib.import_module``:
tests/test_dependency_surface.py rejects any other ``import`` in tests/, and
a missing torch must fail loudly, not skip.
"""

import ast
import importlib
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "tpu_node_checker_torch"
FORBIDDEN = {"jax", "jaxlib", "tpu_node_checker"}


def _imported_roots(tree: ast.AST) -> set:
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def _port_sources() -> list:
    paths = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "fabric_smoke.py"]
    assert len(paths) > 15, "found too few port sources: the scan itself broke"
    return paths


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_source_imports_nothing_of_jax(path):
    found = _imported_roots(ast.parse(path.read_text(), filename=str(path))) & FORBIDDEN
    assert not found, f"{path.relative_to(REPO)} imports {sorted(found)}"


def test_probe_child_script_imports_nothing_of_jax():
    liveness = importlib.import_module("tpu_node_checker_torch.probe.liveness")
    roots = _imported_roots(ast.parse(liveness._CHILD_SCRIPT))
    assert "torch" in roots
    assert not roots & FORBIDDEN


def _port_modules() -> list:
    pkg = importlib.import_module("tpu_node_checker_torch")
    return ["tpu_node_checker_torch"] + [
        m.name for m in pkgutil.walk_packages(pkg.__path__, "tpu_node_checker_torch.")
    ]


def test_every_port_module_imports_here():
    failures = {}
    for name in _port_modules():
        try:
            importlib.import_module(name)
        except Exception as exc:  # noqa: BLE001 — collect, report all at once
            failures[name] = f"{type(exc).__name__}: {exc}"
    assert not failures, f"port modules that fail to import: {failures}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('jax', 'jaxlib', 'tpu_node_checker'))))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
