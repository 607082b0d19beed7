"""The port's copies of the JAX package's fleet-side modules, held equal.

The port imports nothing of the JAX package, not even its stdlib-only
modules, so it keeps copies: ``utils/quantity.py``, ``resources.py``,
``detect.py``, ``report.py``, ``utils/env.py``, ``notify.py`` and
``history/`` verbatim (only the package name and the module docstring
differ).  Here each copy's code is held equal to its original (the syntax
trees, docstrings dropped, the package name substituted), and the constants
the fleet grades by are compared one by one, in the manner of
``tests/test_torch_probe.py::test_floor_tables_equal_jax``.

Also here: a fresh interpreter runs the port's one-shot round over a
NodeList and finds neither ``jax`` nor the JAX package among its modules.

The port is reached through ``importlib.import_module``:
tests/test_dependency_surface.py rejects any other ``import`` in tests/.
"""

import ast
import importlib
import json
import subprocess
import sys
from pathlib import Path

import pytest

from tests import fixtures as fx
from tpu_node_checker import detect as jax_detect
from tpu_node_checker import notify as jax_notify
from tpu_node_checker import resources as jax_resources
from tpu_node_checker.history import fsm as jax_fsm
from tpu_node_checker.history import store as jax_store

REPO = Path(__file__).resolve().parent.parent
VERBATIM = ["utils/quantity.py", "resources.py", "detect.py", "report.py", "utils/env.py",
            "notify.py", "history/__init__.py", "history/fsm.py", "history/store.py"]


def _code(path: Path, package: str) -> str:
    """The module's syntax tree without docstrings, the package renamed."""
    tree = ast.parse(path.read_text().replace(package, "PKG"))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("module", VERBATIM)
def test_verbatim_copy_equals_jax(module):
    port = _code(REPO / "tpu_node_checker_torch" / module, "tpu_node_checker_torch")
    ref = _code(REPO / "tpu_node_checker" / module, "tpu_node_checker")
    assert port == ref


def _port(name):
    return importlib.import_module(f"tpu_node_checker_torch.{name}")


@pytest.mark.parametrize("module,name", [
    ("detect", "QUARANTINE_ANNOTATION"),
    ("detect", "HARD_PLANNED_DISRUPTIONS"),
    ("detect", "PLANNED_DISRUPTION_TAINTS"),
    ("history.fsm", "DEFAULT_CORDON_AFTER"),
    ("history.fsm", "DEFAULT_UNCORDON_AFTER"),
    ("history.fsm", "DEFAULT_FLAP_THRESHOLD"),
    ("history.fsm", "DEFAULT_FLAP_WINDOW"),
    ("history.store", "DEFAULT_MAX_ROUNDS"),
    ("history.store", "HISTORY_SCHEMA_VERSION"),
    ("notify", "DEFAULT_USERNAME"),
    ("notify", "DEFAULT_ICON"),
    ("notify", "DEFAULT_TIMEOUT_S"),
    ("notify", "DEFAULT_MAX_RETRIES"),
    ("notify", "DEFAULT_RETRY_DELAY_S"),
])
def test_constant_equals_jax(module, name):
    ref = {"detect": jax_detect, "history.fsm": jax_fsm, "history.store": jax_store,
           "notify": jax_notify}[module]
    assert getattr(_port(module), name) == getattr(ref, name)


def test_default_matchers_equal_jax():
    port = _port("resources").DEFAULT_MATCHERS
    ref = jax_resources.DEFAULT_MATCHERS
    assert [(m.pattern, m.family, m.vendor) for m in port] == \
        [(m.pattern, m.family, m.vendor) for m in ref]
    assert port[0].pattern == "nvidia.com/gpu"


def test_round_constants_equal_jax():
    from tpu_node_checker import checker as jax_checker

    port = _port("checker")
    for name in ("EXIT_OK", "EXIT_ERROR", "EXIT_NO_ACCEL_NODES", "EXIT_NONE_READY",
                 "CLOCK_SKEW_ALLOWANCE_S", "REPORT_SCHEMA_VERSION", "_CAUSES_CAP"):
        assert getattr(port, name) == getattr(jax_checker, name), name


def test_slack_defaults_of_the_cli_equal_jax():
    from tpu_node_checker import cli as jax_cli

    port, ref = _port("cli").build_parser(), jax_cli.build_parser()
    for dest in ("slack_username", "slack_retry_count", "slack_retry_delay",
                 "probe_results_max_age", "history_max_rounds", "cordon_after",
                 "uncordon_after", "flap_threshold", "flap_window"):
        assert port.get_default(dest) == ref.get_default(dest), dest


def test_the_round_loads_nothing_of_jax(tmp_path):
    nodes = tmp_path / "nodes.json"
    nodes.write_text(json.dumps(fx.node_list(fx.mixed_cluster_one_notready())))
    script = (
        "import sys\n"
        "from tpu_node_checker_torch import cli\n"
        f"rc = cli.main(['--nodes-json', {str(nodes)!r}, '--json', '--history', "
        f"{str(tmp_path / 'h.jsonl')!r}])\n"
        "loaded = sorted(m for m in sys.modules\n"
        "                if m.split('.')[0] in ('jax', 'jaxlib', 'tpu_node_checker'))\n"
        "print(rc, loaded, file=sys.stderr)\n"
    )
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stderr.strip().splitlines()[-1] == "0 []"
    assert json.loads(proc.stdout)["exit_code"] == 0
