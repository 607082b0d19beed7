"""The port's ``simulate`` subcommand, held byte-identical to the JAX one.

The port's ``sim/`` is a verbatim copy of the JAX package's
(``tests/test_torch_copies.py``), but it drives the port's own checker,
CLI parser, tracer, watch stream, federation, fleet API and remediation.
The simulator is seeded and deterministic by contract: for the same
``(scenario, seed, params)`` its report JSON and canonical event log are
byte-identical, and they hold no wall time, port or message text.  So the
port must print byte for byte what the JAX simulator prints:

* the registries are equal (names, titles, defaults, tunables, invariants,
  the composed scenario included);
* every scenario at its defaults with seed 7 gives equal report bytes and
  event lines on both sides, and the port's replay in one process equals
  itself; ``flap-storm`` at 64 nodes a cluster is red (``slack-dedup``) on
  both sides with equal bytes; ``mass-cordon-storm`` at 1,000 nodes a
  cluster is equal;
* through ``python -m tpu_node_checker_torch simulate`` against
  ``python -m tpu_node_checker simulate``: equal stdout and exit code for
  ``--list-scenarios`` and ``flap-storm`` (json and human), and equal
  stderr and exit 2 for each usage error;
* a fresh interpreter that runs ``simulate`` through the port loads no
  ``jax``, ``jaxlib`` or ``tpu_node_checker`` module.

Both packages run in this process: each run resets its own package's
checker state (``_reset_checker_state``, at its start and end), and
``tests/test_torch_cluster.py``'s autouse fixture resets both packages'
client and history caches and records both retry ``_sleep`` seams around
every case (nothing sleeps).

The port is reached through ``importlib.import_module``:
tests/test_dependency_surface.py rejects any other ``import`` in tests/.
"""

import concurrent.futures
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from tests.test_torch_cluster import _isolated  # noqa: F401 — the autouse fixture
from tpu_node_checker.sim import engine as jax_engine
from tpu_node_checker.sim.scenarios import SCENARIOS as JAX_SCENARIOS

port_engine = importlib.import_module("tpu_node_checker_torch.sim.engine")
PORT_SCENARIOS = importlib.import_module("tpu_node_checker_torch.sim.scenarios").SCENARIOS

REPO = Path(__file__).resolve().parent.parent
SEED = 7


def _registry(scenarios):
    return {name: (s.title, s.defaults, s.tunable, s.invariants)
            for name, s in scenarios.items()}


def test_registry_equals_jax():
    assert _registry(PORT_SCENARIOS) == _registry(JAX_SCENARIOS)
    assert list(PORT_SCENARIOS) == list(JAX_SCENARIOS)
    assert len(PORT_SCENARIOS) == 11 and "flap-storm+api-brownout" in PORT_SCENARIOS


def _both(name, **params):
    """The JAX run, then the port's, of one scenario in this process."""
    return (jax_engine.run_scenario(name, SEED, **params),
            port_engine.run_scenario(name, SEED, **params))


@pytest.mark.parametrize("name", sorted(JAX_SCENARIOS))
def test_scenario_is_byte_identical_to_jax(name):
    ref, port = _both(name)
    assert port.report_json == ref.report_json
    assert port.events == ref.events
    assert port.ok and ref.ok
    again = port_engine.run_scenario(name, SEED)
    assert again.report_json == port.report_json and again.events == port.events


def test_flap_storm_at_64_nodes_is_red_on_both_sides():
    # The reference fails slack-dedup from 64 nodes a cluster; the port
    # copies the verdict and its words.
    ref, port = _both("flap-storm", nodes_per_cluster=64)
    assert port.report_json == ref.report_json and port.events == ref.events
    failed = [v["name"] for v in port.report["invariants"] if not v["ok"]]
    assert not port.ok and failed == ["slack-dedup"]


def test_mass_cordon_storm_at_1000_nodes_is_equal():
    ref, port = _both("mass-cordon-storm", nodes_per_cluster=1000)
    assert port.report_json == ref.report_json and port.events == ref.events
    assert port.ok and port.params["nodes_per_cluster"] == 1000


CLI_CASES = {
    "list-scenarios": (["--list-scenarios"], 0),
    "flap-storm json": (["--scenario", "flap-storm", "--seed", "7", "--report", "json"], 0),
    "flap-storm human": (["--scenario", "flap-storm", "--seed", "7"], 0),
    "unknown scenario": (["--scenario", "nope"], 2),
    "no scenario": ([], 2),
    "fuzz with scenario": (["--fuzz", "--scenario", "flap-storm"], 2),
    "replay with fuzz": (["--replay", "x.json", "--fuzz"], 2),
    "fuzz seeds 0": (["--fuzz", "--seeds", "0"], 2),
    "list with scenario": (["--list-scenarios", "--scenario", "flap-storm"], 2),
}


def _cli(package, args):
    env = {k: v for k, v in os.environ.items() if not k.startswith("TNC_")}
    proc = subprocess.run([sys.executable, "-m", package, "simulate", *args],
                          capture_output=True, text=True, cwd=REPO, timeout=300, env=env)
    return proc.returncode, proc.stdout, proc.stderr


@pytest.fixture(scope="module")
def cli_runs():
    """Every case through both CLIs, cold, two processes at a time."""
    keys = [(case, package) for case in CLI_CASES
            for package in ("tpu_node_checker_torch", "tpu_node_checker")]
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        done = pool.map(lambda key: _cli(key[1], CLI_CASES[key[0]][0]), keys)
        return dict(zip(keys, done))


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cold_cli_equals_jax(cli_runs, case):
    port = cli_runs[(case, "tpu_node_checker_torch")]
    ref = cli_runs[(case, "tpu_node_checker")]
    expected = CLI_CASES[case][1]
    assert port[0] == ref[0] == expected, (port[2][-2000:], ref[2][-2000:])
    assert port[1] == ref[1]
    if expected == 2:
        # Usage errors: argparse's words, prog "tpu-node-checker simulate".
        assert port[2] == ref[2] and "tpu-node-checker simulate: error:" in port[2]
    else:
        assert port[1]


def test_simulate_loads_nothing_of_jax():
    # One fresh interpreter: the list, the scenarios that reach the watch
    # stream, the federation (poll and feed), the fleet API and the lease,
    # the mesh-level reports, a one-seed fuzz campaign and the analytics
    # smoke, all through the port.
    script = (
        "import json, sys\n"
        "from tpu_node_checker_torch import cli\n"
        "from tpu_node_checker_torch.sim import analytics_smoke\n"
        "rcs = [cli.main(['simulate', '--list-scenarios'])]\n"
        "for name in ('watch-loss-relist', 'federated-world', 'aggregator-death',\n"
        "             'degraded-link'):\n"
        "    rcs.append(cli.main(['simulate', '--scenario', name, '--seed', '7',\n"
        "                         '--report', 'json']))\n"
        "rcs.append(cli.main(['simulate', '--fuzz', '--seeds', '1', '--report', 'json']))\n"
        "rcs.append(analytics_smoke.main(['--seed', '7']))\n"
        "loaded = sorted(m for m in sys.modules\n"
        "                if m.split('.')[0] in ('jax', 'jaxlib', 'tpu_node_checker'))\n"
        "sim = sorted(m for m in sys.modules if m.startswith('tpu_node_checker_torch.sim'))\n"
        "print('RESULT ' + json.dumps([rcs, loaded, sim]))\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("TNC_")}
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          cwd=REPO, timeout=300, env=env)
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT")]
    assert proc.returncode == 0 and line, proc.stderr[-3000:]
    rcs, loaded, sim = json.loads(line[0][len("RESULT "):])
    assert rcs == [0] * 7
    assert loaded == []
    assert len(sim) == 11  # every file of sim/
