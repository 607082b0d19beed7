"""The port's chaos fuzzer, shrinker, reproducer replay and analytics smoke,
held byte-identical to the JAX package's.

* the grammar samples the same program from the same seed;
* ``run_fuzz(7, 10)`` through ``fuzz_report_json`` gives equal bytes;
* the shrinker takes ``tests/test_sim_fuzz.py``'s sabotaged world to
  the same minimal program by the same steps, and that program replays
  red with equal bytes;
* a malformed program is refused with the same words;
* every file in ``tests/sim_reproducers/`` replays through both
  ``run_program``\\ s with equal ``ok``, violated invariants and report
  bytes (``over-budget-sabotage.json`` stays red on both), and through both
  CLIs' ``--replay`` with equal stdout and exit code;
* ``sim.analytics_smoke --seed 7`` gives equal stdout and exit code.

Both packages run in this process: each run resets its own package's
checker state, and ``tests/test_torch_cluster.py``'s autouse fixture
resets both packages' caches and records both retry ``_sleep`` seams
around every case (nothing sleeps).

The port is reached through ``importlib.import_module``:
tests/test_dependency_surface.py rejects any other ``import`` in tests/.
"""

import glob
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from tests.test_sim_fuzz import _sabotage_program
from tests.test_torch_cluster import _isolated  # noqa: F401 — the autouse fixture
from tpu_node_checker.sim import engine as jax_engine
from tpu_node_checker.sim import fuzz as jax_fuzz

port_engine = importlib.import_module("tpu_node_checker_torch.sim.engine")
port_fuzz = importlib.import_module("tpu_node_checker_torch.sim.fuzz")

REPO = Path(__file__).resolve().parent.parent
REPRO_FILES = sorted(glob.glob(str(REPO / "tests" / "sim_reproducers" / "*.json")))
FUZZ = {"port": port_fuzz, "jax": jax_fuzz}


def test_grammar_samples_equal_programs():
    for seed in range(16):
        assert port_fuzz.sample_program(seed) == jax_fuzz.sample_program(seed)


def test_fuzz_campaign_is_byte_identical_to_jax():
    port = port_fuzz.fuzz_report_json(port_fuzz.run_fuzz(7, 10))
    ref = jax_fuzz.fuzz_report_json(jax_fuzz.run_fuzz(7, 10))
    assert port == ref
    report = json.loads(port)
    assert [r["seed"] for r in report["runs"]] == list(range(7, 17))
    assert report["ok"] is True and report["reproducer"] is None


def test_shrinker_takes_the_sabotage_to_the_same_reproducer():
    shrunk = {side: fuzz.shrink(_sabotage_program(), "disruption-budget")
              for side, fuzz in FUZZ.items()}
    assert shrunk["port"] == shrunk["jax"]
    program, steps = shrunk["port"]
    assert program["programs"] == {} and program["slices"] == 1
    assert any(s.startswith("halve-fleet") for s in steps)
    replay = {side: fuzz.run_program(program) for side, fuzz in FUZZ.items()}
    assert replay["port"].report_json == replay["jax"].report_json
    assert "disruption-budget" in port_fuzz.violated(replay["port"])


@pytest.mark.parametrize("program", [
    {"slices": 1, "rounds": 2, "programs": {"nope-s9-h9": ["fail-at", 1]}},
    {"slices": 1, "rounds": 2, "programs": {"sim-c0-s0-h0": ["explode", 1]}},
    {"slices": 1, "rounds": 2, "programs": {"sim-c0-s0-h0": ["flap", 1]}},
    {"slices": 1, "rounds": 2, "programs": {}, "api_faults": {"1": 7}},
], ids=["unknown-node", "unknown-kind", "bad-arity", "bad-fault"])
def test_malformed_program_is_refused_alike(program):
    words = {}
    for side, fuzz in FUZZ.items():
        engine = port_engine if side == "port" else jax_engine
        with pytest.raises(engine.ScenarioError) as err:
            fuzz.run_program(program)
        words[side] = str(err.value)
    assert words["port"] == words["jax"]


@pytest.mark.parametrize("path", REPRO_FILES,
                         ids=[os.path.splitext(os.path.basename(p))[0] for p in REPRO_FILES])
def test_reproducer_replays_alike(path):
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    runs = {side: fuzz.run_program(doc["program"], seed=int(doc.get("seed", 0)))
            for side, fuzz in FUZZ.items()}
    assert runs["port"].ok == runs["jax"].ok
    assert runs["port"].report_json == runs["jax"].report_json
    assert runs["port"].events == runs["jax"].events
    bad = port_fuzz.violated(runs["port"])
    assert bad == jax_fuzz.violated(runs["jax"])
    if doc["expect"] == "green":
        assert not bad
    else:
        assert doc["invariant"] in bad


def _cold(*argv):
    env = {k: v for k, v in os.environ.items() if not k.startswith("TNC_")}
    proc = subprocess.run([sys.executable, "-m", *argv], capture_output=True, text=True,
                          cwd=REPO, timeout=300, env=env)
    return proc.returncode, proc.stdout


def test_replay_through_both_clis_is_equal():
    # The human renderer of a red replay: the failing rows named, exit 3.
    path = str(REPO / "tests" / "sim_reproducers" / "over-budget-sabotage.json")
    port = _cold("tpu_node_checker_torch", "simulate", "--replay", path)
    ref = _cold("tpu_node_checker", "simulate", "--replay", path)
    assert port == ref
    assert port[0] == 3 and "disruption-budget" in port[1]


def test_analytics_smoke_is_equal():
    port = _cold("tpu_node_checker_torch.sim.analytics_smoke", "--seed", "7")
    ref = _cold("tpu_node_checker.sim.analytics_smoke", "--seed", "7")
    assert port == ref
    assert port[0] == 0 and json.loads(port[1])
