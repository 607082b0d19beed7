"""The benchmark's data layout: BENCHMARK.json against its files, discovery by
name, a cell, configuration and metric added as new files, and the modules
the benchmark loads."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "probebench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_node_checker"}


def bench_json() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_names_files_and_metrics():
    b = bench_json()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["probebench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"probebench/configs/{c['name']}.json"
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    cells = {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4) and len(w["why"]) <= 200
        cell = json.loads((BENCH / "cells" / f"{w['name']}.json").read_text())
        assert (cell["config"], cell["traffic"], cell["chips"]) == (w["config"], w["traffic"], w["chips"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert set(m["workloads"]) <= cells
    for m in metrics:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells)) <= cells
    for w in b["workloads"]:
        reported = [m for m in b["end_to_end"] if w["name"] in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert any(w["name"] in m.get("workloads", cells) for m in b["per_layer"])


def test_cells_have_a_limit_for_every_check():
    sys.path.insert(0, str(ROOT))
    from probebench.judge import checks_of

    for w in bench_json()["workloads"]:
        cell = json.loads((BENCH / "cells" / f"{w['name']}.json").read_text())
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert set(cell["limits"]) == set(checks_of(traffic))


def _copy(tmp_path: Path) -> Path:
    dst = tmp_path / "checkout"
    dst.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(BENCH, dst / "probebench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dst


def test_a_cell_config_and_metric_added_as_new_files(tmp_path):
    dst = _copy(tmp_path)
    pb = dst / "probebench"
    # A new cell adds files and entries, and edits no file of the benchmark.
    cfg = json.loads((pb / "configs" / "daemonset-emitter.json").read_text())
    cfg["name"] = "emitter-two"
    (pb / "configs" / "emitter-two.json").write_text(json.dumps(cfg))
    traffic = json.loads((pb / "traffic" / "compute-rounds.json").read_text())
    traffic["warmup_rounds"] = 2
    (pb / "traffic" / "compute-rounds-warm2.json").write_text(json.dumps(traffic))
    cell = json.loads((pb / "cells" / "emitter-compute.json").read_text())
    cell.update(config="emitter-two", traffic="compute-rounds-warm2")
    (pb / "cells" / "emitter-two.json").write_text(json.dumps(cell))
    (pb / "metrics" / "rounds_in_window.py").write_text(
        "def read(run):\n    return float(len(run.rounds))\n")
    b = bench_json()
    b["configs"].append({"name": "emitter-two", "source": "x", "file": "probebench/configs/emitter-two.json",
                         "reduced": cfg["reduced"] and list(cfg["reduced"]), "why": "test"})
    b["workloads"].append({"name": "emitter-two", "config": "emitter-two",
                           "traffic": "compute-rounds-warm2", "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "rounds_in_window", "unit": "rounds", "better": "higher",
                           "source": "host_clock", "layer": "emitter and probe parent",
                           "moves": "setup_s", "workloads": ["emitter-two"]})
    (dst / "BENCHMARK.json").write_text(json.dumps(b))
    probe = (
        "import json\n"
        "from probebench.core import ROOT, load_cell, cell_metrics, load_json, load_reader\n"
        "b = load_json(ROOT / 'BENCHMARK.json')\n"
        "cell, config, traffic = load_cell('emitter-two', b)\n"
        "class R: rounds = [1, 2, 3]\n"
        "print(json.dumps({'root': str(ROOT), 'config': config['name'],\n"
        "  'warm': traffic['warmup_rounds'],\n"
        "  'layer': [m['name'] for m in cell_metrics(b, 'emitter-two', True)],\n"
        "  'e2e': [m['name'] for m in cell_metrics(b, 'emitter-two', False)],\n"
        "  'value': load_reader('rounds_in_window')(R())}))\n"
    )
    out = subprocess.run([sys.executable, "-c", probe], cwd=dst, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(dst)}, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["root"] == str(dst)
    assert got["config"] == "emitter-two" and got["warm"] == 2
    assert got["layer"] == ["rounds_in_window"] and got["e2e"] == ["setup_s"]
    assert got["value"] == 3.0


def test_without_the_program_the_command_fails_and_prints_no_result(tmp_path):
    dst = _copy(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "probebench/run.py", "--workload", "emitter-compute", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=dst, capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
    assert "tpu_node_checker_torch" in out.stderr


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path
    for path in (BENCH / "reference").rglob("*.py"):
        assert "tpu_node_checker_torch" not in _imports(path), path


def test_loaded_modules_hold_no_jax_and_the_reference_none_of_the_program():
    code = (
        "import sys, json\n"
        "sys.path.insert(0, %r)\n"
        "import probebench.reference.probes\n"
        "ref_only = sorted(m for m in sys.modules if m.split('.')[0].startswith('tpu_node_checker'))\n"
        "from probebench import core, judge, control, driver, trace, roofline\n"
        "from pathlib import Path\n"
        "for p in sorted(Path(%r).glob('*.py')): core.load_reader(p.stem)\n"
        "import tpu_node_checker_torch.emit\n"
        "print(json.dumps({'ref': ref_only, 'forbidden': core.forbidden_modules(),\n"
        "  'tops': sorted({m.split('.')[0] for m in sys.modules})}))\n"
    ) % (str(ROOT), str(BENCH / "metrics"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["ref"] == []
    assert got["forbidden"] == []
    assert not set(got["tops"]) & FORBIDDEN
    assert "tpu_node_checker_torch" in got["tops"]


@pytest.mark.parametrize("names,expected", [
    ({"jax.numpy"}, ["jax"]),
    ({"tpu_node_checker.cli"}, ["tpu_node_checker"]),
    ({"tpu_node_checker_torch.cli", "jaxtyping", "flaxen"}, []),
])
def test_forbidden_modules_compares_whole_top_level_names(monkeypatch, names, expected):
    sys.path.insert(0, str(ROOT))
    from probebench import core

    fake = {n: None for n in names}
    monkeypatch.setattr(core.sys, "modules", fake)
    assert core.forbidden_modules() == expected
