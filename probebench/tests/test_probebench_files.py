"""A configuration added as files alone: a copy of the checkout gains a
configuration, a cell, a traffic mix, a reference of a new output kind, a tap
that records it and a metric reader, and entries in BENCHMARK.json, and no
file the benchmark already has changes.  A whole run on the CPU judges the
new kind: ``correct: true``, and ``false`` with a fault planted in what the
tap records."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

# The HBM stream's every element, summed: the pass count times its length.
REFERENCE = '''
"""stream_total: the HBM stream's elements summed, against passes x elements."""

CHECK = "stream_total_gap"
REDUCE = "max"


def compare(args, idx, got, device):
    want = float(idx[0]) * float(idx[1])
    return CHECK, abs(float(got[0]) - want) / want
'''
TAP = '''
"""Tap: the HBM stream's total, each time the stream runs."""

MODULE = "tpu_node_checker_torch.ops.hbm"


def install(cap, hbm):
    def total(out, args, kwargs):
        x = args[0] if args else kwargs["x"]
        iters = args[1] if len(args) > 1 else kwargs["iters"]
        cap.record("stream_total", [x.numel(), iters], [float(out.double().sum())], {})

    hbm._stream_n = cap.tap(hbm._stream_n, total)
'''
READER = '''
"""stream_totals: how many stream totals the window's rounds recorded."""


def read(run):
    return float(sum(1 for r in run.rounds for o in (r["capture"] or {}).get("outputs", [])
                     if o["kind"] == "stream_total"))
'''
# Underneath the timed path: the stream leaves its second half as it was.
STREAM_HALF_UNCHANGED = """
    from tpu_node_checker_torch.ops import hbm
    _orig = hbm._stream_n
    def _stream_n(x, iters):
        y = _orig(x, iters)
        half = y.numel() // 2
        y.view(-1)[half:] = x.view(-1)[half:]
        return y
    hbm._stream_n = _stream_n
"""


def digests(folder: Path) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def add_configuration(dst: Path) -> None:
    pb = dst / "probebench"
    cfg = json.loads((pb / "configs" / "daemonset-emitter.json").read_text())
    cfg["name"] = "stream-total"
    (pb / "configs" / "stream-total.json").write_text(json.dumps(cfg))
    traffic = {"warmup_rounds": 0, "window": "rounds", "samples": 64,
               "judged": {"stream": 1, "stream_total": 1}, "trace": "rounds"}
    (pb / "traffic" / "stream-total-rounds.json").write_text(json.dumps(traffic))
    cell = {"config": "stream-total", "traffic": "stream-total-rounds", "chips": 1,
            "who": "test", "why": "test",
            "limits": {"rounds_failed": 0, "outputs_missing": 0, "report_mismatches": 0,
                       "stream_mismatches": 0, "stream_total_gap": 1e-9}}
    (pb / "cells" / "stream-total.json").write_text(json.dumps(cell))
    (pb / "reference" / "stream_total.py").write_text(REFERENCE)
    (pb / "hook" / "taps" / "stream_total.py").write_text(TAP)
    (pb / "metrics" / "stream_totals.py").write_text(READER)
    b = json.loads((dst / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "stream-total", "source": "test",
                         "file": "probebench/configs/stream-total.json",
                         "reduced": list(cfg["reduced"]), "why": "test"})
    b["workloads"].append({"name": "stream-total", "config": "stream-total",
                           "traffic": "stream-total-rounds", "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "stream_totals", "unit": "count", "better": "higher",
                           "source": "program_counter", "layer": "library probes",
                           "moves": "setup_s", "workloads": ["stream-total"]})
    (dst / "BENCHMARK.json").write_text(json.dumps(b))


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """A copy of the benchmark and the program, the configuration added."""
    dst = tmp_path_factory.mktemp("checkout")
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    for name in ("probebench", "tpu_node_checker_torch"):
        shutil.copytree(ROOT / name, dst / name,
                        ignore=shutil.ignore_patterns("__pycache__", "tests", "build"))
    before = digests(dst / "probebench")
    add_configuration(dst)
    after = digests(dst / "probebench")
    assert {k: v for k, v in after.items() if k in before} == before
    return dst


@pytest.mark.parametrize("fault", [None, "stream_half_unchanged"])
def test_a_configuration_added_as_files_alone_is_run_and_judged(checkout, tmp_path, fault):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(TMPDIR=str(tmp_path), OMP_NUM_THREADS="2")
    if fault:
        (tmp_path / "sitecustomize.py").write_text(textwrap.dedent(STREAM_HALF_UNCHANGED))
        env["PYTHONPATH"] = str(tmp_path)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from probebench import core\n"
            "sys.exit(core.main(['--workload', 'stream-total', '--seed', '5', '--seconds', '0.1',"
            " '--trace', '1'], device='cpu'))\n") % str(checkout)
    out = subprocess.run([sys.executable, "-c", code], cwd=checkout, capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line["checks"]) == ["rounds_failed", "outputs_missing", "report_mismatches",
                                    "stream_mismatches", "stream_total_gap"]
    assert line["checks"]["outputs_missing"]["value"] == 0
    assert line["metrics"]["stream_totals"]["value"] >= 1
    gap = line["checks"]["stream_total_gap"]
    if fault is None:
        assert line["correct"] is True and gap["value"] == 0
    else:
        assert line["correct"] is False and gap["value"] > 0.1
        assert line["checks"]["rounds_failed"]["value"] == 0
