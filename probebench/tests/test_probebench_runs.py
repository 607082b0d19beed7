"""Whole runs on the CPU, the look for a card skipped: the last line's shape,
the control, and each fault a cell can have planted underneath the timed
path, which has to read ``correct: false``.  The probes run their plain
versions here at the program's CPU sizes (the burn chain 16 products, not
the card's 64 or 1024), so each run takes some tens of seconds."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from probebench import core  # noqa: E402
from probebench import control  # noqa: E402

FAULTS = {
    # A step that returns its state unchanged: the HBM stream leaves every
    # element but the first (the one the probe reads back) as it was.
    "stream_unchanged": """
        from tpu_node_checker_torch.ops import hbm
        _orig = hbm._stream_n
        def _stream_n(x, iters):
            y = _orig(x, iters)
            y[1:] = x[1:]
            return y
        hbm._stream_n = _stream_n
    """,
    # Half of the batch left out: the burn chain runs half its products.
    "chain_half": """
        import sys
        import tpu_node_checker_torch.ops
        burn = sys.modules["tpu_node_checker_torch.ops.burn"]
        _orig = burn._burn_chain
        burn._burn_chain = lambda a, iters: _orig(a, max(1, iters // 2))
    """,
    # An answer altered where it is produced: the tiled matmul's output off
    # by 2**-6, inside the probe's own tolerance of 2e-2.
    "tiled_altered": """
        from tpu_node_checker_torch.ops import pallas_probe
        _orig = pallas_probe.tiled_matmul
        pallas_probe.tiled_matmul = lambda a, b, scale: _orig(a, b, scale) * (1 + 2 ** -6)
    """,
}


def run_main(capsys, workload, seed, seconds=0.5, trace=0, device="cpu"):
    rc = core.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                    "--trace", str(trace)], device=device)
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.fixture
def scratch_tmpdir(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("trace", [0, 1])
def test_a_sound_run_prints_the_result_line(capsys, scratch_tmpdir, trace):
    rc, out, err = run_main(capsys, "emitter-compute", 2 ** 31 + 11, trace=trace)
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    dev = line["device"]
    assert dev["platform"] == "cpu" and dev["count"] == 1 and "memory_peak_bytes" in dev
    if trace:
        assert {"parent_s.emitter", "child_import_s.emitter"} <= set(line["metrics"])
        assert "busy_s" in dev and "window_s" in dev
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        # The CPU's traces hold no device work, so probe_card_ms reads nothing.
        assert set(line["metrics"]) == {"setup_s"}
        assert line["metrics"]["setup_s"]["unit"] == "s" and line["metrics"]["setup_s"]["value"] > 0
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])
    assert all(t.endswith(" ok") for t in tail)


def test_the_control_is_not_correct(capsys, scratch_tmpdir):
    assert control.main(["--workload", "emitter-compute", "--seconds", "0.5",
                         "--seed", "5"], device="cpu") == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["program_correct"] is True
    assert got["control_correct"] is False
    limits = json.loads((ROOT / "probebench/cells/emitter-compute.json").read_text())["limits"]
    assert got["control"]["burn_checksum_gap"] > limits["burn_checksum_gap"]


@pytest.mark.parametrize("workload,fault,check", [
    ("emitter-compute", "stream_unchanged", "stream_mismatches"),
    ("emitter-compute", "chain_half", "burn_checksum_gap"),
    ("emitter-compute", "tiled_altered", "tiled_gap"),
    ("acceptance-soak", "stream_unchanged", "stream_mismatches"),
    ("acceptance-soak", "chain_half", "burn_checksum_gap"),
])
def test_a_fault_under_the_timed_path_is_not_correct(capsys, scratch_tmpdir, monkeypatch,
                                                     workload, fault, check):
    fault_dir = scratch_tmpdir / "fault"
    fault_dir.mkdir()
    (fault_dir / "sitecustomize.py").write_text(textwrap.dedent(FAULTS[fault]))
    monkeypatch.setenv("PYTHONPATH", str(fault_dir))
    rc, out, _ = run_main(capsys, workload, 17)
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is False
    assert line["checks"][check]["value"] > line["checks"][check]["limit"]
    # The program's own checks pass: only the comparison sees the fault.
    assert line["checks"]["rounds_failed"]["value"] == 0
    assert line["checks"]["outputs_missing"]["value"] == 0


def _not_written(emit, elsewhere):
    """The round's report goes elsewhere: the target keeps what it had."""
    return lambda target, **kw: emit(str(elsewhere / "report.json"), **kw)


def _written_in_place(emit, elsewhere):
    """The report written into the target's own file, not replaced atomically."""
    def in_place(target, **kw):
        rc, doc = emit(str(elsewhere / "report.json"), **kw)
        with open(target, "w") as f:
            f.write(json.dumps(doc))
        return rc, doc
    return in_place


PARENT_FAULTS = {"report_not_written": _not_written, "report_in_place": _written_in_place}


@pytest.mark.parametrize("workload,fault", [
    ("emitter-compute", "report_not_written"),
    ("emitter-compute", "report_in_place"),
    ("emitter-compute", "report_off_schema"),
    ("acceptance-soak", "report_not_written"),
])
def test_a_report_that_breaks_its_guarantee_is_not_correct(capsys, scratch_tmpdir, monkeypatch,
                                                           workload, fault):
    from tpu_node_checker_torch import emit

    monkeypatch.delenv("TNC_SCHEMA_STRICT", raising=False)
    if fault == "report_off_schema":
        # A probe figure of the wrong type, which the emitter's own check
        # only warns of, written as it is.
        probe = emit.run_local_probe

        def off_schema(**kw):
            res = probe(**kw)
            res.details["dma_gbps"] = str(res.details.get("dma_gbps"))
            return res
        monkeypatch.setattr(emit, "run_local_probe", off_schema)
    else:
        elsewhere = scratch_tmpdir / "elsewhere"
        elsewhere.mkdir()
        monkeypatch.setattr(emit, "emit_probe_once",
                            PARENT_FAULTS[fault](emit.emit_probe_once, elsewhere))
    seconds = 0.5 if workload == "emitter-compute" else 0.2
    rc, out, err = run_main(capsys, workload, 19, seconds=seconds)
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is False
    assert line["checks"]["report_mismatches"]["value"] >= 1
    assert "probebench: report_mismatches: round " in err
    assert line["checks"]["rounds_failed"]["value"] == 0


def test_set_up_imports_no_torch_and_children_cache_their_bytecode(tmp_path):
    """The harness's process loads no torch (nor numpy) before the window
    closes, and hands the probe child a bytecode cache in the checkout even
    where the interpreter is told to write none."""
    code = textwrap.dedent("""
        import json, os, sys
        sys.path.insert(0, %r)
        from probebench import core
        from tpu_node_checker_torch import emit

        core.CACHE_DIR = __import__("pathlib").Path(%r)
        seen = []

        def fake_emit(target, **kw):
            seen.append({"torch": "torch" in sys.modules, "numpy": "numpy" in sys.modules,
                         "prefix": os.environ.get("PYTHONPYCACHEPREFIX"),
                         "dont_write": os.environ.get("PYTHONDONTWRITEBYTECODE")})
            doc = {"ok": True, "level": "compute"}
            with open(target, "w") as f:
                json.dump(doc, f)
            return 0, doc

        emit.emit_probe_once = fake_emit
        prefix = sys.pycache_prefix
        core.main(["--workload", "emitter-compute", "--seed", "3", "--seconds", "0.1",
                   "--trace", "0"], device="cpu")
        print(json.dumps({"seen": seen, "restored": sys.pycache_prefix == prefix}))
    """) % (str(ROOT), str(tmp_path / "cache"))
    env = {**os.environ, "PYTHONDONTWRITEBYTECODE": "1", "TMPDIR": str(tmp_path)}
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["restored"] and len(got["seen"]) >= 2
    for round_ in got["seen"]:
        assert round_ == {"torch": False, "numpy": False, "dont_write": None,
                          "prefix": str(tmp_path / "cache" / "pycache")}
    # What the harness imported after the window went into the cache.
    assert list((tmp_path / "cache" / "pycache").rglob("judge*.pyc"))


@pytest.mark.cuda
def test_each_cell_is_correct_on_the_card(capsys, scratch_tmpdir, card):
    for workload in ("emitter-compute", "acceptance-soak"):
        rc, out, _ = run_main(capsys, workload, 23, seconds=2, device=None)
        assert rc == 0
        line = json.loads(out.strip().splitlines()[-1])
        assert line["correct"] is True
        assert {"emitter-compute": "probe_card_ms", "acceptance-soak": "soak_tflops"}[
            workload] in line["metrics"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the probes' kernels have no CPU mode")
    return torch.cuda.get_device_name(0)
