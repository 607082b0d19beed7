"""The port's node-side emitter, held against the JAX checker's.

The port's ``emit.py`` and ``cli.py`` copy the JAX checker's emitter modes:
``--emit-probe`` once or with ``--watch`` (the DaemonSet's loop, one
``--log-jsonl`` line per round), ``--report-fresh`` (the pod's livenessProbe)
and ``--probe-report-schema``, with the soak, topology and floor flags.  Each
copy is held against its original here: the round entry and what the JAX
``--trend`` reads from a port log, the liveness verdict on the same files,
the schema, the usage errors, and the loop's rounds, cadence and stop,
driven through its wait seam as the JAX loop's own tests drive it.

Also pinned: the one report-level divergence from the JAX child.  When a
sub-probe of the workload level fails, the port's child names it in
``error`` (the JAX child only clears ``ok``), and the round log's
``causes`` carries that message.

torch and the port are reached through ``importlib.import_module``:
tests/test_dependency_surface.py rejects any other ``import`` in tests/.
"""

import importlib
import json
import math
import os
import re
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from tests.test_torch_cluster import outcome_vs_jax
from tpu_node_checker import checker as jax_checker
from tpu_node_checker import cli as jax_cli

port_cli = importlib.import_module("tpu_node_checker_torch.cli")
port_emit = importlib.import_module("tpu_node_checker_torch.emit")
port_liveness = importlib.import_module("tpu_node_checker_torch.probe.liveness")
ProbeResult = port_liveness.ProbeResult

REPO = Path(__file__).resolve().parent.parent
NODE = "gke-gpu-pool-0"


def _clean_env(mp):
    for k in [k for k in os.environ if k.startswith("TNC_")]:
        mp.delenv(k)


class FakeClock:
    """Stands in for the ``time`` module inside ``emit``: the loop's
    monotonic clock and the wall clock of its entries, moved by hand."""

    def __init__(self):
        self.mono = 0.0

    def monotonic(self):
        return self.mono

    def time(self):
        return 1_760_000_000.0 + self.mono

    def advance(self, seconds):
        self.mono += seconds


HEALTHY = ProbeResult(ok=True, level="compute", hostname=NODE, elapsed_ms=7400.0,
                      device_count=1, platform="gpu", details={"matmul_tflops": 313.2})
FAILING = ProbeResult(ok=False, level="compute", hostname=NODE, elapsed_ms=9100.0,
                      device_count=1, platform="gpu", error="dma_stream mismatch",
                      details={"dma_ok": False})
SILENT = ProbeResult(ok=False, level="workload", hostname=NODE, elapsed_ms=12000.0,
                     device_count=1, platform="gpu")


class TestCopiesOfJax:
    def test_constants_equal_jax(self):
        assert port_emit.CLOCK_SKEW_ALLOWANCE_S == jax_checker.CLOCK_SKEW_ALLOWANCE_S
        assert port_emit.REPORT_SCHEMA_VERSION == jax_checker.REPORT_SCHEMA_VERSION
        assert (port_emit.EXIT_OK, port_emit.EXIT_ERROR, port_emit.EXIT_NONE_READY) == (
            jax_checker.EXIT_OK, jax_checker.EXIT_ERROR, jax_checker.EXIT_NONE_READY)

    @pytest.mark.parametrize("dest", [
        "emit_probe", "report_fresh", "probe_report_schema", "probe_level", "probe_timeout",
        "watch", "log_jsonl", "probe_results_max_age", "probe_soak", "probe_topology",
        "perf_floor", "metrics_port", "selftest", "json", "calibrate", "calibrate_margin",
        "calibrate_out",
    ])
    def test_flag_defaults_equal_jax(self, dest):
        assert port_cli.build_parser().get_default(dest) == \
            jax_cli.build_parser().get_default(dest)

    @pytest.mark.parametrize("result,rc", [(HEALTHY, 0), (FAILING, 3), (SILENT, 3)],
                             ids=["healthy", "failing", "failing-without-error"])
    def test_round_entry_equals_jax(self, result, rc):
        doc = {**result.to_dict(), "schema": 1, "written_at": 0.0}
        port = port_emit.emitter_round_entry(rc, doc)
        ref = jax_checker._emitter_round_entry(rc, doc)
        assert port.pop("ts") == pytest.approx(ref.pop("ts"), abs=5.0)
        assert port == ref

    def test_jsonl_append_never_raises(self, tmp_path, capsys):
        port_emit.append_jsonl(str(tmp_path / "no-such-dir" / "log.jsonl"), {"exit_code": 0})
        assert "Cannot append state log" in capsys.readouterr().err


def _drive_loop(monkeypatch, tmp_path, results, argv=()):
    """Run the port's loop through its CLI with ``results`` as the probe's
    rounds (a ProbeResult, an exception to raise, or a (result, seconds)
    pair for a round that takes that long on the fake clock).  Returns
    (exit code, probe calls, waits asked for, log entries, round starts)."""
    clock = FakeClock()
    calls, waits, starts = [], [], []
    pending = list(results)

    def fake_probe(**kw):
        calls.append(kw)
        starts.append(clock.monotonic())
        item = pending.pop(0)
        result, seconds = item if isinstance(item, tuple) else (item, 1.0)
        clock.advance(seconds)
        if isinstance(result, Exception):
            raise result
        return result

    def fake_wait(stop, seconds):
        waits.append(seconds)
        clock.advance(seconds)
        return len(calls) >= len(results)

    monkeypatch.setattr(port_emit, "time", clock)
    monkeypatch.setattr(port_emit, "run_local_probe", fake_probe)
    monkeypatch.setattr(port_emit, "_wait_for_next_round", fake_wait)
    report, log = tmp_path / "r.json", tmp_path / "rounds.jsonl"
    rc = port_cli.main(["--emit-probe", str(report), "--watch", "5", "--log-jsonl", str(log),
                        *argv])
    entries = [json.loads(x) for x in log.read_text().splitlines()] if log.exists() else []
    return rc, calls, waits, entries, starts


class TestLoop:
    def test_n_rounds_give_n_lines_and_a_report(self, monkeypatch, tmp_path):
        rc, calls, _, entries, _ = _drive_loop(monkeypatch, tmp_path, [HEALTHY, FAILING, HEALTHY])
        assert rc == 143
        assert len(calls) == 3 and len(entries) == 3
        assert [e["exit_code"] for e in entries] == [0, 3, 0]
        assert entries[1]["causes"] == [f"probe-failed: {NODE} (dma_stream mismatch)"]
        report = json.loads((tmp_path / "r.json").read_text())
        assert report["ok"] is True and report["schema"] == 1
        assert report["written_at"] == pytest.approx(entries[2]["ts"], abs=1e-3)

    def test_a_raising_round_is_logged_and_the_next_runs(self, monkeypatch, tmp_path, capsys):
        rc, calls, _, entries, _ = _drive_loop(
            monkeypatch, tmp_path, [HEALTHY, OSError("shared volume detached"), HEALTHY])
        assert rc == 143 and len(calls) == 3
        assert [e["exit_code"] for e in entries] == [0, 1, 0]
        assert entries[1]["error"] == "shared volume detached"
        assert set(entries[1]) == {"ts", "exit_code", "error"}
        assert "Probe emission failed: shared volume detached" in capsys.readouterr().err

    def test_cadence_subtracts_the_round(self, monkeypatch, tmp_path):
        # --watch 5: a 2 s round waits 3 s, a 4.5 s round 0.5 s, and a round
        # longer than the interval starts the next at once.
        _, _, waits, _, starts = _drive_loop(
            monkeypatch, tmp_path,
            [(HEALTHY, 2.0), (HEALTHY, 4.5), (HEALTHY, 7.0), (HEALTHY, 1.0)])
        assert waits == pytest.approx([3.0, 0.5, 0.0, 4.0])
        assert starts == pytest.approx([0.0, 5.0, 10.0, 17.0])

    def test_flags_reach_the_probe(self, monkeypatch, tmp_path):
        _, calls, _, _, _ = _drive_loop(monkeypatch, tmp_path, [HEALTHY], argv=[
            "--probe-level", "collective", "--probe-topology", "2x2", "--probe-soak", "20",
            "--perf-floor", "0.4", "--probe-timeout", "90", "--device", "cpu"])
        assert calls == [dict(level="collective", timeout_s=90.0, device="cpu",
                              topology="2x2", soak_s=20.0, perf_floor=0.4,
                              distributed=False, coordinator=None, num_processes=None,
                              process_id=None, dist_init_timeout_s=None,
                              workload_model=None)]

    def test_sigterm_stops_after_the_current_emission(self, monkeypatch, tmp_path, capsys):
        # The real wait and the real handler: SIGTERM lands during round 2,
        # which still writes its report and its line; the loop then stops
        # with 143 and puts the previous handler back.
        calls = []

        def fake_probe(**kw):
            calls.append(kw)
            if len(calls) == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return HEALTHY

        monkeypatch.setattr(port_emit, "run_local_probe", fake_probe)
        before = signal.getsignal(signal.SIGTERM)
        report, log = tmp_path / "r.json", tmp_path / "rounds.jsonl"
        rc = port_cli.main(["--emit-probe", str(report), "--watch", "0.01",
                            "--log-jsonl", str(log)])
        assert rc == 143 and len(calls) == 2
        assert len(log.read_text().splitlines()) == 2
        assert signal.getsignal(signal.SIGTERM) is before
        assert "SIGTERM: emitter loop stopped cleanly" in capsys.readouterr().err

    def test_one_shot_appends_its_round(self, monkeypatch, tmp_path):
        monkeypatch.setattr(port_emit, "run_local_probe", lambda **kw: FAILING)
        log = tmp_path / "rounds.jsonl"
        rc = port_cli.main(["--emit-probe", str(tmp_path / "r.json"), "--log-jsonl", str(log)])
        (entry,) = [json.loads(x) for x in log.read_text().splitlines()]
        assert rc == 3 and entry["exit_code"] == 3 and entry["probe_ok"] is False


def _trend(path):
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_node_checker", "--trend", str(path), "--json"],
        capture_output=True, text=True, cwd=REPO, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout)


def test_trend_reads_a_port_log_as_a_jax_log(monkeypatch, tmp_path):
    rounds = [HEALTHY, FAILING, SILENT, HEALTHY]
    _, _, _, port_entries, _ = _drive_loop(monkeypatch, tmp_path, rounds)
    # The JAX emitter's lines for the same reports, stamped with the same
    # times (the one field that differs between two runs).
    stamps = iter([e["ts"] for e in port_entries])
    monkeypatch.setattr(jax_checker, "time", type("T", (), {"time": staticmethod(
        lambda: next(stamps))}))
    jax_log = tmp_path / "jax.jsonl"
    for r in rounds:
        doc = r.to_dict()
        jax_checker._append_jsonl(str(jax_log), jax_checker._emitter_round_entry(
            0 if r.ok else 3, doc))
    assert [json.loads(x) for x in jax_log.read_text().splitlines()] == port_entries
    port_summary = _trend(tmp_path / "rounds.jsonl")
    assert port_summary == _trend(jax_log)
    assert port_summary["rounds"] == 4


class TestReportFresh:
    CASES = {
        "fresh": (lambda now: {"written_at": now - 10}, 0),
        "stale": (lambda now: {"written_at": now - 1000}, 1),
        "future-dated": (lambda now: {"written_at": now + 120}, 1),
        "nan": (lambda now: {"written_at": math.nan}, 1),
        "string": (lambda now: {"written_at": "yesterday"}, 1),
        "list": (lambda now: [1, 2], 1),
        "missing": (None, 1),
    }

    @pytest.mark.parametrize("case", list(CASES))
    def test_exit_code_equals_jax(self, tmp_path, capsys, case):
        make, want = self.CASES[case]
        path = tmp_path / "r.json"
        if make is not None:
            path.write_text(json.dumps(make(time.time())))
        port = port_cli.main(["--report-fresh", str(path)])
        port_err = capsys.readouterr().err
        ref = jax_checker.report_fresh(str(path), 900.0)
        assert port == ref == want
        # The same words; the ages may differ by the second between calls.
        assert re.sub(r"\d+s", "Ns", port_err) == re.sub(r"\d+s", "Ns", capsys.readouterr().err)
        assert str(path) in port_err

    def test_max_age_flag(self, tmp_path):
        path = tmp_path / "r.json"
        path.write_text(json.dumps({"written_at": time.time() - 10}))
        assert port_cli.main(["--report-fresh", str(path), "--probe-results-max-age",
                              "0.001"]) == 1
        assert jax_checker.report_fresh(str(path), 0.001) == 1


def test_probe_report_schema_equals_jax(capsys):
    assert port_cli.main(["--probe-report-schema"]) == 0
    port = capsys.readouterr().out
    ref = subprocess.run(
        [sys.executable, "-m", "tpu_node_checker", "--probe-report-schema"],
        capture_output=True, text=True, cwd=REPO, timeout=120, check=True,
    ).stdout
    assert json.loads(port) == json.loads(ref)
    assert port == ref  # indent=2, as the JAX CLI prints it


def _usage_error(parse, argv, capsys):
    with pytest.raises(SystemExit) as exc:
        parse(argv)
    return exc.value.code, capsys.readouterr().err


class TestUsageErrors:
    @pytest.mark.parametrize("argv,message", [
        (["--probe-report-schema", "--watch", "5"], "--probe-report-schema runs alone"),
        (["--probe-report-schema", "--probe-level", "compute"],
         "--probe-report-schema runs alone"),
        (["--emit-probe", "-", "--watch", "0"],
         "--watch interval must be a positive number of seconds"),
        (["--emit-probe", "-", "--watch", "-3"],
         "--watch interval must be a positive number of seconds"),
        (["--report-fresh", "r.json", "--emit-probe", "-"],
         "--report-fresh runs alone (no --emit-probe/"),
        (["--report-fresh", "r.json", "--watch", "5"], "--report-fresh runs alone (no "),
        (["--emit-probe", "-", "--probe-soak", "5"],
         "--probe-soak requires --probe-level compute (or higher)"),
        (["--emit-probe", "-", "--perf-floor", "0.4"],
         "--perf-floor requires --probe-level compute (or higher)"),
        (["--emit-probe", "-", "--probe-level", "compute", "--perf-floor", "-1"],
         "--perf-floor must be >= 0 (0 disables)"),
    ])
    def test_jax_rule_with_jax_words(self, capsys, argv, message):
        port_code, port_err = _usage_error(port_cli.parse_args, argv, capsys)
        jax_code, jax_err = _usage_error(jax_cli.parse_args, argv, capsys)
        assert port_code == jax_code == 2
        assert f"error: {message}" in port_err
        assert f"error: {message}" in jax_err

    @pytest.mark.parametrize("argv,message", [
        (["--emit-probe", "-", "--retry-budget", "5"],
         "--retry-budget belongs to the one-shot round: it cannot be combined with "
         "--emit-probe"),
        (["--slack-on-change"], "--slack-on-change requires --watch"),
        (["--emit-probe", "-", "--probe-results-max-age", "60"],
         "--probe-results-max-age requires --probe-results or --report-fresh"),
        (["--emit-probe", "-", "--probe-level", "compute", "--probe-topology", "2x2"],
         "--probe-topology requires --probe-level collective (or higher)"),
        (["--emit-probe", "-", "--probe-level", "compute", "--probe-soak", "-1"],
         "--probe-soak must be >= 0 (0 disables)"),
        (["--report-fresh", "r.json", "--log-jsonl", "l"], "--report-fresh runs alone"),
        (["--report-fresh", "r.json", "--device", "cpu"], "--report-fresh runs alone"),
    ])
    def test_port_rule(self, capsys, argv, message):
        code, err = _usage_error(port_cli.parse_args, argv, capsys)
        assert code == 2 and f"error: {message}" in err

    @pytest.mark.parametrize("flag", [
        ["--watch-stream"], ["--federate", "e"], ["--no-watch-stream"],
    ])
    def test_unported_flag_is_unknown(self, capsys, flag):
        # Once unknown arguments; now ported, each is refused beside the
        # emitter with JAX's words, or (--no-watch-stream, the default)
        # parsed to JAX's values.
        argv = ["--emit-probe", "-", "--probe-level", "compute", *flag]
        got = outcome_vs_jax(argv, capsys)
        if flag == ["--no-watch-stream"]:
            assert got.watch_stream is False
        else:
            assert flag[0] in got

    @pytest.mark.parametrize("flag,message", [
        (["--cordon-failed"], "--cordon-failed requires --probe or --probe-results DIR"),
        (["--trend", "t.jsonl"], "--trend runs alone (only --json may accompany it)"),
        (["--serve", "0"], "--serve cannot be combined with --emit-probe"),
        (["--analytics", "d"], "--analytics requires --history FILE"),
        (["--history", "h", "--analytics", "d"], "--analytics cannot be combined with --emit-probe"),
    ])
    def test_ported_flag_beside_the_emitter_as_jax(self, capsys, flag, message):
        # Once an unknown argument; ported, refused beside --emit-probe with
        # JAX's words.
        argv = ["--emit-probe", "-", "--probe-level", "compute", *flag]
        assert outcome_vs_jax(argv, capsys) == message

    @pytest.mark.parametrize("argv,message", [
        (["--emit-probe", "-", "--trace", "t.json"], None),
        (["--emit-probe", "-", "--trace", "t.json", "--debug"],
         "--debug belongs to the one-shot round: it cannot be combined with --emit-probe"),
    ])
    def test_trace_beside_the_emitter(self, capsys, argv, message):
        # The emitter writes its round's trace; the round's other flags are
        # refused beside it as before.
        if message is None:
            assert port_cli.parse_args(argv).trace == "t.json"
        else:
            code, err = _usage_error(port_cli.parse_args, argv, capsys)
            assert code == 2 and f"error: {message}" in err

    @pytest.mark.parametrize("flags", [
        ["--probe-distributed"],
        ["--probe-distributed", "--probe-coordinator", "10.0.0.1:8476",
         "--probe-num-processes", "2", "--probe-process-id", "1",
         "--probe-rendezvous-timeout", "30"],
    ])
    def test_ported_flag_parses_with_emit_probe(self, flags):
        # Once an unknown argument; ported, with JAX's types and defaults.
        args = port_cli.parse_args(["--emit-probe", "-", "--probe-level", "compute", *flags])
        ref = jax_cli.parse_args(["--emit-probe", "-", "--probe-level", "compute", *flags])
        for dest in ("probe_distributed", "probe_coordinator", "probe_num_processes",
                     "probe_process_id", "probe_rendezvous_timeout"):
            assert getattr(args, dest) == getattr(ref, dest), dest
        assert args.probe_distributed is True


@pytest.fixture
def _wall_clock_guard():
    t0 = time.perf_counter()
    yield
    elapsed = time.perf_counter() - t0
    assert elapsed < 120.0, f"test burned {elapsed:.1f}s of wall-clock"


@pytest.mark.usefixtures("_wall_clock_guard")
def test_sigterm_to_a_real_emitter(tmp_path):
    report = tmp_path / "r.json"
    env = {k: v for k, v in os.environ.items() if not k.startswith("TNC_")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_node_checker_torch", "--emit-probe", str(report),
         "--watch", "60", "--device", "cpu"],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True, cwd=REPO, env=env,
    )
    watchdog = threading.Timer(60.0, proc.kill)  # a run that never reports ends here
    watchdog.start()
    try:
        for line in proc.stderr:
            if "Probe report written" in line:
                break
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        rest = proc.stderr.read()
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()
    assert rc == 143, rest
    assert "SIGTERM: emitter loop stopped cleanly" in rest
    assert port_emit.report_fresh(str(report), 900.0) == 0
    assert time.time() - json.loads(report.read_text())["written_at"] < 60


def test_soak_on_the_cpu():
    env = {k: v for k, v in os.environ.items() if not k.startswith("TNC_")}
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_node_checker_torch", "--emit-probe", "-",
         "--probe-level", "compute", "--probe-soak", "1", "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env={**env, "OMP_NUM_THREADS": "2", "TNC_SCHEMA_STRICT": "1"},
    )
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["ok"] is True
    assert doc["soak"]["ok"] is True and doc["soak"]["tflops_median"] > 0
    assert doc["elapsed_ms"] > 1000


def test_soak_rounds_are_spans_of_the_round():
    # In process, on the CPU: each soak round is one soak.round span holding
    # one soak.burn and one soak.stream, and counts one soak_rounds.
    burn = importlib.import_module("tpu_node_checker_torch.ops.burn")
    spans = importlib.import_module("tpu_node_checker_torch.probe.spans")
    round_ = spans.Round()
    with spans.active(round_):
        soak = burn.soak_burn(0.2, n=64, iters=2, device="cpu", min_sustained_ratio=0.0,
                              hbm_mib=1)
    assert soak.ok and soak.rounds >= 1
    ms = spans.summary(round_.tracer.spans)
    assert {name: ms[name][0] for name in ("soak.round", "soak.burn", "soak.stream")} == \
        dict.fromkeys(("soak.round", "soak.burn", "soak.stream"), soak.rounds)
    assert ms["hbm.alloc"][0] == soak.rounds
    assert round_.counters == {"soak_rounds": soak.rounds}
    assert ms["soak.burn"][1] + ms["soak.stream"][1] <= ms["soak.round"][1]


# The probe child with two gloo ranks on the CPU (a two-card host) and the
# pipeline's stage 1 faulted on every rank: the real child script, run with
# the rank count and the fault hook set from outside it.
_TWO_RANKS_FAULTED_PIPELINE = r'''
import functools
import tpu_node_checker_torch.parallel as par
from tpu_node_checker_torch.probe.liveness import _CHILD_SCRIPT


class _TwoRanks(par.RankGroup):
    def __init__(self, world_size, device_type, **kw):
        super().__init__(2, device_type, **kw)


par.RankGroup = _TwoRanks
par.pipeline_probe = functools.partial(par.pipeline_probe, inject_fault_stage=1)
exec(compile(_CHILD_SCRIPT, "<probe child>", "exec"), {"__name__": "__main__"})
'''


def test_workload_sub_probe_error_named_and_carried_into_causes(monkeypatch, tmp_path):
    # The port's child names the failing sub-probe in `error`; the JAX child
    # only clears `ok` (tpu_node_checker/probe/liveness.py, workload block).
    # Decided: keep the name, which triage needs; the round log's `causes`
    # then carry it, where the JAX emitter's read "probe-failed: HOST".
    _clean_env(monkeypatch)
    monkeypatch.setenv("NODE_NAME", NODE)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("TNC_SCHEMA_STRICT", "1")
    monkeypatch.setattr(port_liveness, "_CHILD_SCRIPT", _TWO_RANKS_FAULTED_PIPELINE)
    rc, doc = port_emit.emit_probe_once(str(tmp_path / f"{NODE}.json"), level="workload",
                                        timeout_s=300, device="cpu")
    assert rc == 3 and doc["ok"] is False
    assert doc["workload_devices"] == 2 and doc["workload_ok"] is True
    assert doc["pipeline_ok"] is False and doc["moe_ok"] is True
    error = doc["error"]
    assert error.startswith("pipeline mismatch: max|Δ|=")
    assert error.endswith("; corruption entered at stage 1")
    entry = port_emit.emitter_round_entry(rc, doc)
    assert entry["causes"] == [f"probe-failed: {NODE} ({error})"]
    # The JAX child's report of the same fault has no error: its causes.
    jax_doc = {k: v for k, v in doc.items() if k != "error"}
    assert jax_checker._emitter_round_entry(rc, jax_doc)["causes"] == [f"probe-failed: {NODE}"]
