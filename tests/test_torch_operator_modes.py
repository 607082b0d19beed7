"""The emitter pod's operator modes on the port, held against the JAX checker.

``deploy/daemonset-emitter.yaml`` runs ``--selftest --probe-timeout 600`` as
its initContainer and ``--emit-probe … --watch 300 --metrics-port 9090`` as
its emitter; ``--calibrate N`` produces the ``TNC_PERF_EXPECT`` that lets
``--perf-floor`` grade a card the built-in table lacks.  The port copies
each mode (``selftest.py``, ``calibrate.py``, the loop in ``emit.py``), and
each is held here against the JAX original on the same probe outcomes: a
stand-in ``run_local_probe`` answers both, so the whole outputs (``--json``
documents, human text, stderr, exit codes), the per-leg environments and
timeouts, and every scrape of the loop must be equal.

torch and the port are reached through ``importlib.import_module``:
tests/test_dependency_surface.py rejects any other ``import`` in tests/.
"""

import http.client
import importlib
import json
import os
import re
import subprocess
import sys
from http.server import BaseHTTPRequestHandler
from pathlib import Path

import pytest

from tpu_node_checker import checker as jax_checker
from tpu_node_checker import cli as jax_cli
from tpu_node_checker import metrics as jax_metrics

jax_probe = importlib.import_module("tpu_node_checker.probe")
port_cli = importlib.import_module("tpu_node_checker_torch.cli")
port_emit = importlib.import_module("tpu_node_checker_torch.emit")
port_metrics = importlib.import_module("tpu_node_checker_torch.metrics")
port_selftest = importlib.import_module("tpu_node_checker_torch.selftest")
port_calibrate = importlib.import_module("tpu_node_checker_torch.calibrate")
ProbeResult = importlib.import_module("tpu_node_checker_torch.probe.liveness").ProbeResult

REPO = Path(__file__).resolve().parent.parent
NODE = "gke-h100-node-0"


def _tnc_env():
    return {k: v for k, v in os.environ.items() if k.startswith("TNC_")}


class FakeHost:
    """Stands in for ``run_local_probe``: answers each call as a host with
    ``n`` cards answers it under the ``TNC_CHAOS_*`` set at call time, and
    records each call's arguments (the port's ``device`` apart) and its
    ``TNC_*`` environment."""

    def __init__(self, n=1, baseline_ok=True, tflops=300.0, ring_named="0->1",
                 floor=None):
        self.n, self.baseline_ok, self.tflops = n, baseline_ok, tflops
        self.ring_named = ring_named
        self.floor = {"failed": ["matmul_tflops"], "ok": False} if floor is None else floor
        self.calls, self.envs, self.devices = [], [], []

    def __call__(self, **kw):
        self.devices.append(kw.get("device"))
        # JAX passes topology=None to every leg; the port leaves the default.
        self.calls.append({k: kw.get(k) for k in ("level", "timeout_s", "topology")})
        env = _tnc_env()
        self.envs.append(env)
        base = dict(level=kw["level"], hostname=NODE, elapsed_ms=7400.0,
                    device_count=self.n, platform="gpu")
        if "TNC_CHAOS_THROTTLE" in env:
            return ProbeResult(ok=False, error="perf_floor: matmul_tflops 15.0 < floor", details={
                "perf_floor": self.floor,
                "chaos_injected": {"throttle": env["TNC_CHAOS_THROTTLE"]}}, **base)
        if "TNC_CHAOS_COLLECTIVE_LEG" in env:
            return ProbeResult(ok=False, details={
                "collective_legs_ok": {"psum_ok": True, "all_gather_ok": False,
                                       "reduce_scatter_ok": True, "psum_us": 12.5},
                "collective_err": "all_gather mismatch"}, **base)
        if "TNC_CHAOS_RING_LINK" in env:
            return ProbeResult(ok=False, details={"ring_bad_links": [self.ring_named]}, **base)
        if "TNC_CHAOS_SLICES" in env:
            return ProbeResult(ok=False, details={
                "fault_domain_ok": {"dcn": False, "t0": True}}, **base)
        return ProbeResult(
            ok=self.baseline_ok, error=None if self.baseline_ok else "CUDA init failed",
            details={"matmul_tflops": self.tflops, "int8_tops": 41.5, "hbm_gbps": 2400.0},
            **base)


def _run_both(monkeypatch, capsys, port_argv, jax_argv, jax_host, port_host):
    """(port's (rc, out, err), JAX's) for the same argv, each CLI over its host."""
    monkeypatch.setattr(port_selftest, "run_local_probe", port_host)
    monkeypatch.setattr(port_calibrate, "run_local_probe", port_host)
    monkeypatch.setattr(jax_probe, "run_local_probe", jax_host)
    before = dict(os.environ)
    port = (port_cli.main(port_argv), *capsys.readouterr())
    assert dict(os.environ) == before
    jax = (jax_cli.main(jax_argv), *capsys.readouterr())
    assert dict(os.environ) == before
    return port, jax


SELFTEST_CASES = {
    "healthy, 8 devices": (dict(n=8), 0),
    "healthy, 1 device": (dict(n=1), 0),
    "healthy, 4 devices": (dict(n=4), 0),
    "healthy, 3 devices": (dict(n=3), 0),
    "detector misnames the link": (dict(n=8, ring_named="1->2"), 3),
    "sick baseline": (dict(n=8, baseline_ok=False), 3),
    "no baseline figure": (dict(n=1, tflops=None), 0),
    "check crashes": (dict(n=1, floor="skipped"), 3),
}


class TestSelftest:
    @pytest.mark.parametrize("json_flag", [["--json"], []], ids=["json", "human"])
    @pytest.mark.parametrize("case", list(SELFTEST_CASES))
    def test_equals_jax(self, monkeypatch, capsys, case, json_flag):
        kw, want = SELFTEST_CASES[case]
        # Knobs a manual rehearsal may have left behind: each leg clears them,
        # except TNC_SKIP_*, and puts them back after.
        monkeypatch.setenv("TNC_CHAOS_RING_LINK", "3")
        monkeypatch.setenv("TNC_TOPOLOGY", "2x2")
        monkeypatch.setenv("TNC_SKIP_INT8", "1")
        port_host, jax_host = FakeHost(**kw), FakeHost(**kw)
        port, jax = _run_both(
            monkeypatch, capsys,
            ["--selftest", *json_flag, "--probe-timeout", "600", "--device", "cpu"],
            ["--selftest", *json_flag, "--probe-timeout", "600"], jax_host, port_host)
        assert port == jax
        assert port[0] == want
        assert port_host.calls == jax_host.calls
        assert port_host.envs == jax_host.envs
        assert set(port_host.devices) == {"cpu"}
        assert all(c["timeout_s"] == 600.0 for c in port_host.calls)
        assert all(e.get("TNC_SKIP_INT8") == "1" and "TNC_TOPOLOGY" not in e
                   for e in port_host.envs)
        if json_flag:
            doc = json.loads(port[1])
            assert doc["exit_code"] == want and doc["all_behaved"] == (want == 0)

    def test_single_card_legs_and_skips(self, monkeypatch, capsys):
        host = FakeHost(n=1, tflops=428.442)
        monkeypatch.setattr(port_selftest, "run_local_probe", host)
        assert port_selftest.selftest(device="cuda:0", json_mode=True) == 0
        doc = json.loads(capsys.readouterr().out)
        assert [x["leg"] for x in doc["selftest"]] == ["baseline", "throttle"]
        assert doc["skipped_legs"] == ["collective_leg, ring_link (single device)",
                                       "dcn (needs >=4 devices, even count)"]
        # The throttle leg expects this host's own baseline figure, and only it.
        assert host.envs[1] == {"TNC_CHAOS_THROTTLE": "matmul_tflops",
                                "TNC_PERF_EXPECT": json.dumps({"matmul_tflops": 385.598})}
        assert host.devices == ["cuda:0", "cuda:0"]
        assert host.calls == [dict(level="compute", timeout_s=None, topology=None)] * 2

    def test_four_cards_run_every_leg(self, monkeypatch, capsys):
        host = FakeHost(n=4)
        monkeypatch.setattr(port_selftest, "run_local_probe", host)
        assert port_selftest.selftest(json_mode=True) == 0
        doc = json.loads(capsys.readouterr().out)
        assert [x["leg"] for x in doc["selftest"]] == [
            "baseline", "throttle", "collective_leg", "ring_link", "dcn"]
        assert doc["skipped_legs"] == []
        assert host.envs[2:] == [{"TNC_CHAOS_COLLECTIVE_LEG": "all_gather"},
                                 {"TNC_CHAOS_RING_LINK": "0"},
                                 {"TNC_CHAOS_SLICES": "2", "TNC_CHAOS_AXIS": "dcn"}]
        assert [c["level"] for c in host.calls] == [
            "compute", "compute", "collective", "collective", "collective"]


def _reps(*figures, fail_at=None, soak=None):
    """A run_local_probe stand-in answering one rep per call with
    (matmul, int8, hbm) figures; rep ``fail_at`` (1-based) fails."""
    calls, pending = [], list(enumerate(figures, 1))

    def fake(**kw):
        kw.pop("device", None)
        calls.append(kw)
        i, (mm, i8, hbm) = pending.pop(0)
        details = {k: v for k, v in (("matmul_tflops", mm), ("int8_tops", i8),
                                     ("hbm_gbps", hbm)) if v is not None}
        if soak is not None:
            details["soak"] = {"ok": True, "tflops_median": soak[i - 1]}
        return ProbeResult(ok=i != fail_at, level=kw["level"], hostname=NODE,
                           elapsed_ms=7400.0, device_count=1, platform="gpu",
                           error="dma_stream mismatch" if i == fail_at else None,
                           details=details)
    fake.calls = calls
    return fake


THREE = [(300.0, 40.0, 2400.0), (320.5, 42.25, 2500.0), (310.0, 41.0, 2450.5)]

CALIBRATE_CASES = {
    "three reps": (THREE, {}, [], 0),
    "margin 0.5": (THREE, {}, ["--calibrate-margin", "0.5"], 0),
    "a failed rep": (THREE, {"fail_at": 2}, [], 3),
    "no metrics": ([(None, None, None)] * 3, {}, [], 3),
    "one metric": ([(None, None, 2400.0)] * 3, {}, [], 0),
    "soak and timeout pass through": (
        THREE, {"soak": [420.0, 425.5, 419.0]}, ["--probe-soak", "20", "--probe-timeout", "90"], 0),
}


class TestCalibrate:
    @pytest.mark.parametrize("case", list(CALIBRATE_CASES))
    def test_equals_jax(self, monkeypatch, capsys, case):
        figures, kw, extra, want = CALIBRATE_CASES[case]
        port_host, jax_host = _reps(*figures, **kw), _reps(*figures, **kw)
        argv = ["--calibrate", "3", "--probe-level", "compute", *extra]
        port, jax = _run_both(monkeypatch, capsys, [*argv, "--device", "cpu"], argv,
                              jax_host, port_host)
        assert port == jax
        assert port[0] == want
        assert port_host.calls == jax_host.calls
        # Each rep runs ungraded: floors are what it calibrates for.
        assert all(c["perf_floor"] == 0 for c in port_host.calls)
        if want == 0:
            expect = json.loads(port[1])
            assert port[2].count("rep ") == 3 and "Calibrated" in port[2]
            if case == "soak and timeout pass through":
                assert expect["sustained_tflops"] == round(0.9 * 420.0, 3)
                assert all(c["soak_s"] == 20.0 and c["timeout_s"] == 90.0
                           for c in port_host.calls)
        else:
            assert port[1] == ""

    def test_out_file_equals_jax(self, monkeypatch, capsys, tmp_path):
        port_out, jax_out = tmp_path / "port.json", tmp_path / "jax.json"
        argv = ["--calibrate", "3", "--probe-level", "collective", "--probe-topology", "2x2"]
        port, jax = _run_both(
            monkeypatch, capsys, [*argv, "--calibrate-out", str(port_out), "--device", "cpu"],
            [*argv, "--calibrate-out", str(jax_out)], _reps(*THREE), _reps(*THREE))
        assert port == jax == (0, "", port[2])
        assert port_out.read_text() == jax_out.read_text()
        assert json.loads(port_out.read_text()) == {
            "matmul_tflops": 279.0, "int8_tops": 36.9, "hbm_gbps": 2205.45}
        assert not (tmp_path / "port.json.tmp").exists()

    def test_device_reaches_each_rep(self, monkeypatch, capsys):
        devices = []

        def fake(**kw):
            devices.append(kw["device"])
            return ProbeResult(ok=True, level="compute", hostname=NODE, elapsed_ms=1.0,
                               details={"matmul_tflops": 1.0})

        monkeypatch.setattr(port_calibrate, "run_local_probe", fake)
        assert port_cli.main(["--calibrate", "2", "--probe-level", "compute"]) == 0
        assert devices == ["cuda:0", "cuda:0"]
        assert json.loads(capsys.readouterr().out) == {"matmul_tflops": 0.9}


class FakeClock:
    """Stands in for the ``time`` module of each loop and its scrape."""

    def __init__(self):
        self.mono = 0.0

    def monotonic(self):
        return self.mono

    def time(self):
        return 1_760_000_000.0 + self.mono

    def advance(self, seconds):
        self.mono += seconds


def _exchange(port, method="GET", path="/metrics", headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request(method, path, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.getheaders(), resp.read()
    finally:
        conn.close()


def _scrapes(port):
    """Every exchange a scraper makes, after one round."""
    first = _exchange(port)
    etag = dict(first[1])["ETag"]
    return {
        "GET": first,
        "HEAD": _exchange(port, "HEAD"),
        "304": _exchange(port, headers={"If-None-Match": etag}),
        "gzip": _exchange(port, headers={"Accept-Encoding": "gzip"}),
        "404": _exchange(port, path="/nope"),
    }


ROUNDS = [
    ProbeResult(ok=True, level="compute", hostname=NODE, elapsed_ms=7400.0, device_count=1,
                platform="gpu", details={"matmul_tflops": 428.4, "int8_tops": 150.25,
                                         "hbm_gbps": 2950.5}),
    ProbeResult(ok=False, level="compute", hostname=NODE, elapsed_ms=9100.0, device_count=1,
                platform="gpu", error="perf_floor: int8_tops 7.5 < floor",
                details={"perf_floor": {"generation": "custom", "ok": False,
                                        "failed": ["int8_tops"],
                                        "ratios": {"int8_tops": 0.05, "matmul_tflops": 1.01}}}),
    OSError("shared volume detached"),
    ProbeResult(ok=True, level="compute", hostname=NODE, elapsed_ms=7000.0, device_count=1,
                platform="gpu", details={"matmul_tflops": 430.0}),
]


def _drive_loop(monkeypatch, capsys, tmp_path, cli, module, probe_owner, metrics_mod):
    """One loop through ``cli`` over ROUNDS, scraped before the first round
    and after each; returns (exit code, scrapes, log lines, the port its
    stderr line named)."""
    clock = FakeClock()
    pending, scrapes, port = list(ROUNDS), [], []

    def fake_probe(**kw):
        if not port:
            line = re.search(r"Serving emitter metrics on port (\d+) \(/metrics\)\.",
                             capsys.readouterr().err)
            port.append(int(line.group(1)))
            scrapes.append({"GET": _exchange(port[0])})
        clock.advance(1.0)
        item = pending.pop(0)
        if isinstance(item, Exception):
            raise item
        return item

    def fake_wait(stop, seconds):
        scrapes.append(_scrapes(port[0]))
        clock.advance(seconds)
        return not pending

    monkeypatch.setattr(module, "time", clock)
    monkeypatch.setattr(metrics_mod, "time", clock)
    monkeypatch.setattr(probe_owner, "run_local_probe", fake_probe)
    monkeypatch.setattr(module, "_wait_for_next_round", fake_wait)
    log = tmp_path / f"{module.__name__}.jsonl"
    rc = cli.main(["--emit-probe", str(tmp_path / "r.json"), "--probe-level", "compute",
                   "--watch", "5", "--metrics-port", "0", "--log-jsonl", str(log)])
    capsys.readouterr()
    return rc, scrapes, [json.loads(x) for x in log.read_text().splitlines()], port[0]


def test_emitter_loop_scrapes_equal_jax(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(BaseHTTPRequestHandler, "date_time_string",
                        lambda self, timestamp=None: "Sat, 17 Oct 2026 08:00:00 GMT")
    servers = []

    class Recorded(jax_metrics.MetricsServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            servers.append(self)

    monkeypatch.setattr(jax_metrics, "MetricsServer", Recorded)
    try:
        port = _drive_loop(monkeypatch, capsys, tmp_path, port_cli, port_emit, port_emit,
                           port_metrics)
        jax = _drive_loop(monkeypatch, capsys, tmp_path, jax_cli, jax_checker, jax_probe,
                          jax_metrics)
    finally:
        for s in servers:  # the JAX loop leaves its server up; the port's closes it
            s.close()
    assert port[0] == jax[0] == 143
    assert port[2] == jax[2]
    assert [e["exit_code"] for e in port[2]] == [0, 3, 1, 0]
    assert port[1] == jax[1]
    before, healthy, failing, raised, last = port[1]
    assert before["GET"][2] == b"# tpu-node-checker: no check completed yet\n"
    body = healthy["GET"][2].decode()
    assert "tpu_node_checker_probe_ok{level=\"compute\"} 1.0\n" in body
    assert "tpu_node_checker_probe_int8_tops 150.25\n" in body
    assert "tpu_node_checker_check_duration_ms 7400.0\n" in body
    assert "tpu_node_checker_last_run_timestamp_seconds 1760000001.0\n" in body
    assert healthy["304"][0] == 304 and healthy["304"][2] == b""
    assert healthy["HEAD"][2] == b"" and healthy["404"][0] == 404
    assert "tpu_node_checker_exit_code 3\n" in failing["GET"][2].decode()
    assert 'tpu_node_checker_probe_perf_floor_ratio{metric="int8_tops"} 0.05' in \
        failing["GET"][2].decode()
    # A raising round flips the exit code and lets the timestamp go stale.
    raised_body = raised["GET"][2].decode()
    assert "tpu_node_checker_exit_code 1\n" in raised_body
    assert "\ntpu_node_checker_last_run_timestamp_seconds " not in raised_body
    assert "tpu_node_checker_probe_ok{level=\"compute\"} 0.0\n" in raised_body
    assert "tpu_node_checker_exit_code 0\n" in last["GET"][2].decode()
    # The port's server is closed when its loop returns.
    with pytest.raises(OSError):
        _exchange(port[3])


USAGE_EQUAL_JAX = [
    (["--emit-probe", "-", "--metrics-port", "9090"],
     "--metrics-port requires --watch (one-shot runs serve no scrapes)"),
    (["--metrics-port", "0"], "--metrics-port requires --watch (one-shot runs serve no scrapes)"),
    (["--selftest", "--metrics-port", "9090"],
     "--metrics-port requires --watch (one-shot runs serve no scrapes)"),
    (["--selftest", "--emit-probe", "-"], "--selftest runs alone (only --json and "
     "--probe-timeout may accompany it)"),
    (["--selftest", "--watch", "5"], "--selftest runs alone"),
    (["--selftest", "--probe-level", "compute"], "--selftest runs alone"),
    (["--selftest", "--probe-topology", "2x2"], "--selftest runs alone"),
    (["--selftest", "--log-jsonl", "l"], "--selftest runs alone"),
    (["--selftest", "--calibrate", "2"], "--selftest runs alone"),
    (["--selftest", "--report-fresh", "r.json"], "--selftest runs alone"),
    (["--calibrate", "2", "--probe-level", "compute", "--emit-probe", "-"],
     "--calibrate runs alone (only --probe-level/--probe-timeout/--probe-soak/"
     "--probe-topology and --calibrate-margin/--calibrate-out may accompany it)"),
    (["--calibrate", "2", "--probe-level", "compute", "--json"], "--calibrate runs alone"),
    (["--calibrate", "2", "--probe-level", "compute", "--perf-floor", "0.4"],
     "--calibrate runs alone"),
    (["--calibrate", "2", "--probe-level", "compute", "--log-jsonl", "l"],
     "--calibrate runs alone"),
    (["--calibrate", "2", "--probe-level", "compute", "--watch", "5"], "--calibrate runs alone"),
    (["--calibrate", "0", "--probe-level", "compute"], "--calibrate needs at least 1 rep"),
    (["--calibrate", "2"], "--calibrate requires --probe-level compute (or higher)"),
    (["--calibrate", "2", "--probe-level", "compute", "--calibrate-margin", "0"],
     "--calibrate-margin must be in (0, 1]"),
    (["--calibrate", "2", "--probe-level", "compute", "--calibrate-margin", "1.5"],
     "--calibrate-margin must be in (0, 1]"),
    (["--emit-probe", "-", "--calibrate-out", "x"], "--calibrate-out requires --calibrate"),
    (["--emit-probe", "-", "--calibrate-margin", "0.5"],
     "--calibrate-margin requires --calibrate"),
]


def _usage_error(parse, argv, capsys):
    with pytest.raises(SystemExit) as exc:
        parse(argv)
    return exc.value.code, capsys.readouterr().err.strip().splitlines()[-1]


class TestUsageErrors:
    @pytest.mark.parametrize("argv,message", USAGE_EQUAL_JAX)
    def test_jax_rule_with_jax_words(self, capsys, argv, message):
        port_code, port_err = _usage_error(port_cli.parse_args, argv, capsys)
        jax_code, jax_err = _usage_error(jax_cli.parse_args, argv, capsys)
        assert port_code == jax_code == 2
        assert port_err.split(": error: ")[1] == jax_err.split(": error: ")[1]
        assert port_err.split(": error: ")[1].startswith(message)

    @pytest.mark.parametrize("argv,unported", [
        (["--selftest", "--probe-soak", "5"], "--probe, "),
        (["--selftest", "--perf-floor", "0.4"], "--probe or "),
    ])
    def test_mode_guard_names_the_ported_modes(self, capsys, argv, unported):
        # JAX's words, its one-shot --probe included now that the port has it.
        _, port_err = _usage_error(port_cli.parse_args, argv, capsys)
        _, jax_err = _usage_error(jax_cli.parse_args, argv, capsys)
        assert port_err.split(": error: ")[1] == jax_err.split(": error: ")[1]
        assert unported in port_err

    @pytest.mark.parametrize("argv,message", [
        (["--emit-probe", "-", "--json"],
         "--json requires --selftest or a one-shot round (not --emit-probe)"),
        (["--report-fresh", "r.json", "--json"], "--report-fresh runs alone"),
        (["--selftest", "--probe-results-max-age", "60"],
         "--probe-results-max-age requires --probe-results or --report-fresh"),
        (["--calibrate", "2", "--probe-level", "compute", "--probe-topology", "2x2"],
         "--probe-topology requires --probe-level collective (or higher)"),
        (["--report-fresh", "r.json", "--metrics-port", "0", "--watch", "5"],
         "--report-fresh runs alone"),
    ])
    def test_port_rule(self, capsys, argv, message):
        code, err = _usage_error(port_cli.parse_args, argv, capsys)
        assert code == 2 and f"error: {message}" in err

    @pytest.mark.parametrize("argv", [
        ["--selftest"], ["--selftest", "--json", "--probe-timeout", "600"],
        ["--selftest", "--device", "cpu"],
        ["--calibrate", "3", "--probe-level", "compute"],
        ["--calibrate", "1", "--probe-level", "collective", "--probe-topology", "2x2",
         "--probe-soak", "5", "--probe-timeout", "90", "--calibrate-out", "x",
         "--calibrate-margin", "1", "--device", "cpu"],
        ["--emit-probe", "f", "--watch", "300", "--metrics-port", "9090"],
    ])
    def test_accepted_as_jax_accepts_it(self, argv):
        port_cli.parse_args(argv)
        jax_cli.parse_args([a for a in argv if a not in ("--device", "cpu")])

    def test_calibrate_margin_defaults_as_jax(self):
        argv = ["--calibrate", "3", "--probe-level", "compute"]
        assert port_cli.parse_args(argv).calibrate_margin == \
            jax_cli.parse_args(argv).calibrate_margin == 0.9


@pytest.mark.slow
def test_operator_modes_for_real_on_the_cpu(tmp_path):
    """The three modes end to end with real probe children on the CPU: the
    drill behaves, one rep calibrates, and its JSON makes --perf-floor grade."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("TNC_")}
    env.update(OMP_NUM_THREADS="2", TNC_SCHEMA_STRICT="1")

    def run(*argv, extra=None):
        return subprocess.run([sys.executable, "-m", "tpu_node_checker_torch", *argv],
                              capture_output=True, text=True, cwd=REPO, timeout=600,
                              env={**env, **(extra or {})})

    drill = run("--selftest", "--json", "--device", "cpu")
    assert drill.returncode == 0, drill.stderr
    doc = json.loads(drill.stdout)
    assert [(x["leg"], x["behaved"]) for x in doc["selftest"]] == [
        ("baseline", True), ("throttle", True)]
    cal = run("--calibrate", "1", "--probe-level", "compute", "--device", "cpu")
    assert cal.returncode == 0, cal.stderr
    expect = json.loads(cal.stdout)
    assert set(expect) == {"matmul_tflops", "int8_tops", "hbm_gbps"}
    assert "rep 1/1: " in cal.stderr
    # A CPU shared with other test processes times its figures loosely; the
    # floor here is set so that only a grading that does not run would fail.
    graded = run("--emit-probe", "-", "--probe-level", "compute", "--perf-floor", "0.05",
                 "--device", "cpu", extra={"TNC_PERF_EXPECT": cal.stdout.strip()})
    assert graded.returncode == 0, graded.stderr
    floor = json.loads(graded.stdout)["perf_floor"]
    assert floor["generation"] == "custom" and floor["ok"] is True
    assert set(floor["ratios"]) == set(expect)
