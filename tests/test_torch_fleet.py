"""The port's one-shot fleet round, held against the JAX checker's.

The same NodeList and the same flags go through the JAX CLI's ``main`` and
the port's; the exit codes must be equal, the text stdout equal, and the
``--json`` payloads equal once ``trace_id`` and ``timings_ms`` (a random id
and wall times) are dropped.  Nothing else is dropped: the tolerance is
exact equality.

Covered: every ``tests/fixtures.py`` NodeList; ``--strict-slices``,
``--expected-chips`` with and without a key, ``--resource-key``,
``--multislice-label`` and ``--cluster-name``; ``--probe-results`` over
reports the port's emitter wrote on the CPU (healthy, failing, stale,
future-dated, unreadable, schema-broken), with and without
``--probe-results-required``; ``--log-jsonl`` (and JAX's ``--trend`` reading
the port's log); a missing NodeList; the arguments ``--probe`` passes to the
probe (stubbed on both sides: the two frameworks' probe dicts are not
compared); the port's ``--probe`` end to end on the CPU; and the usage
errors.

torch and the port are reached through ``importlib.import_module``:
tests/test_dependency_surface.py rejects any other ``import`` in tests/.
"""

import importlib
import json
import os
import time

import pytest

from tests import fixtures as fx
from tests.test_torch_cluster import outcome_vs_jax
from tpu_node_checker import checker as jax_checker
from tpu_node_checker import cli as jax_cli
from tpu_node_checker import probe as jax_probe

port_cli = importlib.import_module("tpu_node_checker_torch.cli")
port_checker = importlib.import_module("tpu_node_checker_torch.checker")
port_emit = importlib.import_module("tpu_node_checker_torch.emit")
port_liveness = importlib.import_module("tpu_node_checker_torch.probe.liveness")

VOLATILE = ("trace_id", "timings_ms")

NODE_LISTS = {
    "cpu_only_cluster": fx.cpu_only_cluster,
    "gpu_pool": fx.gpu_pool,
    "gpu_pool not ready": lambda: fx.gpu_pool(2, ready=False),
    "tpu_v5e_single_host": fx.tpu_v5e_single_host,
    "tpu_v5p_64_slice not_ready=1": lambda: fx.tpu_v5p_64_slice(not_ready=1),
    "tpu_v5e_256_slice": fx.tpu_v5e_256_slice,
    "tpu_multislice": fx.tpu_multislice,
    "big_mixed_cluster": lambda: fx.big_mixed_cluster(cpu=300, gpu=100, tpu_slices=2),
    "mixed_cluster_one_notready": fx.mixed_cluster_one_notready,
}


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """No TNC_*/Slack settings from outside, and fresh history trackers."""
    for k in [k for k in os.environ if k.startswith("TNC_") or k == "SLACK_WEBHOOK_URL"]:
        monkeypatch.delenv(k)
    monkeypatch.setitem(jax_checker._HISTORY_CACHE, "key", None)
    monkeypatch.setitem(port_checker._HISTORY_CACHE, "key", None)


def _nodes(tmp_path, items, name="nodes.json"):
    path = tmp_path / name
    path.write_text(json.dumps(fx.node_list(items)))
    return str(path)


def _run(main, argv, capsys):
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


def _both(argv, capsys):
    """((rc, stdout, stderr) of JAX, of the port) for the same argv."""
    return _run(jax_cli.main, argv, capsys), _run(port_cli.main, argv, capsys)


def _payload(out):
    doc = json.loads(out)
    for k in VOLATILE:
        doc.pop(k, None)
    return doc


def _assert_equal(jax, port, json_mode):
    assert port[0] == jax[0]
    if json_mode:
        assert _payload(port[1]) == _payload(jax[1])
    else:
        assert port[1] == jax[1]


class TestNodeLists:
    @pytest.mark.parametrize("json_mode", [False, True], ids=["text", "json"])
    @pytest.mark.parametrize("name", list(NODE_LISTS))
    def test_round_equals_jax(self, tmp_path, capsys, name, json_mode):
        argv = ["--nodes-json", _nodes(tmp_path, NODE_LISTS[name]())]
        argv += ["--json"] if json_mode else []
        jax, port = _both(argv, capsys)
        _assert_equal(jax, port, json_mode)
        want = {"cpu_only_cluster": 2, "gpu_pool not ready": 3}.get(name, 0)
        assert port[0] == want

    def test_trace_id_is_fresh_and_timings_cover_the_round(self, tmp_path, capsys):
        argv = ["--nodes-json", _nodes(tmp_path, fx.gpu_pool()), "--json"]
        docs = [json.loads(_run(port_cli.main, argv, capsys)[1]) for _ in range(2)]
        assert docs[0]["trace_id"] != docs[1]["trace_id"]
        assert {"list", "detect", "render", "total"} <= set(docs[0]["timings_ms"])


FLAG_CASES = {
    "--strict-slices on a degraded slice": (
        lambda: fx.tpu_v5p_64_slice(not_ready=1), ["--strict-slices"], 3),
    "--strict-slices on complete slices": (fx.tpu_multislice, ["--strict-slices"], 0),
    "--expected-chips N met": (fx.mixed_cluster_one_notready, ["--expected-chips", "4"], 0),
    "--expected-chips 64 short": (
        lambda: fx.tpu_v5p_64_slice(not_ready=1), ["--expected-chips", "64"], 3),
    "--expected-chips KEY=N short": (
        fx.mixed_cluster_one_notready, ["--expected-chips", "nvidia.com/gpu=3"], 3),
    "--expected-chips KEY=N met": (
        fx.mixed_cluster_one_notready, ["--expected-chips", "google.com/tpu=4"], 0),
    "--expected-chips glob": (
        fx.mixed_cluster_one_notready, ["--expected-chips", "*.com/*=6"], 0),
    "--resource-key": (
        lambda: [fx.make_node("fpga-0", allocatable={"example.com/fpga": "2"})],
        ["--resource-key", "example.com/fpga"], 0),
    "--resource-key glob": (
        lambda: fx.gpu_pool(1) + [fx.make_node("npu-0", allocatable={"vendor.io/npu-a": "3"})],
        ["--resource-key", "vendor.io/npu-*"], 0),
    "--multislice-label": (
        lambda: fx.tpu_multislice(group_label="example.com/ms", not_ready=1),
        ["--multislice-label", "example.com/ms"], 0),
    "--cluster-name": (fx.gpu_pool, ["--cluster-name", "prod-us-east1"], 0),
}


class TestFlags:
    @pytest.mark.parametrize("json_mode", [False, True], ids=["text", "json"])
    @pytest.mark.parametrize("case", list(FLAG_CASES))
    def test_flag_equals_jax(self, tmp_path, capsys, case, json_mode):
        make, flags, want = FLAG_CASES[case]
        argv = ["--nodes-json", _nodes(tmp_path, make()), *flags]
        argv += ["--json"] if json_mode else []
        jax, port = _both(argv, capsys)
        _assert_equal(jax, port, json_mode)
        assert port[0] == want

    def test_cluster_name_from_the_environment(self, tmp_path, capsys, monkeypatch):
        monkeypatch.setenv("TNC_CLUSTER_NAME", "from-env")
        argv = ["--nodes-json", _nodes(tmp_path, fx.gpu_pool()), "--json"]
        jax, port = _both(argv, capsys)
        assert _payload(port[1]) == _payload(jax[1])
        assert _payload(port[1])["cluster"] == "from-env"
        assert _payload(port[1])["cluster_source"] == "env"

    def test_multislice_table_in_text(self, tmp_path, capsys):
        argv = ["--nodes-json", _nodes(tmp_path, fx.tpu_multislice(not_ready=1))]
        jax, port = _both(argv, capsys)
        assert port[:2] == jax[:2] and "ms-train-1" in port[1]

    def test_debug_prints_the_same_phases(self, tmp_path, capsys):
        argv = ["--nodes-json", _nodes(tmp_path, fx.gpu_pool()), "--debug"]
        jax, port = _both(argv, capsys)
        head = lambda out: out.split("Timings (ms): ")[0]  # noqa: E731
        assert head(port[1]) == head(jax[1])
        timings = lambda out: set(json.loads(out.split("Timings (ms): ")[1]))  # noqa: E731
        assert timings(port[1]) == timings(jax[1]) == {"list", "detect", "render", "total"}

    def test_trace_file(self, tmp_path, capsys):
        trace = tmp_path / "round.trace.json"
        argv = ["--nodes-json", _nodes(tmp_path, fx.gpu_pool()), "--json", "--trace", str(trace)]
        rc, out, err = _run(port_cli.main, argv, capsys)
        doc = json.loads(trace.read_text())
        assert rc == 0 and f"Trace written to {trace}." in err
        assert doc["otherData"]["trace_id"] == json.loads(out)["trace_id"]
        names = [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"]
        assert names == ["list", "detect", "render", "total"]


# --- --probe-results over reports the port's emitter wrote on the CPU ---

GPU_NODES = [f"gke-gpu-pool-{i}" for i in range(5)]


@pytest.fixture(scope="module")
def emitted(tmp_path_factory):
    """Two reports of the port's emitter on the CPU: a healthy enumerate
    report, and a failing one (a chaos variable the enumerate level never
    runs fails the probe with its name)."""
    out = tmp_path_factory.mktemp("emitted")
    docs = {}
    with pytest.MonkeyPatch.context() as mp:
        for k in [k for k in os.environ if k.startswith("TNC_")]:
            mp.delenv(k)
        mp.setenv("TNC_SCHEMA_STRICT", "1")
        for name, env in (("healthy", {}), ("failing", {"TNC_CHAOS_THROTTLE": "matmul_tflops"})):
            for k, v in env.items():
                mp.setenv(k, v)
            path = out / f"{name}.json"
            port_emit.emit_probe_once(str(path), level="enumerate", timeout_s=120, device="cpu")
            for k in env:
                mp.delenv(k)
            docs[name] = json.loads(path.read_text())
    assert docs["healthy"]["ok"] is True and docs["failing"]["ok"] is False
    assert "TNC_CHAOS_THROTTLE" in docs["failing"]["error"]
    return docs


def _write_report(directory, host, doc, **changes):
    doc = {**doc, "hostname": host, **changes}
    (directory / f"{host}.json").write_text(json.dumps(doc))


def _reports_dir(tmp_path, emitted):
    """One report of each kind, each named for its host."""
    d = tmp_path / "reports"
    d.mkdir()
    now = time.time()
    _write_report(d, GPU_NODES[0], emitted["healthy"], written_at=now)
    _write_report(d, GPU_NODES[1], emitted["failing"], written_at=now)
    _write_report(d, GPU_NODES[2], emitted["healthy"], written_at=now - 3600)  # stale
    _write_report(d, GPU_NODES[3], emitted["healthy"], written_at=now + 3600)  # future
    (d / "gke-gpu-pool-4.json").write_text("{not json")  # unreadable
    _write_report(d, "gke-gpu-pool-x", emitted["healthy"], written_at=now,
                  device_count="one")  # schema violation
    _write_report(d, "gke-gpu-pool-y", emitted["healthy"], written_at=now, schema=2)
    return d


def _fleet(tmp_path):
    # Five GPU nodes, and one TPU host that never reports.
    return _nodes(tmp_path, fx.gpu_pool(5) + fx.tpu_v5e_single_host())


class TestProbeResults:
    @pytest.mark.parametrize("required", [False, True], ids=["optional", "required"])
    @pytest.mark.parametrize("json_mode", [False, True], ids=["text", "json"])
    def test_reports_graded_as_jax_grades_them(self, tmp_path, capsys, emitted, required,
                                               json_mode):
        argv = ["--nodes-json", _fleet(tmp_path), "--probe-results",
                str(_reports_dir(tmp_path, emitted))]
        argv += ["--probe-results-required"] if required else []
        argv += ["--json"] if json_mode else []
        jax, port = _both(argv, capsys)
        _assert_equal(jax, port, json_mode)
        assert port[0] == 0  # healthy nodes remain
        if json_mode:
            summary = _payload(port[1])["probe_summary"]
            assert summary["hosts_ok"] == 1
            assert summary["hosts_failed"] == [GPU_NODES[1]]
            assert summary["reports_skipped"] == {"unreadable": 1, "schema": 2, "stale": 1,
                                                  "future_skew": 1}
            # The is_tpu gate, as JAX keeps it: only the TPU host is missing;
            # the GPU hosts whose reports were refused read healthy.
            assert summary["hosts_missing"] == (["gke-tpu-v5e-0"] if required else [])

    def test_max_age(self, tmp_path, capsys, emitted):
        d = tmp_path / "reports"
        d.mkdir()
        _write_report(d, GPU_NODES[0], emitted["healthy"], written_at=time.time() - 100)
        argv = ["--nodes-json", _nodes(tmp_path, fx.gpu_pool(1)), "--probe-results", str(d),
                "--probe-results-max-age", "50", "--json"]
        jax, port = _both(argv, capsys)
        _assert_equal(jax, port, True)
        assert _payload(port[1])["probe_summary"]["reports_skipped"] == {"stale": 1}

    def test_a_failing_report_fails_the_only_node(self, tmp_path, capsys, emitted):
        d = tmp_path / "reports"
        d.mkdir()
        _write_report(d, GPU_NODES[0], emitted["failing"], written_at=time.time())
        argv = ["--nodes-json", _nodes(tmp_path, fx.gpu_pool(1)), "--probe-results", str(d)]
        jax, port = _both(argv, capsys)
        _assert_equal(jax, port, False)
        assert port[0] == 3

    def test_log_jsonl_lines_equal_and_trend_reads_the_port(self, tmp_path, capsys, emitted):
        d = _reports_dir(tmp_path, emitted)
        nodes = _fleet(tmp_path)
        logs = {}
        for side, main in (("jax", jax_cli.main), ("port", port_cli.main)):
            logs[side] = tmp_path / f"{side}.jsonl"
            for extra in ([], ["--probe-results-required"], ["--strict-slices"]):
                main(["--nodes-json", nodes, "--probe-results", str(d), "--log-jsonl",
                      str(logs[side]), *extra])
            main(["--nodes-json", _nodes(tmp_path, fx.gpu_pool(2, ready=False), "down.json"),
                  "--log-jsonl", str(logs[side])])
        capsys.readouterr()

        def lines(path):
            out = [json.loads(x) for x in path.read_text().splitlines()]
            for e in out:
                e.pop("ts"), e.pop("duration_ms")
            return out

        assert lines(logs["port"]) == lines(logs["jax"])
        assert [e["exit_code"] for e in lines(logs["port"])] == [0, 0, 0, 3]
        assert lines(logs["port"])[3]["causes"] == ["not-ready: gke-gpu-pool-0",
                                                    "not-ready: gke-gpu-pool-1"]
        assert jax_checker.trend_summary(str(logs["port"]), json_mode=True) == 0
        trend = json.loads(capsys.readouterr().out)
        assert trend["rounds"] == 4


def test_missing_node_list_is_an_error_payload(tmp_path, capsys):
    argv = ["--nodes-json", str(tmp_path / "absent.json"), "--json"]
    jax, port = _both(argv, capsys)
    assert port[0] == jax[0] == 1
    assert json.loads(port[1]) == json.loads(jax[1])
    assert "absent.json" in json.loads(port[1])["error"]


def test_missing_node_list_in_text_mode(tmp_path, capsys):
    argv = ["--nodes-json", str(tmp_path / "absent.json")]
    jax, port = _both(argv, capsys)
    assert port[0] == jax[0] == 1 and port[1] == jax[1] == ""
    assert port[2].splitlines()[0] == jax[2].splitlines()[0]
    assert "Traceback" in port[2]


# --- --probe: what the round hands the probe, stubbed on both sides ---

class _Probed:
    def __init__(self, ok=True, **extra):
        self.doc = {"ok": ok, "level": "compute", "device_count": 1, "platform": "stub",
                    "hostname": "stub", **extra}

    def to_dict(self):
        return dict(self.doc)


PROBE_CASES = {
    "this host, one card": (lambda: fx.gpu_pool(1), "gke-gpu-pool-0",
                            ["--probe-level", "compute", "--probe-soak", "5",
                             "--perf-floor", "0.4", "--probe-timeout", "90"]),
    "this host not in the list": (fx.gpu_pool, "elsewhere", []),
    "a TPU host, distributed: the slice's chips and its topology": (
        lambda: fx.tpu_v5p_64_slice(), "gke-tpu-v5p-3",
        ["--probe-level", "collective", "--probe-distributed", "--probe-coordinator",
         "10.0.0.1:8476", "--probe-num-processes", "16", "--probe-process-id", "3",
         "--probe-rendezvous-timeout", "30"]),
    "an explicit topology wins": (
        lambda: fx.tpu_v5p_64_slice(), "gke-tpu-v5p-3",
        ["--probe-level", "collective", "--probe-distributed", "--probe-topology", "2x2"]),
}


class TestProbePlumbing:
    @pytest.mark.parametrize("ok", [True, False], ids=["passing", "failing"])
    @pytest.mark.parametrize("case", list(PROBE_CASES))
    def test_arguments_and_grade_equal_jax(self, tmp_path, capsys, monkeypatch, case, ok):
        make, host, flags = PROBE_CASES[case]
        monkeypatch.setenv("NODE_NAME", host)
        calls = {"jax": [], "port": []}

        def stub(side):
            def run(**kw):
                calls[side].append(kw)
                return _Probed(ok=ok, error=None if ok else "stub failure")
            return run

        monkeypatch.setattr(jax_probe, "run_local_probe", stub("jax"))
        monkeypatch.setattr(port_liveness, "run_local_probe", stub("port"))
        argv = ["--nodes-json", _nodes(tmp_path, make()), "--probe", "--json", *flags]
        jax, port = _both(argv, capsys)
        _assert_equal(jax, port, True)
        (j,), (p,) = calls["jax"], calls["port"]
        assert p.pop("device") == "cuda:0"  # the card unless the caller asks for the CPU
        assert p == j
        local = host != "elsewhere"
        if local:
            entry = next(n for n in _payload(port[1])["nodes"] if n["name"] == host)
            assert entry["probe"]["ok"] is ok
        if "distributed" in case:
            assert p["expected_devices"] == 64 and p["topology"] == "4x4x4"
        elif "explicit" in case:
            assert p["expected_devices"] == 64 and p["topology"] == "2x2"
        elif case == "this host, one card":
            assert p["expected_devices"] == 1 and p["soak_s"] == 5.0
            assert port[0] == (0 if ok else 3)


class TestProbeOnTheCpu:
    """The port's own probe, end to end: a child process on the CPU."""

    def test_compute_probe_attaches_to_this_node(self, tmp_path, capsys, monkeypatch):
        monkeypatch.setenv("NODE_NAME", "gke-gpu-pool-0")
        monkeypatch.setenv("OMP_NUM_THREADS", "2")
        argv = ["--nodes-json", _nodes(tmp_path, fx.gpu_pool(1)), "--probe", "--device", "cpu",
                "--probe-level", "compute", "--json"]
        rc, out, err = _run(port_cli.main, argv, capsys)
        doc = json.loads(out)
        assert rc == 0, err
        (node,) = doc["nodes"]
        assert node["probe"]["ok"] is True and node["probe"]["level"] == "compute"
        assert node["probe"] == doc["local_probe"]
        assert node["probe"]["platform"] == "cpu" and "probe" in doc["timings_ms"]

    def test_too_few_devices_fail_the_node(self, tmp_path, capsys, monkeypatch):
        monkeypatch.setenv("NODE_NAME", "gke-gpu-pool-0")
        items = fx.gpu_pool(1)
        items[0]["status"]["allocatable"]["nvidia.com/gpu"] = "2"
        argv = ["--nodes-json", _nodes(tmp_path, items), "--probe", "--device", "cpu"]
        rc, out, _ = _run(port_cli.main, argv, capsys)
        assert rc == 3
        assert "Local chip probe [enumerate] FAILED: 1 device(s), platform=cpu" in out
        rc, out, _ = _run(port_cli.main, argv + ["--json"], capsys)
        assert "only 1/2 expected devices enumerated" in json.loads(out)["local_probe"]["error"]


# --- usage errors ---

def _usage(parse, argv, capsys):
    with pytest.raises(SystemExit) as exc:
        parse(argv)
    return exc.value.code, capsys.readouterr().err.strip().splitlines()[-1]


N = ["--nodes-json", "n.json"]
USAGE_EQUAL_JAX = [
    (N + ["--probe-results-required"], "--probe-results-required requires --probe-results DIR"),
    (N + ["--history-max-rounds", "8"], "--history-max-rounds requires --history FILE"),
    (N + ["--cordon-after", "2"], "--cordon-after requires --history FILE"),
    (N + ["--uncordon-after", "2"], "--uncordon-after requires --history FILE"),
    (N + ["--flap-threshold", "3"], "--flap-threshold requires --history FILE"),
    (N + ["--flap-window", "5"], "--flap-window requires --history FILE"),
    (N + ["--history", "h", "--history-max-rounds", "0"],
     "--history-max-rounds must be at least 1"),
    (N + ["--history", "h", "--cordon-after", "0"], "--cordon-after must be at least 1"),
    (N + ["--history", "h", "--uncordon-after", "0"], "--uncordon-after must be at least 1"),
    (N + ["--history", "h", "--flap-threshold", "1"], "--flap-threshold must be at least 2"),
    (N + ["--history", "h", "--flap-window", "1"], "--flap-window must be at least 2"),
    (N + ["--history", "h", "--history-max-rounds", "4"],
     "--flap-window cannot exceed --history-max-rounds"),
    (["--selftest", "--probe"], "--selftest runs alone"),
    (["--selftest", "--nodes-json", "n.json"], "--selftest runs alone"),
    (["--selftest", "--probe-results", "d"], "--selftest runs alone"),
    (["--selftest", "--history", "h"], "--selftest runs alone"),
    (["--selftest", "--slack-webhook", "http://x"], "--selftest runs alone"),
    (["--selftest", "--strict-slices"], "--selftest runs alone"),
    (["--selftest", "--expected-chips", "8"], "--selftest runs alone"),
    (["--selftest", "--resource-key", "k"], "--selftest runs alone"),
    (["--selftest", "--multislice-label", "k"], "--selftest runs alone"),
    (["--selftest", "--trace", "t"], "--selftest runs alone"),
    (["--calibrate", "2", "--probe-level", "compute", "--probe"], "--calibrate runs alone"),
    (["--calibrate", "2", "--probe-level", "compute", "--nodes-json", "n"],
     "--calibrate runs alone"),
    (["--calibrate", "2", "--probe-level", "compute", "--history", "h"],
     "--calibrate runs alone"),
    (["--calibrate", "2", "--probe-level", "compute", "--probe-results", "d"],
     "--calibrate runs alone"),
    (["--calibrate", "2", "--probe-level", "compute", "--slack-only-on-error"],
     "--calibrate runs alone"),
    (["--calibrate", "2", "--probe-level", "compute", "--trace", "t"], "--calibrate runs alone"),
    (["--emit-probe", "-", "--slack-webhook", "http://x"],
     "--slack-webhook cannot be combined with --emit-probe"),
    (["--emit-probe", "-", "--slack-only-on-error"],
     "--slack-only-on-error cannot be combined with --emit-probe"),
    (N + ["--probe-distributed"], "--probe-distributed requires --probe or --emit-probe"),
    (N + ["--probe", "--probe-coordinator", "h:1"],
     "--probe-coordinator requires --probe-distributed"),
    (N + ["--probe-soak", "5"], "--probe-soak requires --probe, --emit-probe or --calibrate"),
    (N + ["--probe", "--probe-soak", "5"],
     "--probe-soak requires --probe-level compute (or higher)"),
    (N + ["--probe-level", "compute", "--perf-floor", "0.4"],
     "--perf-floor requires --probe or --emit-probe"),
    (N + ["--probe", "--perf-floor", "0.4"],
     "--perf-floor requires --probe-level compute (or higher)"),
    (N + ["--probe", "--probe-level", "compute", "--perf-floor", "-1"],
     "--perf-floor must be >= 0 (0 disables)"),
    (N + ["--expected-chips", "=8"], "argument --expected-chips: malformed resource key"),
    (N + ["--expected-chips", "0"], "argument --expected-chips: chip count must be positive"),
    (N + ["--expected-chips", "eight"],
     "argument --expected-chips: expected an integer chip count"),
    (N + ["--probe-level", "fast"], "argument --probe-level: invalid choice"),
]


class TestUsageErrors:
    @pytest.mark.parametrize("argv,message", USAGE_EQUAL_JAX)
    def test_jax_rule_with_jax_words(self, capsys, argv, message):
        port_code, port_err = _usage(port_cli.parse_args, argv, capsys)
        jax_code, jax_err = _usage(jax_cli.parse_args, argv, capsys)
        assert port_code == jax_code == 2
        assert port_err.split(": error: ")[1] == jax_err.split(": error: ")[1]
        assert port_err.split(": error: ")[1].startswith(message)

    @pytest.mark.parametrize("argv,message", [
        (["--emit-probe", "-", "--kubeconfig", "k"],
         "--kubeconfig belongs to the one-shot round: it cannot be combined with --emit-probe"),
        (["--selftest", "--retry-budget", "5"],
         "--retry-budget belongs to the one-shot round: it cannot be combined with --selftest"),
        (["--event-log", "e"], "--event-log records daemon-mode events: it requires --watch"),
        (N + ["--slack-on-change"], "--slack-on-change requires --watch"),
        (N + ["--probe-level", "compute"], "--probe-level requires --probe or --emit-probe"),
        (N + ["--device", "cpu"], "--device requires --probe or --emit-probe"),
        (["--emit-probe", "-", "--nodes-json", "n"],
         "--nodes-json belongs to the one-shot round: it cannot be combined with --emit-probe"),
        (["--emit-probe", "-", "--probe"], "--probe belongs to the one-shot round"),
        (["--emit-probe", "-", "--probe-results", "d"],
         "--probe-results belongs to the one-shot round"),
        (["--emit-probe", "-", "--strict-slices"], "--strict-slices belongs to the one-shot"),
        (["--emit-probe", "-", "--debug"], "--debug belongs to the one-shot round"),
        (["--selftest", "--cluster-name", "c"], "--cluster-name belongs to the one-shot round"),
        (["--emit-probe", "-", "--json"],
         "--json requires --selftest or a one-shot round (not --emit-probe)"),
    ])
    def test_port_rule(self, capsys, argv, message):
        code, err = _usage(port_cli.parse_args, argv, capsys)
        assert code == 2 and f"error: {message}" in err

    @pytest.mark.parametrize("argv", [
        N, N + ["--probe", "--probe-level", "workload", "--probe-timeout", "90"],
        N + ["--probe-results", "d", "--probe-results-required", "--probe-results-max-age",
             "60", "--history", "h", "--cordon-after", "2", "--uncordon-after", "2",
             "--flap-threshold", "3", "--flap-window", "8", "--history-max-rounds", "16"],
        N + ["--slack-webhook", "http://x", "--slack-username", "u", "--slack-only-on-error",
             "--slack-retry-count", "0", "--slack-retry-delay", "0"],
        ["--emit-probe", "-", "--history", "h", "--log-jsonl", "l", "--cordon-after", "2"],
    ])
    def test_parses_as_jax_parses_it(self, argv):
        port, jax = port_cli.parse_args(argv), jax_cli.parse_args(argv)
        for dest, value in vars(port).items():
            if hasattr(jax, dest):
                assert value == getattr(jax, dest), dest

    @pytest.mark.parametrize("flag", [
        ["--federate-feed"], ["--federate-workers", "2"], ["--federate", "e"],
        ["--federate-interval", "5"], ["--watch-stream"], ["--no-watch-stream"],
        ["--fleet-disruption-budget", "2"],
    ])
    def test_unported_jax_flag_is_unknown(self, capsys, flag):
        # Once unknown arguments; now ported, each gives JAX's usage error
        # beside a file round, or (--no-watch-stream, the default) JAX's
        # values: no flag is left unknown.
        got = outcome_vs_jax(N + flag, capsys)
        if flag == ["--no-watch-stream"]:
            assert got.watch_stream is False
        else:
            assert flag[0] in got

    @pytest.mark.parametrize("flag,expected", [
        (["--cordon-max", "2"], "--cordon-max requires --cordon-failed, --drain-failed or --serve"),
        (["--cordon-dry-run"], "--cordon-dry-run requires --cordon-failed or --uncordon-recovered"),
        (["--cordon-degraded"], "--cordon-degraded requires --probe or --probe-results DIR"),
        (["--repair-cmd", "r"], "--repair-cmd/--repair-webhook require --history FILE (repair "
         "state rides the store so a restart never double-fires)"),
        (["--cordon-failed"], "--cordon-failed requires --probe or --probe-results DIR"),
        (["--uncordon-recovered"], "--uncordon-recovered requires --probe or --probe-results DIR"),
        (["--trend", "t"], ("trend", "t")),
        (["--trend-nodes", "t"], ("trend_nodes", "t")),
        (["--disruption-budget", "2"], "--disruption-budget requires --cordon-failed or "
         "--drain-failed (a budget with no actuator gates nothing)"),
        (["--drain-failed"], "--drain-failed requires --probe or --probe-results DIR"),
        (["--serve", "0"], "--serve without --watch serves a recorded store: add --history "
         "FILE and/or --log-jsonl FILE (or run with --watch)"),
        (["--analytics", "d"], "--analytics requires --history FILE"),
        (["--serve-token", "t"], "--serve-token requires --serve"),
        (["--serve-workers", "2"], "--serve-workers requires --serve"),
        (["--write-rps", "5"], "--write-rps requires --serve"),
    ])
    def test_ported_jax_flag_as_jax(self, capsys, flag, expected):
        # Once an unknown argument; ported, each gives JAX's usage error
        # beside a file round, or parses to JAX's values (the readers, which
        # JAX lets a file round's flags accompany).
        got = outcome_vs_jax(N + flag, capsys)
        if isinstance(expected, tuple):
            assert getattr(got, expected[0]) == expected[1]
        else:
            assert got == expected
