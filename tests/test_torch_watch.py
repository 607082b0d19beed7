"""The port's aggregator loop (``--watch`` without ``--emit-probe``), held
against the JAX checker's.

Both packages' ``checker.watch`` run in this process, each through its
CLI's ``main``, over the same scripted rounds.  The loop's inter-round wait
is faked through the ``_wait_for_next_round`` seam, so nothing sleeps: the
fake records the seconds the loop asked for, scrapes ``/metrics`` on the
loop's ephemeral port, sets up the next round's nodes, and after the last
round says that SIGTERM came (exit 143).

The nodes come from a ``--nodes-json`` file rewritten between rounds (a
malformed file is a failed round) or from one module-scoped fake API server
(``tests/test_torch_cluster.py``'s) whose 500s are the failed rounds.  The
rounds cover the first round, an unchanged one, a node swap under the same
exit code, an actionable hysteresis transition (``--history --cordon-after
2``), failed rounds opening the circuit breaker (interval scales 1, 1, 2,
4, 8 and the cap at 8), the recovery, and a restart that resumes from
``--log-jsonl`` without a new alert.  ``--probe`` is stubbed on both sides.

The two sides must agree on the exit codes, the waits asked for (within
0.5 s), stdout, stderr (less the listening port and the event lines),
every Slack message, the ``--log-jsonl`` lines less ``ts`` and
``duration_ms`` (the round's wall time), the ``--event-log`` lines less
``ts`` and ``trace_id``, and each round's ``/metrics`` body less the
timestamp, the durations and the phase-histogram buckets.  One more test
runs the port's real CPU probe in two rounds of the loop.

The port is reached through ``importlib.import_module``:
tests/test_dependency_surface.py rejects any other ``import`` in tests/.
"""

import http.client
import importlib
import json
import re

import pytest

from tests import fixtures as fx
from tests.test_torch_cluster import (
    ApiServer,
    _isolated,  # noqa: F401 — the autouse fixture, for this module too
    kubeconfig,
)
from tpu_node_checker import checker as jax_checker
from tpu_node_checker import cli as jax_cli
from tpu_node_checker import metrics as jax_metrics
from tpu_node_checker import notify as jax_notify
from tpu_node_checker import probe as jax_probe

port_checker = importlib.import_module("tpu_node_checker_torch.checker")
port_cli = importlib.import_module("tpu_node_checker_torch.cli")
port_metrics = importlib.import_module("tpu_node_checker_torch.metrics")
port_notify = importlib.import_module("tpu_node_checker_torch.notify")
port_liveness = importlib.import_module("tpu_node_checker_torch.probe.liveness")
port_build = importlib.import_module("tpu_node_checker_torch.ops._build")

SIDES = {
    "jax": (jax_cli, jax_checker, jax_notify, jax_metrics),
    "port": (port_cli, port_checker, port_notify, port_metrics),
}
INTERVAL = 10.0
HOST, A, B = "gke-gpu-pool-0", "gke-gpu-pool-2", "gke-gpu-pool-3"
FAIL = "fail"
# Samples that are wall times or a wall clock (the phase histogram's counts
# stay: one sample per phase per round).
VOLATILE_SAMPLES = ("tpu_node_checker_last_run_timestamp_seconds",
                    "tpu_node_checker_check_duration_ms",
                    "tpu_node_checker_round_phase_duration_ms_bucket",
                    "tpu_node_checker_round_phase_duration_ms_sum")


@pytest.fixture(scope="module")
def api():
    state = ApiServer()
    server = fx.serve_http(state.handler())
    state.url = f"http://127.0.0.1:{server.server_address[1]}"
    yield state
    server.shutdown()
    server.server_close()


def fleet(sick):
    """Four Ready GPU nodes but the ``sick`` ones, which are NotReady."""
    nodes = fx.gpu_pool(4)
    for n in nodes:
        if n["metadata"]["name"] in sick:
            n["status"]["conditions"] = [{"type": "Ready", "status": "False",
                                          "reason": "KubeletNotReady"}]
    return nodes


class _Probed:
    """What the stubbed probe reports: healthy, with one mesh link leg."""

    def __init__(self):
        self.doc = {"ok": True, "level": "compute", "device_count": 1, "platform": "stub",
                    "hostname": HOST, "error": None,
                    "collective_legs_ok": {"links": {
                        "t0/0->1": {"p50_us": 12.5, "verdict": "OK", "budget_us": 100.0}}}}

    def to_dict(self):
        return dict(self.doc)


class Source:
    """Where a round's nodes come from: the fake API server or a file."""

    def __init__(self, kind, api, tmp_path):
        self.kind, self.api = kind, api
        self.nodes_json = tmp_path / "nodes.json"
        if kind == "api":
            self.argv = ["--kubeconfig", kubeconfig(tmp_path / "kc", api.url),
                         "--retry-budget", "0"]
        else:
            self.argv = ["--nodes-json", str(self.nodes_json)]

    def serve(self, step):
        if self.kind == "api":
            if step == FAIL:
                self.api.faults = fx.FaultSchedule(["500"])
            else:
                self.api.reset(fleet(step))
        elif step == FAIL:
            self.nodes_json.write_text("{not json")
        else:
            self.nodes_json.write_text(json.dumps(fx.node_list(fleet(step))))


def get(port, path="/metrics"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def stable_metrics(body):
    return [line for line in body.splitlines() if not line.startswith(VOLATILE_SAMPLES)]


def run_loop(side, source, rounds, flags, workdir, capsys, monkeypatch):
    """One side's loop over ``rounds`` (each a sick-node set, or FAIL):
    what it returned, printed, posted, waited for and served."""
    cli, checker, notify, metrics = SIDES[side]
    workdir.mkdir(exist_ok=True)
    rec = {"waits": [], "slack": [], "scrapes": [], "servers": []}

    class Recorded(metrics.MetricsServer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            rec["servers"].append(self)

    def wait(stop, seconds):
        rec["waits"].append(seconds)
        for server in rec["servers"]:
            rec["scrapes"].append(get(server.port))
        if len(rec["waits"]) < len(rounds):
            source.serve(rounds[len(rec["waits"])])
            return False
        return True

    def send(webhook, message, **kw):
        kw.pop("trace_id", None)
        rec["slack"].append((message, kw))
        return True

    monkeypatch.setattr(checker, "_wait_for_next_round", wait)
    monkeypatch.setattr(notify, "send_slack_message", send)
    monkeypatch.setattr(metrics, "MetricsServer", Recorded)
    source.serve(rounds[0])
    argv = [a.replace("{dir}", str(workdir)) for a in source.argv + flags]
    try:
        rec["rc"] = cli.main(argv)
    finally:
        for server in rec["servers"]:
            server.close()
    rec["out"], err = capsys.readouterr()
    rec["err"] = [line.replace(str(workdir), "{dir}") for line in err.splitlines()
                  if not line.startswith(("{", "Serving /metrics on port"))]
    return rec


def read_lines(path, drop):
    if not path.exists():
        return []
    return [{k: v for k, v in json.loads(line).items() if k not in drop}
            for line in path.read_text().splitlines()]


def both_loops(source, rounds, flags, tmp_path, capsys, monkeypatch):
    """The JAX loop, then the port's, over the same rounds; each side's
    files in its own directory.  Returns {side: record}."""
    got = {}
    for side in ("jax", "port"):
        checker = SIDES[side][1]
        # A new process: no tracker carried over from an earlier loop.
        monkeypatch.setitem(checker._HISTORY_CACHE, "key", None)
        checker.reset_client_cache()
        got[side] = run_loop(side, source, rounds, flags, tmp_path / side, capsys, monkeypatch)
        got[side]["log"] = read_lines(tmp_path / side / "rounds.jsonl", ("ts", "duration_ms"))
        got[side]["event_log"] = read_lines(tmp_path / side / "events.jsonl",
                                            ("ts", "trace_id"))
        got[side]["event_ids"] = [e.get("trace_id") for e in
                                  read_lines(tmp_path / side / "events.jsonl", ("ts",))]
    return got


def assert_loops_equal(jax, port):
    assert port["rc"] == jax["rc"] == 143
    assert len(port["waits"]) == len(jax["waits"])
    assert all(abs(p - j) < 0.5 for p, j in zip(port["waits"], jax["waits"]))
    assert port["slack"] == jax["slack"]
    assert port["out"] == jax["out"]
    assert port["err"] == jax["err"]
    assert port["log"] == jax["log"]
    assert port["event_log"] == jax["event_log"]
    assert [(s, stable_metrics(b)) for s, b in port["scrapes"]] == \
        [(s, stable_metrics(b)) for s, b in jax["scrapes"]]


@pytest.fixture
def stub_probe(monkeypatch):
    monkeypatch.setenv("NODE_NAME", HOST)
    monkeypatch.setattr(jax_probe, "run_local_probe", lambda **kw: _Probed())
    monkeypatch.setattr(port_liveness, "run_local_probe", lambda **kw: _Probed())


LOOP_FLAGS = ["--watch", str(INTERVAL), "--probe", "--probe-level", "compute",
              "--strict-slices", "--slack-webhook", "http://127.0.0.1:1/hook",
              "--slack-on-change", "--metrics-port", "0", "--log-jsonl", "{dir}/rounds.jsonl",
              "--event-log", "{dir}/events.jsonl"]
# First round, unchanged, a same-code swap, six failures, the recovery.
PLAIN = [{A}, {A}, {B}, FAIL, FAIL, FAIL, FAIL, FAIL, FAIL, {B}]
# Under --cordon-after 2: A SUSPECT, then FAILED (actionable), unchanged,
# the swap (A RECOVERING, B SUSPECT), three failures, then B FAILED.
HISTORY = [{A}, {A}, {A}, {B}, FAIL, FAIL, FAIL, {B}]
HISTORY_FLAGS = ["--history", "{dir}/history.jsonl", "--cordon-after", "2",
                 "--uncordon-after", "3", "--cluster-name", "us-a"]


def scales(waits):
    return [round(w / INTERVAL) for w in waits]


@pytest.mark.usefixtures("stub_probe")
class TestScriptedRounds:
    @pytest.mark.parametrize("kind", ["api", "file"])
    def test_plain_rounds_equal_jax(self, api, tmp_path, capsys, monkeypatch, kind):
        source = Source(kind, api, tmp_path)
        got = both_loops(source, PLAIN, LOOP_FLAGS, tmp_path, capsys, monkeypatch)
        jax, port = got["jax"], got["port"]
        assert_loops_equal(jax, port)
        # The breaker: scale 1 until the third failure opens it, then
        # doubling to the cap of 8; the recovery restores the interval.
        assert scales(port["waits"]) == [1, 1, 1, 1, 1, 2, 4, 8, 8, 1]
        messages = [m for m, _ in port["slack"]]
        assert len(messages) == 6
        assert "FAILED to run" in messages[2] and "DEGRADED" in messages[3]
        assert "RECOVERED" in messages[4]
        assert [kw["max_retries"] for _, kw in port["slack"]][2:5] == [0, 0, 0]
        assert f"State change: sick-node set ['{A}'] → ['{B}'] (exit 0 unchanged)" in port["err"]
        assert "State change: exit 0 → 1" in port["err"]
        assert sum("Watch breaker OPEN" in line for line in port["err"]) == 4
        assert "SIGTERM: watch loop stopped cleanly (last round's state log flushed)." \
            in port["err"]
        assert [line["exit_code"] for line in port["log"]] == [0, 0, 0, 1, 1, 1, 1, 1, 1, 0]
        assert [e["event"] for e in port["event_log"]] == ["breaker-opened", "breaker-closed"]
        assert all(re.fullmatch(r"[0-9a-f]{16}", t) for t in port["event_ids"])
        # One trace per round: the events name different rounds.
        assert len(set(port["event_ids"])) == 2
        status, body = port["scrapes"][5]
        assert status == 200 and "tpu_node_checker_watch_breaker_open 1.0" in body
        assert "tpu_node_checker_watch_breaker_consecutive_failures 3.0" in body
        assert "tpu_node_checker_exit_code 1" in body
        # The body is rendered before the round's own trace completes, so
        # the phase histogram holds the rounds before it (9, of which 3
        # probed); the round's link samples are recorded before the render.
        status, body = port["scrapes"][-1]
        for want in ('tpu_node_checker_nodes{state="total"} 4',
                     "tpu_node_checker_watch_breaker_open 0.0",
                     'tpu_node_checker_round_phase_duration_ms_count{phase="total"} 9.0',
                     'tpu_node_checker_round_phase_duration_ms_count{phase="probe"} 3.0',
                     'tpu_node_checker_mesh_link_duration_us_count{axis="t0",slice="-"} 4.0',
                     'tpu_node_checker_probe_ok{level="compute"} 1.0'):
            assert want in body, want

    @pytest.mark.parametrize("kind", ["api", "file"])
    def test_history_rounds_equal_jax(self, api, tmp_path, capsys, monkeypatch, kind):
        source = Source(kind, api, tmp_path)
        got = both_loops(source, HISTORY, LOOP_FLAGS + HISTORY_FLAGS, tmp_path, capsys,
                         monkeypatch)
        jax, port = got["jax"], got["port"]
        assert_loops_equal(jax, port)
        assert scales(port["waits"]) == [1, 1, 1, 1, 1, 1, 2, 1]
        events = [(e["event"], e.get("node")) for e in port["event_log"]]
        assert events == [("fsm-transition", A), ("breaker-opened", None),
                          ("breaker-closed", None), ("fsm-transition", B)]
        assert all(e["cluster"] == "us-a" for e in port["event_log"])
        # The first round, A's →FAILED, the swap, FAILED to run, DEGRADED,
        # RECOVERED and B's →FAILED round: the unchanged round posts nothing.
        assert len(port["slack"]) == 7
        assert f"State change: sick-node set [('{A}', 'FAILED')] → [] (exit 0 unchanged)" \
            in port["err"]
        status, body = port["scrapes"][-1]
        assert 'tpu_node_checker_node_state{cluster="us-a",state="FAILED"} 1.0' in body

    def test_a_restart_resumes_from_the_log_without_a_new_alert(self, api, tmp_path, capsys,
                                                               monkeypatch):
        source = Source("api", api, tmp_path)
        both_loops(source, [{A}, {B}], LOOP_FLAGS, tmp_path, capsys, monkeypatch)
        got = both_loops(source, [{B}, {B}], LOOP_FLAGS, tmp_path, capsys, monkeypatch)
        jax, port = got["jax"], got["port"]
        assert_loops_equal(jax, port)
        assert port["slack"] == []
        assert port["err"][0] == ("Resuming state-transition alerting from exit 0 "
                                  "(recovered from {dir}/rounds.jsonl)")
        assert len(port["log"]) == 4

    def test_without_slack_on_change_every_round_posts(self, api, tmp_path, capsys,
                                                       monkeypatch):
        flags = [f for f in LOOP_FLAGS if f != "--slack-on-change"]
        source = Source("api", api, tmp_path)
        got = both_loops(source, [{A}, {A}, FAIL, FAIL, {A}], flags, tmp_path, capsys,
                         monkeypatch)
        assert_loops_equal(got["jax"], got["port"])
        # Two fleet posts, two failures, the fleet post of the last round.
        assert len(got["port"]["slack"]) == 5

    def test_json_rounds_carry_each_rounds_trace_id(self, api, tmp_path, capsys, monkeypatch):
        source = Source("api", api, tmp_path)
        flags = LOOP_FLAGS + ["--json", "--trace", "{dir}/trace.json"]
        got = both_loops(source, [{A}, FAIL, {B}], flags, tmp_path, capsys, monkeypatch)
        jax, port = got["jax"], got["port"]
        assert port["rc"] == jax["rc"] == 143
        docs = {side: _json_docs(got[side]["out"]) for side in got}
        strip = ("trace_id", "timings_ms")
        assert [{k: v for k, v in d.items() if k not in strip} for d in docs["port"]] == \
            [{k: v for k, v in d.items() if k not in strip} for d in docs["jax"]]
        assert len(docs["port"]) == 2 and docs["port"][0]["trace_id"] != docs["port"][1]["trace_id"]
        # The trace file is the last round's, under its trace id.
        trace = json.loads((tmp_path / "port" / "trace.json").read_text())
        assert trace["otherData"]["trace_id"] == docs["port"][-1]["trace_id"]
        assert trace["otherData"]["round_seq"] == 3
        assert {"list", "detect", "probe", "render"} <= {
            e["name"] for e in trace["traceEvents"] if e.get("ph") == "X"}


def _json_docs(out):
    docs, decoder, i = [], json.JSONDecoder(), 0
    while i < len(out):
        if out[i].isspace():
            i += 1
            continue
        doc, i = decoder.raw_decode(out, i)
        docs.append(doc)
    return docs


def test_the_real_cpu_probe_in_two_loop_rounds(api, tmp_path, capsys, monkeypatch):
    # The port's own probe child on the CPU in each round (the kernels'
    # plain versions), attached to this host's node, and its gauges served.
    api.reset(fleet(set()))
    monkeypatch.setenv("NODE_NAME", HOST)
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    source = Source("api", api, tmp_path)
    flags = ["--watch", "1", "--probe", "--device", "cpu", "--probe-level", "compute",
             "--metrics-port", "0", "--json", "--log-jsonl", "{dir}/rounds.jsonl"]
    rec = run_loop("port", source, [set(), set()], flags, tmp_path / "port", capsys,
                   monkeypatch)
    assert rec["rc"] == 143, rec["err"]
    docs = _json_docs(rec["out"])
    assert len(docs) == 2
    for doc in docs:
        node = next(n for n in doc["nodes"] if n["name"] == HOST)
        assert node["probe"] == doc["local_probe"]
        assert doc["local_probe"]["ok"] is True and doc["local_probe"]["platform"] == "cpu"
        assert doc["local_probe"]["kernel_launches"] == dict.fromkeys(port_build.KERNELS, 0)
    assert docs[0]["trace_id"] != docs[1]["trace_id"]
    for status, body in rec["scrapes"]:
        assert status == 200 and 'tpu_node_checker_probe_ok{level="compute"} 1.0' in body
    # A round slower than the interval runs back to back.
    assert rec["waits"] == [0.0, 0.0]


USAGE_EQUAL_JAX = [
    (["--slack-on-change"], "--slack-on-change requires --watch"),
    (["--nodes-json", "n", "--event-log", "e"],
     "--event-log records daemon-mode events: it requires --watch, --serve or --federate"),
    (["--emit-probe", "-", "--watch", "5", "--slack-on-change"],
     "--slack-on-change cannot be combined with --emit-probe"),
    (["--emit-probe", "-", "--watch", "5", "--event-log", "e"],
     "--event-log cannot be combined with --emit-probe"),
    (["--watch", "0"], "--watch interval must be a positive number of seconds"),
    (["--nodes-json", "n", "--metrics-port", "0"],
     "--metrics-port requires --watch (one-shot runs serve no scrapes)"),
    (["--selftest", "--watch", "5", "--slack-on-change"], "--selftest runs alone"),
]


def _usage(parse, argv, capsys):
    with pytest.raises(SystemExit) as exc:
        parse(argv)
    return exc.value.code, capsys.readouterr().err.strip().splitlines()[-1]


class TestCli:
    @pytest.mark.parametrize("argv,message", USAGE_EQUAL_JAX)
    def test_usage_error_equals_jax(self, capsys, argv, message):
        port_code, port_err = _usage(port_cli.parse_args, argv, capsys)
        jax_code, jax_err = _usage(jax_cli.parse_args, argv, capsys)
        assert port_code == jax_code == 2
        assert port_err.split(": error: ")[1] == jax_err.split(": error: ")[1]
        assert port_err.split(": error: ")[1].startswith(message)

    @pytest.mark.parametrize("argv", [
        ["--watch", "60", "--strict-slices", "--probe-results", "d",
         "--probe-results-required", "--slack-on-change", "--metrics-port", "9090",
         "--log-jsonl", "l", "--history", "h", "--cordon-after", "2", "--uncordon-after", "3",
         "--event-log", "e"],
        ["--watch", "1", "--probe", "--probe-level", "workload", "--json", "--trace", "t"],
    ])
    def test_the_deployments_argv_parses_as_jax_parses_it(self, argv):
        port, jax = port_cli.parse_args(argv), jax_cli.parse_args(argv)
        for dest, value in vars(port).items():
            if hasattr(jax, dest):
                assert value == getattr(jax, dest), dest

    def test_version_equals_jax(self, capsys):
        got = []
        for cli in (jax_cli, port_cli):
            with pytest.raises(SystemExit) as exc:
                cli.main(["--version"])
            got.append((exc.value.code, capsys.readouterr()))
        assert got[0] == got[1]
        assert got[1][0] == 0 and got[1][1].out == "tpu-node-checker 0.1.0\n"

    def test_watch_dispatches_to_the_loop(self, monkeypatch):
        calls = []
        monkeypatch.setattr(port_checker, "watch", lambda args: calls.append(args) or 143)
        assert port_cli.main(["--nodes-json", "n", "--watch", "5"]) == 143
        assert calls[0].watch == 5.0
