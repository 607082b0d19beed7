"""The port's fleet state API (``--serve``, ``--serve-token``,
``--serve-workers``, ``--write-rps``, standalone ``serve_store``), held
against the JAX checker's.

The aggregator Deployment's argv, ``--watch 1`` instead of 60 and with
``--analytics``, runs through both CLIs' ``main`` in this process: one
fake API server per module (it applies each PATCH to the next LIST), probe
reports rewritten between rounds (this host healthy, failed, healthy,
failed, healthy, healthy), ``TNC_SERVE_TOKEN`` set, two accept loops on an
ephemeral port and a write bucket of 5 a second.  The loop's wait is faked
(nothing sleeps) and the wall clock is pinned, stepping one interval a
round on each side.  Before the first round and after every round the fake
wait reads the fleet API: every route's status and body, ``X-TNC-Round``,
a 304 for the last ETag, gzip, the ``/api/v1/watch`` feed frame, 404s; after
the first round the writes (no bearer and a wrong one are 401, then a
burst of 8 dry-run POSTs gets 5 answers and 429s with ``Retry-After``).
Then ``serve_store`` of each CLI serves the recorded store standalone.

The two sides must agree on all of it, on the exit codes, the PATCH
bodies, the Slack posts and the ``--event-log`` lines.  The masks, each
named below: ``trace_id`` and ``X-TNC-Trace`` (a random id per round),
``timings_ms`` and a debug round's ``total_ms`` (the round's wall time),
the ``round_ms`` sketch (its samples are round durations), and the
latency histograms and duration samples of ``/metrics``.

The CLI's rules for the new flags are held to JAX's words, and the seven
JAX flags still unported stay unknown arguments (exit 2).

The port is reached through ``importlib.import_module``:
tests/test_dependency_surface.py rejects any other ``import`` in tests/.
"""

import gzip
import http.client
import importlib
import json
import re
import threading
import time

import pytest

from tests import fixtures as fx
from tests.test_torch_cluster import _isolated  # noqa: F401 — the autouse fixture
from tests.test_torch_cluster import kubeconfig
from tests.test_torch_remediation import Cluster, _patch_bodies, write_reports
from tpu_node_checker import checker as jax_checker
from tpu_node_checker import cli as jax_cli
from tpu_node_checker import notify as jax_notify
from tpu_node_checker.server import app as jax_app

port_checker = importlib.import_module("tpu_node_checker_torch.checker")
port_cli = importlib.import_module("tpu_node_checker_torch.cli")
port_notify = importlib.import_module("tpu_node_checker_torch.notify")
port_app = importlib.import_module("tpu_node_checker_torch.server.app")

SIDES = {
    "jax": (jax_cli, jax_checker, jax_notify, jax_app),
    "port": (port_cli, port_checker, port_notify, port_app),
}
HOST = "gke-gpu-pool-0"
OTHERS = ["gke-gpu-pool-1", "gke-gpu-pool-2", "gke-gpu-pool-3"]
# This host's report each round: the drill fails it twice.
PLAN = [True, False, True, False, True, True]
TOKEN = "fleet-api-token"
BASE = 1_700_000_040.0
GETS = ["/healthz", "/readyz", "/api/v1/summary", "/api/v1/nodes", f"/api/v1/nodes/{HOST}",
        "/api/v1/slices", "/api/v1/trend", "/api/v1/remediation", "/api/v1/analytics/slo",
        "/api/v1/analytics/offenders", "/api/v1/analytics/flaps", "/api/v1/debug/rounds",
        "/api/v1/watch?since=&timeout=0", "/metrics", "/api/v1/nope", "/api/v1/nodes/nope"]
# The masks.  A round's trace id is random; its timings and a debug
# round's total are wall times, and so are the round_ms sketch's samples.
MASKED_KEYS = ("trace_id", "timings_ms", "total_ms")
MASKED_SKETCHES = ("round_ms",)
# The headers compared; X-TNC-Trace (the round's trace id) is not.
KEPT_HEADERS = ("Content-Type", "X-TNC-Round", "Retry-After", "WWW-Authenticate")
# /metrics samples that are wall times (durations, latency histograms).
WALL_SAMPLES = re.compile(r"^tpu_node_checker_\w*(duration_ms|latency\w*|_seconds)"
                          r"(_bucket|_sum|_count)?[{ ]")
DEPLOYMENT_ARGV = [
    "--watch", "1", "--strict-slices", "--probe-results", "{dir}/reports",
    "--probe-results-required", "--slack-webhook", "http://127.0.0.1:1/hook",
    "--slack-on-change", "--metrics-port", "0", "--log-jsonl", "{dir}/rounds.jsonl",
    "--history", "{dir}/history.jsonl", "--cordon-after", "2", "--uncordon-after", "3",
    "--disruption-budget", "2/10m", "--slice-floor-pct", "90", "--cordon-failed",
    "--uncordon-recovered", "--serve", "0", "--serve-workers", "2", "--write-rps", "5",
    "--event-log", "{dir}/events.jsonl", "--analytics", "{dir}/analytics",
]


def masked(obj):
    if isinstance(obj, dict):
        return {k: "<masked>" if k in MASKED_KEYS or (k in MASKED_SKETCHES
                                                      and isinstance(v, dict))
                else masked(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [masked(v) for v in obj]
    return obj


def request(port, method, path, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request(method, path, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def comparable(path, status, headers, body):
    """What of one exchange must equal JAX's: the masks applied."""
    if path == "/metrics":
        text = [line for line in body.decode().splitlines() if not WALL_SAMPLES.match(line)]
    else:
        text = masked(json.loads(body)) if body else None
    return status, {k: v for k, v in headers.items() if k in KEPT_HEADERS}, text


class Clock:
    def __init__(self):
        self.t = BASE + 1.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def cluster():
    state = Cluster()
    server = fx.serve_http(state.handler())
    state.url = f"http://127.0.0.1:{server.server_address[1]}"
    yield state
    server.shutdown()
    server.server_close()


def gpu_fleet():
    return [fx.make_node(n, allocatable={"nvidia.com/gpu": "8"}) for n in [HOST] + OTHERS]


def fresh_side(monkeypatch, checker):
    for cache in (checker._HISTORY_CACHE, checker._ANALYTICS_CACHE,
                  checker._REMEDIATION_CACHE):
        monkeypatch.setitem(cache, "key", None)
        monkeypatch.setitem(cache, "bundle" if "bundle" in cache else "tracker", None)
    checker.reset_client_cache()


def join_notify_threads():
    # The auth-failure Slack note is posted from a thread of its own.
    for t in threading.enumerate():
        if t.name == "tnc-auth-event-notify":
            t.join(timeout=10)


def run_deployment(side, cluster, tmp_path, monkeypatch, capsys):
    """The Deployment's loop on one side: what it returned, served, posted,
    PATCHed and logged."""
    cli, checker, notify, app = SIDES[side]
    work = tmp_path / side
    work.mkdir()
    fresh_side(monkeypatch, checker)
    cluster.reset(gpu_fleet())
    clock = Clock()
    monkeypatch.setattr(time, "time", clock)
    monkeypatch.setenv("TNC_SERVE_TOKEN", TOKEN)
    rec = {"rounds": [], "slack": [], "servers": [], "pre": None, "writes": None}

    init = app.FleetStateServer.__init__

    def recorded_init(self, *a, **k):
        init(self, *a, **k)
        rec["servers"].append(self)

    monkeypatch.setattr(app.FleetStateServer, "__init__", recorded_init)
    monkeypatch.setattr(notify, "send_slack_message",
                        lambda webhook, message, **kw: rec["slack"].append(message) or True)
    check = checker.run_check

    def run_check(args, **kw):
        n = len(rec["rounds"])
        if n == 0:
            port = rec["servers"][0].port
            rec["pre"] = [comparable(p, *request(port, "GET", p)) for p in ("/healthz", "/readyz")]
        write_reports(work / "reports", {HOST: PLAN[n], **dict.fromkeys(OTHERS, True)},
                      clock.t)
        return check(args, **kw)

    monkeypatch.setattr(checker, "run_check", run_check)

    def wait(stop, seconds):
        rec["rounds"].append(read_api(rec["servers"][0].port))
        if len(rec["rounds"]) == 1:
            rec["writes"] = write_burst(rec["servers"][0].port)
        clock.t += 1.0
        return len(rec["rounds"]) == len(PLAN)

    monkeypatch.setattr(checker, "_wait_for_next_round", wait)
    argv = [a.replace("{dir}", str(work)) for a in
            ["--kubeconfig", kubeconfig(work / "kc", cluster.url)] + DEPLOYMENT_ARGV]
    rec["rc"] = cli.main(argv)
    join_notify_threads()
    err = capsys.readouterr()[1]
    rec["err"] = [re.sub(r"port \d+", "port N", line.replace(str(work), "{dir}"))
                  for line in err.splitlines() if not line.startswith("{")]
    rec["slack"] = [re.sub(r"port \d+", "port N", m.rsplit("\n`trace: ", 1)[0])
                    for m in rec["slack"]]
    rec["patches"] = _patch_bodies(cluster.patches)
    rec["events"] = [{k: v for k, v in json.loads(line).items()
                      if k not in ("ts", "trace_id", "remote")}
                     for line in (work / "events.jsonl").read_text().splitlines()]
    return rec


def read_api(port):
    """Every route once, then the conditional, gzip and HEAD exchanges."""
    got = {p: request(port, "GET", p) for p in GETS}
    headers = got["/api/v1/summary"][1]
    cached = request(port, "GET", "/api/v1/summary", {"If-None-Match": headers["ETag"]})
    zipped = request(port, "GET", "/api/v1/nodes", {"Accept-Encoding": "gzip"})
    head = request(port, "HEAD", "/api/v1/nodes")
    return {
        "exchanges": {p: comparable(p, *r) for p, r in got.items()},
        "round": int(headers["X-TNC-Round"]),
        "304": (cached[0], cached[2], cached[1].get("ETag") == headers["ETag"]),
        "gzip": (zipped[1].get("Content-Encoding"),
                 gzip.decompress(zipped[2]) == got["/api/v1/nodes"][2]),
        "head": (head[0], head[2], head[1].get("Content-Length")
                 == str(len(got["/api/v1/nodes"][2]))),
    }


def write_burst(port):
    path = f"/api/v1/nodes/{HOST}/cordon?dry_run=1"
    out = [comparable(path, *request(port, "POST", path)),
           comparable(path, *request(port, "POST", path, {"Authorization": "Bearer wrong"}))]
    for _ in range(8):
        out.append(comparable(path, *request(port, "POST", path,
                                             {"Authorization": f"Bearer {TOKEN}"})))
    return out


@pytest.fixture(scope="module")
def deployment(cluster, tmp_path_factory):
    """Both sides' Deployment loops, run once for the module's tests."""
    tmp = tmp_path_factory.mktemp("deployment")
    capture = _Capture()
    got = {}
    try:
        for side in SIDES:
            mp = pytest.MonkeyPatch()
            for k in ("SLACK_WEBHOOK_URL", "KUBECONFIG", "NODE_NAME"):
                mp.delenv(k, raising=False)
            try:
                got[side] = run_deployment(side, cluster, tmp, mp, capture)
            finally:
                mp.undo()
    finally:
        capture.close()
    return got


class _Capture:
    """A module-scoped stand-in for ``capsys``: stdout and stderr into
    buffers, read and emptied by ``readouterr``."""

    def __init__(self):
        import io
        import sys

        self._sys, self._saved = sys, (sys.stdout, sys.stderr)
        self._out, self._err = io.StringIO(), io.StringIO()
        sys.stdout, sys.stderr = self._out, self._err

    def readouterr(self):
        out, err = self._out.getvalue(), self._err.getvalue()
        for buf in (self._out, self._err):
            buf.seek(0)
            buf.truncate()
        return out, err

    def close(self):
        self._sys.stdout, self._sys.stderr = self._saved


def test_exit_codes_posts_patches_and_events_equal_jax(deployment):
    jax, port = deployment["jax"], deployment["port"]
    assert port["rc"] == jax["rc"] == 143
    assert port["err"] == jax["err"]
    assert port["slack"] == jax["slack"]
    assert port["patches"] == jax["patches"]
    assert port["events"] == jax["events"]
    assert any("Serving fleet state API on port N (2 workers" in line for line in port["err"])
    assert port["slack"][0].endswith("*Fleet state API server-start*: fleet state API "
                                     "listening on port N (write endpoints token-gated)")
    kinds = [e["event"] for e in port["events"]]
    assert "analytics-prediction" in kinds and "fleet-api-write" in kinds


def test_readyz_goes_503_to_200(deployment):
    for side in SIDES:
        pre = deployment[side]["pre"]
        assert [status for status, _, _ in pre] == [200, 503]
        first = deployment[side]["rounds"][0]["exchanges"]
        assert first["/readyz"][0] == 200 and first["/healthz"][0] == 200
    assert deployment["port"]["pre"] == deployment["jax"]["pre"]


@pytest.mark.parametrize("path", GETS)
def test_every_route_every_round_equals_jax(deployment, path):
    got = {side: [r["exchanges"][path] for r in deployment[side]["rounds"]] for side in SIDES}
    assert got["port"] == got["jax"]
    assert len(got["port"]) == len(PLAN)


def test_rounds_move_forward_and_the_node_carries_the_round(deployment):
    rounds = deployment["port"]["rounds"]
    assert [r["round"] for r in rounds] == list(range(1, len(PLAN) + 1))
    for n, r in enumerate(rounds):
        _, headers, doc = r["exchanges"][f"/api/v1/nodes/{HOST}"]
        assert headers["X-TNC-Round"] == str(n + 1) and doc["round"] == n + 1
        assert doc["node"]["probe"]["ok"] is PLAN[n]
        assert doc["node"]["health"]["state"] in ("HEALTHY", "SUSPECT", "FAILED",
                                                  "RECOVERING", "CHRONIC")
        assert r["exchanges"]["/api/v1/nope"][0] == 404
        assert r["exchanges"]["/api/v1/nodes/nope"][0] == 404
    flaps = rounds[3]["exchanges"]["/api/v1/analytics/flaps"][2]
    assert [p["node"] for p in flaps["predictions"]] == [HOST]


def test_304_gzip_and_head_equal_jax(deployment):
    for side in SIDES:
        for r in deployment[side]["rounds"]:
            assert r["304"] == (304, b"", True)
            assert r["gzip"] == ("gzip", True)
            assert r["head"] == (200, b"", True)


def test_writes_401_then_5_answers_then_429_equal_jax(deployment):
    jax, port = deployment["jax"]["writes"], deployment["port"]["writes"]
    assert port == jax
    statuses = [status for status, _, _ in port]
    assert statuses[:2] == [401, 401]
    assert port[0][1]["WWW-Authenticate"] == "Bearer"
    assert 429 not in statuses[2:7] and statuses[7:] == [429, 429, 429]
    assert all(h["Retry-After"] == "1" for _, h, _ in port[7:])


def test_the_watch_feed_frames_equal_jax(deployment):
    path = "/api/v1/watch?since=&timeout=0"
    frames = [r["exchanges"][path][2] for r in deployment["port"]["rounds"]]
    assert all(f["kind"] == "resync" for f in frames)
    assert [f["rev"] for f in frames] == sorted(f["rev"] for f in frames)


# --------------------------------------------------------------------------
# Standalone serving over the recorded store
# --------------------------------------------------------------------------

STANDALONE_GETS = ["/readyz", "/healthz", "/api/v1/summary", "/api/v1/nodes",
                   f"/api/v1/nodes/{HOST}", "/api/v1/slices", "/api/v1/trend"]


def run_standalone(side, store, log, monkeypatch, capsys, token):
    cli, checker, _, app = SIDES[side]
    fresh_side(monkeypatch, checker)
    if token:
        monkeypatch.setenv("TNC_SERVE_TOKEN", token)
    else:
        monkeypatch.delenv("TNC_SERVE_TOKEN", raising=False)
    monkeypatch.setattr(time, "time", Clock())
    servers, got = [], {}
    init = app.FleetStateServer.__init__
    monkeypatch.setattr(app.FleetStateServer, "__init__",
                        lambda self, *a, **k: (init(self, *a, **k), servers.append(self))[0])

    def wait(stop, seconds):
        port = servers[0].port
        got["gets"] = {p: comparable(p, *request(port, "GET", p)) for p in STANDALONE_GETS}
        post = f"/api/v1/nodes/{HOST}/cordon"
        got["post"] = comparable(post, *request(port, "POST", post,
                                                {"Authorization": f"Bearer {token}"}))
        got["wait"] = seconds
        return True

    monkeypatch.setattr(checker, "_wait_for_next_round", wait)
    got["rc"] = cli.main(["--serve", "0", "--history", str(store), "--log-jsonl", str(log),
                          "--serve-workers", "2"])
    got["err"] = [masked(json.loads(line)) if line.startswith("{")
                  else re.sub(r"port \d+", "port N", line)
                  for line in capsys.readouterr().err.splitlines()]
    monkeypatch.undo()
    return got


@pytest.mark.parametrize("token", [TOKEN, None])
def test_serve_store_over_the_recorded_store_equals_jax(deployment, tmp_path_factory,
                                                        monkeypatch, capsys, token):
    # The port's store and trend log, as the loop above recorded them.
    store = next(tmp_path_factory.getbasetemp().glob("deployment*/port/history.jsonl"))
    log = store.parent / "rounds.jsonl"
    got = {side: run_standalone(side, store, log, monkeypatch, capsys, token) for side in SIDES}
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["rc"] == 143 and port["wait"] == 1.0
    assert port["gets"]["/readyz"][0] == 200
    assert port["gets"]["/api/v1/summary"][2]["total_nodes"] == 4
    # With a token a write passes the gate and meets no live round (503);
    # with none configured every write is refused outright (403).
    assert port["post"][0] == (503 if token else 403)
    assert port["err"][-1] == "SIGTERM: fleet state API stopped cleanly."


# --------------------------------------------------------------------------
# The CLI
# --------------------------------------------------------------------------

USAGE_EQUAL_JAX = [
    ["--nodes-json", "n", "--analytics", "d"],
    ["--nodes-json", "n", "--serve-token", "t"],
    ["--nodes-json", "n", "--serve-workers", "2"],
    ["--nodes-json", "n", "--write-rps", "5"],
    ["--watch", "5", "--serve", "0", "--serve-workers", "0"],
    ["--watch", "5", "--serve", "0", "--write-rps", "0"],
    ["--watch", "5", "--serve", "70000"],
    ["--emit-probe", "-", "--serve", "0"],
    ["--serve", "0"],
    ["--serve", "0", "--history", "h", "--probe"],
    ["--serve", "0", "--history", "h", "--analytics", "a"],
    ["--serve", "0", "--log-jsonl", "l", "--slack-webhook", "u"],
    ["--trend", "t", "--serve", "0"],
    ["--trend-nodes", "t", "--serve", "0"],
    ["--selftest", "--serve", "0"],
    ["--calibrate", "3", "--probe-level", "compute", "--serve", "0"],
    ["--report-fresh", "r", "--serve", "0"],
    ["--emit-probe", "-", "--history", "h", "--analytics", "d"],
]


def _usage(parse, argv, capsys):
    with pytest.raises(SystemExit) as exc:
        parse(argv)
    return exc.value.code, capsys.readouterr().err.strip().splitlines()[-1]


@pytest.mark.parametrize("argv", USAGE_EQUAL_JAX)
def test_usage_error_equals_jax(capsys, argv):
    port_code, port_err = _usage(port_cli.parse_args, argv, capsys)
    jax_code, jax_err = _usage(jax_cli.parse_args, argv, capsys)
    assert port_code == jax_code == 2
    assert port_err.split(": error: ")[1] == jax_err.split(": error: ")[1]


@pytest.mark.parametrize("argv", [
    ["--watch", "60", "--serve", "8080", "--serve-workers", "2", "--write-rps", "5",
     "--cordon-max", "3", "--history", "h", "--analytics", "a", "--event-log", "e"],
    ["--serve", "8080", "--history", "h", "--log-jsonl", "l", "--serve-token", "t",
     "--event-log", "e", "--cordon-max", "2"],
])
def test_serve_argv_parses_as_jax_parses_it(argv):
    port, jax = port_cli.parse_args(argv), jax_cli.parse_args(argv)
    for dest, value in vars(port).items():
        if hasattr(jax, dest):
            assert value == getattr(jax, dest), dest


@pytest.mark.parametrize("flag", [
    ["--federate", "e.json"], ["--federate-feed"], ["--federate-interval", "5"],
    ["--federate-workers", "2"], ["--fleet-disruption-budget", "2"], ["--watch-stream"],
    ["--no-watch-stream"],
])
def test_unported_flags_stay_unknown(capsys, flag):
    # Once unknown arguments; now ported, each beside the served loop gives
    # JAX's usage error or JAX's values (--watch-stream rides the loop).
    port_args = port_cli.parse_args
    argv = ["--watch", "5", "--serve", "0", *flag]
    try:
        jax_args = jax_cli.parse_args(argv)
    except SystemExit:
        _, jax_err = _usage(jax_cli.parse_args, argv, capsys)
        port_code, port_err = _usage(port_args, argv, capsys)
        assert port_code == 2
        assert port_err.split(": error: ")[1] == jax_err.split(": error: ")[1]
    else:
        assert vars(port_args(argv)).items() >= {
            k: v for k, v in vars(jax_args).items() if k != "device"}.items()


@pytest.mark.parametrize("flag", ["--serve", "--serve-token", "--serve-workers", "--write-rps",
                                  "--analytics"])
def test_flag_help_equals_jax(flag):
    def action(parser):
        return next(a for a in parser._actions if flag in a.option_strings)

    port, ref = action(port_cli.build_parser()), action(jax_cli.build_parser())
    assert (port.type, port.metavar, port.nargs, port.default, port.help) == \
        (ref.type, ref.metavar, ref.nargs, ref.default, ref.help)


def test_serve_without_watch_dispatches_to_serve_store(monkeypatch):
    calls = []
    monkeypatch.setattr(port_checker, "serve_store", lambda args: calls.append(args) or 143)
    assert port_cli.main(["--serve", "0", "--history", "h"]) == 143
    assert calls[0].serve == 0 and calls[0].history == "h"
