"""The port's ``--history`` and Slack paths, held against the JAX checker's.

* ``HealthFSM`` and ``HistoryStore``: hypothesis-drawn verdict sequences
  (good, bad, no evidence, degraded, an out-of-band uncordon) under drawn
  ``--cordon-after``, ``--uncordon-after``, ``--flap-threshold`` and
  ``--flap-window`` values go through both packages' machines; every
  return value, state, streak, flap count and transition must be equal,
  and so must the store files, which each package loads from the other.
* The one-shot round with ``--history`` over five rounds of reports
  (healthy, failing, failing, healthy, failing): exit codes, payloads (``trace_id`` and
  ``timings_ms`` dropped) and the store lines (``ts`` dropped) equal.
* The emitter with ``--history``: the port's ``--emit-probe`` rounds on the
  CPU, failed by a ``TNC_CHAOS_*`` variable the enumerate level never runs,
  carry JAX's ``state`` and ``flaps`` for the same ok/fail sequence.
* Slack: ``format_slack_message`` (with the history lines),
  ``should_send_slack_message`` over its inputs, ``send_slack_message``'s
  retries through its ``post`` and ``sleep`` seams, the posted body of
  both CLIs to a loopback webhook under ``--slack-only-on-error``, and both
  CLIs against a malformed URL and a webhook that hangs up: the same exit
  codes, attempts and delivery lines.

Tolerance: exact equality everywhere.  torch and the port are reached
through ``importlib.import_module``: tests/test_dependency_surface.py
rejects any other ``import`` in tests/.
"""

import argparse
import importlib
import itertools
import json
import os
import socketserver
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import requests
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tests import fixtures as fx
from tpu_node_checker import checker as jax_checker
from tpu_node_checker import cli as jax_cli
from tpu_node_checker import notify as jax_notify
from tpu_node_checker import report as jax_report
from tpu_node_checker.detect import group_multislices as jax_group_multislices
from tpu_node_checker.detect import group_slices as jax_group_slices
from tpu_node_checker.detect import select_accelerator_nodes as jax_select
from tpu_node_checker.history import fsm as jax_fsm
from tpu_node_checker.history import store as jax_store

port_cli = importlib.import_module("tpu_node_checker_torch.cli")
port_checker = importlib.import_module("tpu_node_checker_torch.checker")
port_emit = importlib.import_module("tpu_node_checker_torch.emit")
port_fsm = importlib.import_module("tpu_node_checker_torch.history.fsm")
port_store = importlib.import_module("tpu_node_checker_torch.history.store")
port_notify = importlib.import_module("tpu_node_checker_torch.notify")
port_report = importlib.import_module("tpu_node_checker_torch.report")
port_detect = importlib.import_module("tpu_node_checker_torch.detect")

NODES = ("node-a", "node-b", "node-c")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    for k in [k for k in os.environ if k.startswith("TNC_") or k == "SLACK_WEBHOOK_URL"]:
        monkeypatch.delenv(k)
    monkeypatch.setitem(jax_checker._HISTORY_CACHE, "key", None)
    monkeypatch.setitem(port_checker._HISTORY_CACHE, "key", None)


def _health(fsm, node):
    h = fsm.nodes[node]
    return (h.state, h.streak, h.flaps, h.flaps_total, list(h.verdicts))


thresholds = st.fixed_dictionaries({
    "cordon_after": st.integers(1, 4),
    "uncordon_after": st.integers(1, 4),
    "flap_threshold": st.integers(2, 6),
    "flap_window": st.integers(2, 12),
})
verdict = st.sampled_from([True, False, None, "degraded"])
# (node, verdict, uncordoned out of band: one step in six)
step = st.tuples(st.sampled_from(NODES), verdict, st.integers(0, 5).map(lambda i: i == 0))


class TestMachine:
    @settings(max_examples=80, deadline=None,
              suppress_health_check=[HealthCheck.too_slow])
    @given(knobs=thresholds, steps=st.lists(step, max_size=40))
    def test_fsm_equals_jax(self, knobs, steps):
        ref, port = jax_fsm.HealthFSM(**knobs), port_fsm.HealthFSM(**knobs)
        for node, ok, out_of_band in steps:
            ok = {"degraded": jax_fsm.DEGRADED}.get(ok, ok)
            assert port.observe(node, ok, uncordoned_out_of_band=out_of_band) == \
                ref.observe(node, ok, uncordoned_out_of_band=out_of_band)
            assert port.transitions == ref.transitions
            assert sorted(port.nodes) == sorted(ref.nodes)
            for n in ref.nodes:
                assert _health(port, n) == _health(ref, n)
                assert port.uncordon_eligible(n) == ref.uncordon_eligible(n)
                assert port.cordon_eligible(n) == ref.cordon_eligible(n)
        assert port.state_counts() == ref.state_counts()

    @settings(max_examples=40, deadline=None,
              suppress_health_check=[HealthCheck.too_slow])
    @given(knobs=thresholds, max_rounds=st.integers(1, 20),
           steps=st.lists(step, max_size=60))
    def test_store_equals_jax_and_each_loads_the_other(self, knobs, max_rounds, steps):
        with tempfile.TemporaryDirectory() as d:
            paths = {side: os.path.join(d, f"{side}.jsonl") for side in ("jax", "port")}
            machines = {"jax": (jax_fsm.HealthFSM(**knobs),
                                jax_store.HistoryStore(paths["jax"], max_rounds)),
                        "port": (port_fsm.HealthFSM(**knobs),
                                 port_store.HistoryStore(paths["port"], max_rounds))}
            for i, (node, ok, _) in enumerate(steps):
                for fsm, store in machines.values():
                    fsm.observe(node, ok if ok != "degraded" else jax_fsm.DEGRADED)
                    h = fsm.health(node)
                    store.record({"node": node, "ts": float(i), "ok": ok, "causes": [],
                                  "state": h.state, "streak": h.streak, "flaps": h.flaps,
                                  "flaps_total": h.flaps_total})
                    if i % 7 == 6:
                        store.flush()
            for _, store in machines.values():
                store.flush()
            texts = {side: open(p).read() if os.path.exists(p) else "" for side, p in
                     paths.items()}
            assert texts["port"] == texts["jax"]
            # Each package reads the other's file, and seeds equal machines.
            by_jax = jax_store.HistoryStore(paths["port"], max_rounds).load()
            by_port = port_store.HistoryStore(paths["jax"], max_rounds).load()
            assert by_port == by_jax
            seeded = [jax_fsm.HealthFSM(**knobs), port_fsm.HealthFSM(**knobs)]
            for node, entries in by_jax.items():
                seeded[0].seed(node, entries)
                seeded[1].seed(node, entries)
            for node in by_jax:
                assert _health(seeded[1], node) == _health(seeded[0], node)

    def test_defaults_equal_jax(self):
        for name in ("DEFAULT_CORDON_AFTER", "DEFAULT_UNCORDON_AFTER",
                     "DEFAULT_FLAP_THRESHOLD", "DEFAULT_FLAP_WINDOW", "STATES", "DEGRADED"):
            assert getattr(port_fsm, name) == getattr(jax_fsm, name), name
        assert port_store.DEFAULT_MAX_ROUNDS == jax_store.DEFAULT_MAX_ROUNDS
        assert port_store.HISTORY_SCHEMA_VERSION == jax_store.HISTORY_SCHEMA_VERSION


# --- the one-shot round and the emitter with --history ---

@pytest.fixture(scope="module")
def emitted(tmp_path_factory):
    """A healthy and a failing report of the port's emitter on the CPU."""
    out = tmp_path_factory.mktemp("emitted")
    docs = {}
    with pytest.MonkeyPatch.context() as mp:
        for k in [k for k in os.environ if k.startswith("TNC_")]:
            mp.delenv(k)
        for name, env in (("healthy", {}), ("failing", {"TNC_CHAOS_AXIS": "t1"})):
            for k, v in env.items():
                mp.setenv(k, v)
            path = out / f"{name}.json"
            port_emit.emit_probe_once(str(path), level="enumerate", timeout_s=120, device="cpu")
            for k in env:
                mp.delenv(k)
            docs[name] = json.loads(path.read_text())
    assert docs["healthy"]["ok"] is True and docs["failing"]["ok"] is False
    return docs


def _drop(doc, keys):
    return {k: v for k, v in doc.items() if k not in keys}


def _store_lines(path):
    return [_drop(json.loads(x), ("ts",)) for x in open(path).read().splitlines()]


class TestOneShotHistory:
    @pytest.mark.parametrize("knobs", [
        ["--cordon-after", "2"],
        ["--cordon-after", "1", "--flap-threshold", "2", "--flap-window", "3"],
        ["--uncordon-after", "2", "--history-max-rounds", "12"],
    ])
    def test_rounds_equal_jax(self, tmp_path, capsys, emitted, knobs):
        nodes = tmp_path / "nodes.json"
        nodes.write_text(json.dumps(fx.node_list(fx.gpu_pool(2) + fx.tpu_v5e_single_host())))
        reports = tmp_path / "reports"
        reports.mkdir()
        seq = ["healthy", "failing", "failing", "healthy", "failing"]
        payloads = {"jax": [], "port": []}
        codes = {"jax": [], "port": []}
        for kind in seq:
            doc = {**emitted[kind], "hostname": "gke-gpu-pool-0", "written_at": time.time()}
            (reports / "gke-gpu-pool-0.json").write_text(json.dumps(doc))
            for side, main, checker in (("jax", jax_cli.main, jax_checker),
                                        ("port", port_cli.main, port_checker)):
                # One process per round, as a CronJob runs it.
                checker._HISTORY_CACHE["key"] = None
                rc = main(["--nodes-json", str(nodes), "--probe-results", str(reports),
                           "--probe-results-required", "--history",
                           str(tmp_path / f"{side}.jsonl"), "--json", *knobs])
                codes[side].append(rc)
                payloads[side].append(_drop(json.loads(capsys.readouterr().out),
                                            ("trace_id", "timings_ms")))
        assert codes["port"] == codes["jax"]
        assert payloads["port"] == payloads["jax"]
        assert _store_lines(tmp_path / "port.jsonl") == _store_lines(tmp_path / "jax.jsonl")
        states = [next(n for n in p["nodes"] if n["name"] == "gke-gpu-pool-0")["health"]["state"]
                  for p in payloads["port"]]
        if knobs == ["--cordon-after", "2"]:
            assert states == ["HEALTHY", "SUSPECT", "FAILED", "HEALTHY", "SUSPECT"]

    def test_text_output_with_history_equals_jax(self, tmp_path, capsys, emitted):
        nodes = tmp_path / "nodes.json"
        nodes.write_text(json.dumps(fx.node_list(fx.gpu_pool(1))))
        reports = tmp_path / "reports"
        reports.mkdir()
        doc = {**emitted["failing"], "hostname": "gke-gpu-pool-0", "written_at": time.time()}
        (reports / "gke-gpu-pool-0.json").write_text(json.dumps(doc))
        outs = {}
        for side, main in (("jax", jax_cli.main), ("port", port_cli.main)):
            rc = main(["--nodes-json", str(nodes), "--probe-results", str(reports),
                       "--history", str(tmp_path / f"{side}.jsonl")])
            outs[side] = (rc, capsys.readouterr().out)
        assert outs["port"] == outs["jax"] and outs["port"][0] == 3


class TestEmitterHistory:
    def test_round_log_carries_jax_state_and_flaps(self, tmp_path, capsys, monkeypatch):
        # The port's emitter, one process per round as a CronJob would run
        # it; a round fails through a chaos variable the enumerate level
        # never runs.
        history, log = tmp_path / "port.jsonl", tmp_path / "rounds.jsonl"
        monkeypatch.setenv("NODE_NAME", "gke-gpu-pool-0")
        docs = []
        for ok in (True, False, False, True, False):
            port_checker._HISTORY_CACHE["key"] = None
            if ok:
                monkeypatch.delenv("TNC_CHAOS_THROTTLE", raising=False)
            else:
                monkeypatch.setenv("TNC_CHAOS_THROTTLE", "hbm_gbps")
            report = tmp_path / "r.json"
            rc = port_cli.main(["--emit-probe", str(report), "--device", "cpu", "--history",
                                str(history), "--log-jsonl", str(log), "--cordon-after", "2",
                                "--flap-threshold", "3", "--flap-window", "6"])
            assert rc == (0 if ok else 3)
            docs.append(json.loads(report.read_text()))
        capsys.readouterr()
        entries = [json.loads(x) for x in log.read_text().splitlines()]

        # JAX's emitter over the same reports, through its own tracker.
        args = argparse.Namespace(history=str(tmp_path / "jax.jsonl"), cordon_after=2,
                                  flap_threshold=3, flap_window=6, history_max_rounds=None,
                                  uncordon_after=None)
        ref = []
        for doc in docs:
            jax_checker._HISTORY_CACHE["key"] = None
            rc = 0 if doc["ok"] else 3
            entry = jax_checker._emitter_round_entry(rc, doc)
            jax_checker._emitter_history_round(jax_checker._build_history(args), doc, entry)
            ref.append(entry)
        strip = ("ts",)
        assert [_drop(e, strip) for e in entries] == [_drop(e, strip) for e in ref]
        assert [e["state"] for e in entries] == ["HEALTHY", "SUSPECT", "FAILED", "HEALTHY",
                                                 "CHRONIC"]
        assert [e.get("flaps") for e in entries] == [None, 1, 1, 2, 3]
        assert _store_lines(history) == _store_lines(tmp_path / "jax.jsonl")

    def test_loop_keeps_one_tracker(self, tmp_path, monkeypatch):
        # The --watch loop: one tracker for the loop's lifetime, so the
        # second bad round reaches FAILED without reseeding from disk.
        liveness = importlib.import_module("tpu_node_checker_torch.probe.liveness")
        results = [True, False, False, True]
        calls = []

        def fake_probe(**kw):
            ok = results[len(calls)]
            calls.append(kw)
            return liveness.ProbeResult(ok=ok, level="enumerate", device_count=1,
                                        platform="cpu", hostname="gke-gpu-pool-0",
                                        elapsed_ms=1.0, error=None if ok else "drill")

        monkeypatch.setattr(port_emit, "run_local_probe", fake_probe)
        monkeypatch.setattr(port_emit, "_wait_for_next_round",
                            lambda stop, s: len(calls) >= len(results))
        log = tmp_path / "rounds.jsonl"
        rc = port_cli.main(["--emit-probe", str(tmp_path / "r.json"), "--watch", "5",
                            "--log-jsonl", str(log), "--history", str(tmp_path / "h.jsonl"),
                            "--cordon-after", "2"])
        entries = [json.loads(x) for x in log.read_text().splitlines()]
        assert rc == 143
        assert [e["state"] for e in entries] == ["HEALTHY", "SUSPECT", "FAILED", "HEALTHY"]
        assert len(_store_lines(tmp_path / "h.jsonl")) == 4


# --- Slack ---

SLACK_NODE_LISTS = {
    "gpu_pool": fx.gpu_pool,
    "gpu_pool not ready": lambda: fx.gpu_pool(2, ready=False),
    "cpu_only_cluster": fx.cpu_only_cluster,
    "tpu_v5p_64_slice not_ready=1": lambda: fx.tpu_v5p_64_slice(not_ready=1),
    "tpu_multislice not_ready=1": lambda: fx.tpu_multislice(not_ready=1),
    "mixed_cluster_one_notready": fx.mixed_cluster_one_notready,
    "big_mixed_cluster": lambda: fx.big_mixed_cluster(cpu=50, gpu=60, tpu_slices=1),
}


class TestSlack:
    @pytest.mark.parametrize("healthy", [None, True, False])
    @pytest.mark.parametrize("name", list(SLACK_NODE_LISTS))
    def test_format_slack_message_equals_jax(self, name, healthy):
        items = SLACK_NODE_LISTS[name]()
        msgs = []
        for select, group, report, ms in (
            (jax_select, jax_group_slices, jax_report, jax_group_multislices),
            (port_detect.select_accelerator_nodes, port_detect.group_slices, port_report,
             port_detect.group_multislices),
        ):
            accel, ready = select(items)
            slices = group(accel)
            msgs.append(report.format_slack_message(
                accel, [n for n in ready if n.effectively_ready], slices, healthy=healthy,
                multislices=ms(slices, ())))
        assert msgs[1] == msgs[0]

    def test_history_lines_equal_jax(self, tmp_path, capsys, emitted):
        # Through both rounds: a chronic flapper, a FAILED node and the
        # transitions, as the message renders them.
        nodes = tmp_path / "nodes.json"
        nodes.write_text(json.dumps(fx.node_list(fx.gpu_pool(2))))
        reports = tmp_path / "reports"
        reports.mkdir()
        results = {"jax": [], "port": []}
        for i, kind in enumerate(["healthy", "failing", "healthy", "failing"]):
            for host in ("gke-gpu-pool-0", "gke-gpu-pool-1"):
                which = kind if host.endswith("0") else "failing"
                doc = {**emitted[which], "hostname": host, "written_at": time.time()}
                (reports / f"{host}.json").write_text(json.dumps(doc))
            for side, checker in (("jax", jax_checker), ("port", port_checker)):
                checker._HISTORY_CACHE["key"] = None
                args = (jax_cli if side == "jax" else port_cli).parse_args([
                    "--nodes-json", str(nodes), "--probe-results", str(reports), "--history",
                    str(tmp_path / f"{side}.jsonl"), "--flap-threshold", "2",
                    "--flap-window", "4"])
                result = checker.run_check(args)
                report = jax_report if side == "jax" else port_report
                results[side].append(report.format_slack_message(
                    result.accel, result.ready, result.slices,
                    healthy=result.exit_code == 0, multislices=result.multislices,
                    history=result.payload.get("history")))
        assert results["port"] == results["jax"]
        assert any("CHRONIC" in m or "chronic" in m for m in results["port"])

    @pytest.mark.parametrize("url,only_on_error,healthy,transitions", list(itertools.product(
        [None, "", "https://hooks.slack.example/x"], [False, True], [False, True],
        [False, True])))
    def test_should_send_equals_jax(self, url, only_on_error, healthy, transitions):
        assert port_notify.should_send_slack_message(url, only_on_error, healthy, transitions) \
            == jax_notify.should_send_slack_message(url, only_on_error, healthy, transitions)

    def test_webhook_url_flag_beats_env(self, monkeypatch):
        monkeypatch.setenv("SLACK_WEBHOOK_URL", "https://env.example")
        for mod in (port_notify, jax_notify):
            assert mod.get_slack_webhook_url("https://flag.example") == "https://flag.example"
            assert mod.get_slack_webhook_url(None) == "https://env.example"

    SCRIPTS = {
        "200": [200],
        "500 then 200": [500, 200],
        "500 exhausts": [500, 500, 500, 500],
        "reset then 200": [requests.exceptions.ConnectionError("Connection reset by peer"), 200],
        "aborted then 200": [requests.exceptions.ConnectionError(
            "('Connection aborted.', RemoteDisconnected())"), 200],
        "reset exhausts": [requests.exceptions.ConnectionError("Connection reset by peer")] * 4,
        "other connection error": [requests.exceptions.ConnectionError("Name not known")],
        "timeout": [requests.exceptions.Timeout("read timed out")],
        "invalid url": [requests.exceptions.InvalidURL("bad url")],
    }

    @pytest.mark.parametrize("trace_id", [None, "0a1b2c3d00000001"])
    @pytest.mark.parametrize("script", list(SCRIPTS))
    def test_send_retries_through_the_seams_as_jax(self, script, trace_id):
        runs = []
        for mod in (jax_notify, port_notify):
            queue, posts, sleeps = list(self.SCRIPTS[script]), [], []

            def post(url, json=None, timeout=None):
                posts.append((url, json, timeout))
                action = queue.pop(0)
                if isinstance(action, Exception):
                    raise action
                return type("Resp", (), {"status_code": action})()

            sent = mod.send_slack_message("https://hooks.slack.example/x", "m", username="u",
                                          retry_delay=7.5, post=post, sleep=sleeps.append,
                                          trace_id=trace_id)
            runs.append((sent, posts, sleeps))
        assert runs[1] == runs[0]

    def test_defaults_equal_jax(self):
        for name in ("DEFAULT_USERNAME", "DEFAULT_ICON", "DEFAULT_TIMEOUT_S",
                     "DEFAULT_MAX_RETRIES", "DEFAULT_RETRY_DELAY_S", "_RETRYABLE_FRAGMENTS"):
            assert getattr(port_notify, name) == getattr(jax_notify, name), name


class _Webhook(BaseHTTPRequestHandler):
    posts: list = []
    status = 200

    def do_POST(self):  # noqa: N802 — the handler's protocol name
        body = self.rfile.read(int(self.headers.get("Content-Length") or 0))
        type(self).posts.append((self.headers.get("Content-Type"), body))
        self.send_response(type(self).status)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def log_message(self, *args):
        pass


class _Hangup(socketserver.BaseRequestHandler):
    """Reads one request and closes the connection without a reply."""

    def handle(self):
        with self.request.makefile("rb") as f:
            length = 0
            for line in iter(f.readline, b""):
                if line in (b"\r\n", b"\n"):
                    break
                if line.lower().startswith(b"content-length:"):
                    length = int(line.split(b":", 1)[1])
            f.read(length)
        self.server.hangups += 1


@pytest.fixture
def hangup_webhook():
    server = socketserver.TCPServer(("127.0.0.1", 0), _Hangup)
    server.hangups = 0
    thread = threading.Thread(target=server.serve_forever, name="slack-hangup-stub",
                              daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}/hook", server
    finally:
        server.shutdown()
        server.server_close()
        thread.join()


def _slack_lines(err: str) -> list:
    return [line for line in err.splitlines() if line.startswith("Slack")]


@pytest.fixture
def webhook():
    handler = type("Webhook", (_Webhook,), {"posts": []})
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, name="slack-webhook-stub",
                              daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}/hook", handler
    finally:
        server.shutdown()
        server.server_close()
        thread.join()


class TestWebhookEndToEnd:
    def test_only_on_error_posts_once_and_the_body_equals_jax(self, tmp_path, capsys,
                                                              webhook):
        url, handler = webhook
        healthy = tmp_path / "healthy.json"
        healthy.write_text(json.dumps(fx.node_list(fx.gpu_pool(2))))
        sick = tmp_path / "sick.json"
        sick.write_text(json.dumps(fx.node_list(fx.gpu_pool(2, ready=False))))
        bodies = {}
        for side, main in (("jax", jax_cli.main), ("port", port_cli.main)):
            start = len(handler.posts)
            codes = [main(["--nodes-json", str(path), "--slack-webhook", url,
                           "--slack-only-on-error", "--slack-username", "fleet"])
                     for path in (healthy, sick)]
            out = capsys.readouterr().out
            assert codes == [0, 3]
            assert out.count("Slack notification sent.") == 1
            (post,) = handler.posts[start:]
            assert post[0] == "application/json"
            bodies[side] = json.loads(post[1])
        for body in bodies.values():
            text, trace = body["text"].rsplit("\n`trace: ", 1)
            body["text"] = text
            assert trace.endswith("`")
        assert bodies["port"] == bodies["jax"]
        assert bodies["port"]["username"] == "fleet"

    def test_a_failing_webhook_never_fails_the_round(self, tmp_path, capsys, webhook):
        url, handler = webhook
        handler.status = 500
        nodes = tmp_path / "nodes.json"
        nodes.write_text(json.dumps(fx.node_list(fx.gpu_pool(1))))
        rc = port_cli.main(["--nodes-json", str(nodes), "--slack-webhook", url,
                            "--slack-retry-count", "1", "--json"])
        out, err = capsys.readouterr()
        assert rc == 0 and json.loads(out)["exit_code"] == 0
        assert len(handler.posts) == 2
        assert "Slack delivery failed after 2 attempts." in err

    @pytest.mark.parametrize("url", ["hooks.slack.example/hook", "http://127.0.0.1:port/hook"])
    def test_a_malformed_url_fails_delivery_as_jax(self, tmp_path, capsys, url):
        # Neither URL opens a connection; the delivery fails at once and the
        # round keeps its own exit code and prints its payload.
        nodes = tmp_path / "nodes.json"
        nodes.write_text(json.dumps(fx.node_list(fx.gpu_pool(1))))
        runs = {}
        for side, main in (("jax", jax_cli.main), ("port", port_cli.main)):
            rc = main(["--nodes-json", str(nodes), "--slack-webhook", url, "--json"])
            out, err = capsys.readouterr()
            runs[side] = (rc, json.loads(out)["exit_code"], _slack_lines(err))
        assert runs["port"] == runs["jax"]
        assert runs["port"][:2] == (0, 0)
        (line,) = runs["port"][2]
        assert line.startswith("Slack delivery failed: ")

    def test_a_hangup_is_retried_as_jax(self, tmp_path, capsys, hangup_webhook):
        # A webhook that closes the connection without replying: requests
        # reads it as "Connection aborted", so both packages retry it.
        url, server = hangup_webhook
        nodes = tmp_path / "nodes.json"
        nodes.write_text(json.dumps(fx.node_list(fx.gpu_pool(2, ready=False))))
        runs = {}
        for side, main in (("jax", jax_cli.main), ("port", port_cli.main)):
            start = server.hangups
            rc = main(["--nodes-json", str(nodes), "--slack-webhook", url,
                       "--slack-retry-count", "2", "--slack-retry-delay", "0", "--json"])
            out, err = capsys.readouterr()
            lines = [line.split(":", 1)[0] for line in _slack_lines(err)]
            runs[side] = (rc, json.loads(out)["exit_code"], server.hangups - start, lines)
        assert runs["port"] == runs["jax"]
        assert runs["port"][:3] == (3, 3, 3)
        assert runs["port"][3][-1] == "Slack delivery failed after 3 attempts."
