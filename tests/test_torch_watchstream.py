"""The port's ``--watch-stream`` engine, held against the JAX package's.

The port's ``watchstream.py`` is a verbatim copy
(``tests/test_torch_copies.py``).  Here it runs: the same cases as
``tests/test_watchstream.py`` with the port's modules (the grading view,
the node cache, the watch transport of the port's ``cluster.py``, the
engine's ticks, its incremental slices, the evidence semantics of a silent
stream, the ``--watch`` loop's stream branch and the CLI's rules), then the
port's and the JAX ``StreamRoundEngine`` on one scripted stream (equal
payloads tick by tick, less the masks named in ``MASKED_KEYS``, and equal
``watch_stream`` stats), and the two CLIs' flag surfaces.

One fake API server speaks both halves of the watch protocol for the whole
module (``tests/fixtures.py`` ``watch_nodelist_handler``); each case gets a
fresh ``WatchScript`` by swapping the handler the server builds for each
new connection.  The one case that kills the server makes its own.  Waits
on the real stream are bounded polls, marked as such; nothing sleeps for
pacing.

The port is reached through ``importlib.import_module``:
tests/test_dependency_surface.py rejects any other ``import`` in tests/.
"""

import importlib
import json
import os
import time

import pytest

from tests import fixtures as fx
from tpu_node_checker import checker as jax_checker
from tpu_node_checker import cli as jax_cli
from tpu_node_checker import watchstream as jax_watchstream

port_checker = importlib.import_module("tpu_node_checker_torch.checker")
port_cli = importlib.import_module("tpu_node_checker_torch.cli")
port_cluster = importlib.import_module("tpu_node_checker_torch.cluster")
port_detect = importlib.import_module("tpu_node_checker_torch.detect")
port_fastpath = importlib.import_module("tpu_node_checker_torch.fastpath")
port_watchstream = importlib.import_module("tpu_node_checker_torch.watchstream")

NodeCache = port_watchstream.NodeCache
StreamRoundEngine = port_watchstream.StreamRoundEngine
grading_view = port_watchstream.grading_view

WALL_CLOCK_BUDGET_S = 30.0
# The masks between the two engines' payloads: a tick's trace id is random,
# its timings are wall times, and so is the stream's age.
MASKED_KEYS = ("trace_id", "timings_ms", "stream_age_seconds")
SIDES = {"port": (port_cli, port_checker, port_watchstream),
         "jax": (jax_cli, jax_checker, jax_watchstream)}


@pytest.fixture(autouse=True)
def _wall_clock_guard():
    t0 = time.perf_counter()
    yield
    elapsed = time.perf_counter() - t0
    assert elapsed < WALL_CLOCK_BUDGET_S, (
        f"watch-stream test burned {elapsed:.1f}s of wall-clock — a stream "
        "wait leaked past its bound"
    )


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    for k in [k for k in os.environ if k.startswith(("TNC_", "KUBERNETES_SERVICE_"))
              or k in ("SLACK_WEBHOOK_URL", "KUBECONFIG", "NODE_NAME")]:
        monkeypatch.delenv(k)
    for checker in (jax_checker, port_checker):
        monkeypatch.setitem(checker._HISTORY_CACHE, "key", None)
        checker.reset_client_cache()
    yield
    for checker in (jax_checker, port_checker):
        checker.reset_client_cache()


def _kubeconfig(path, port) -> str:
    path.write_text(
        "apiVersion: v1\nkind: Config\ncurrent-context: t\n"
        "contexts:\n- name: t\n  context:\n    cluster: t\n    user: t\n"
        f"clusters:\n- name: t\n  cluster:\n    server: http://127.0.0.1:{port}\n"
        "users:\n- name: t\n  user:\n    token: test-token\n")
    return str(path)


def _tpu_node(name, ready=True):
    return fx.make_node(
        name, ready=ready, allocatable={"google.com/tpu": "4"},
        labels={"cloud.google.com/gke-tpu-accelerator": "tpu-v5-lite-podslice",
                "cloud.google.com/gke-tpu-topology": "2x2",
                "cloud.google.com/gke-nodepool": "ws-pool"},
        taints=[fx.TPU_TAINT])


def _wait(predicate, timeout=5.0, what="stream delivery"):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if predicate():
            return
        time.sleep(0.01)  # tnc: allow-test-wall-clock(bounded poll for a REAL watch socket to deliver frames to the reader thread; no clock to fake in the TCP stack)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture(scope="module")
def api_server(tmp_path_factory):
    """The module's fake API server: its handler (and so its script) is
    swapped for each case; connections already open keep theirs."""
    nodes = [_tpu_node(f"ws-{i}") for i in range(4)]
    script = fx.WatchScript([{"live": True}])
    server = fx.serve_http(fx.watch_nodelist_handler(nodes, script, resource_version="100"))
    kubeconfig = _kubeconfig(tmp_path_factory.mktemp("kube") / "kubeconfig",
                             server.server_address[1])
    yield server, kubeconfig
    script.close()
    server.shutdown()
    server.server_close()


def _fresh_world(server, kubeconfig, side="port"):
    nodes = [_tpu_node(f"ws-{i}") for i in range(4)]
    script = fx.WatchScript([{"live": True}])
    list_requests: list = []
    server.RequestHandlerClass = fx.watch_nodelist_handler(
        nodes, script, resource_version="100", list_requests=list_requests)
    cli, _, watchstream = SIDES[side]
    engines = []

    def make_engine(*extra):
        args = cli.parse_args(["--kubeconfig", kubeconfig, "--watch", "5", "--watch-stream",
                               "--json", *extra])
        engine = watchstream.StreamRoundEngine(args)
        engines.append(engine)
        return engine

    return {"nodes": nodes, "script": script, "server": server, "kubeconfig": kubeconfig,
            "list_requests": list_requests, "make_engine": make_engine, "engines": engines}


def _close_world(world):
    for engine in world["engines"]:
        engine.close()
    world["script"].close()


@pytest.fixture
def stream_world(api_server):
    world = _fresh_world(*api_server)
    try:
        yield world
    finally:
        _close_world(world)


@pytest.fixture
def own_server_world(tmp_path):
    """A server of its own, for the case that kills it."""
    nodes = [_tpu_node(f"ws-{i}") for i in range(4)]
    script = fx.WatchScript([{"live": True}])
    server = fx.serve_http(fx.watch_nodelist_handler(nodes, script, resource_version="100"))
    world = _fresh_world(server, _kubeconfig(tmp_path / "kubeconfig", server.server_address[1]))
    world["script"] = script
    server.RequestHandlerClass = fx.watch_nodelist_handler(nodes, script, resource_version="100")
    try:
        yield world
    finally:
        _close_world(world)
        server.shutdown()
        server.server_close()


class TestGradingView:
    def test_heartbeat_only_change_is_invisible(self):
        a = _tpu_node("n1")
        b = json.loads(json.dumps(a))
        b["status"]["conditions"][1]["lastHeartbeatTime"] = "2026-08-03T00:00:00Z"
        b["metadata"]["resourceVersion"] = "999"
        assert grading_view(a) == grading_view(b)

    @pytest.mark.parametrize("mutate", [
        lambda n: n["status"]["conditions"][1].update(status="False"),
        lambda n: n["metadata"]["labels"].update(extra="x"),
        lambda n: n["spec"].update(unschedulable=True),
        lambda n: n["status"]["allocatable"].update({"google.com/tpu": "0"}),
        lambda n: n["status"]["conditions"][1].update(reason="KubeletNotReady"),
    ])
    def test_grading_input_changes_are_visible(self, mutate):
        a = _tpu_node("n1")
        b = json.loads(json.dumps(a))
        mutate(b)
        assert grading_view(a) != grading_view(b)
        assert grading_view(b) == jax_watchstream.grading_view(b)


def _projected(nodes, rv):
    class _Resp:
        content = json.dumps({"items": nodes}).encode()

    projector = port_fastpath.ListProjector()
    items, _meta = projector.decode_page(_Resp(), 0)
    return port_fastpath.ProjectedFleet(items, rv, projector.reuse)


class TestNodeCache:
    def test_seed_then_reseed_diffs(self):
        cache = NodeCache()
        cache.seed([_tpu_node("a"), _tpu_node("b")], "1")
        changed, removed = cache.drain()
        assert set(changed) == {"a", "b"} and not removed
        cache.seed([_tpu_node("a"), _tpu_node("b")], "2")
        changed, removed = cache.drain()
        assert not changed and not removed
        assert cache.resource_version == "2"
        cache.seed([_tpu_node("a", ready=False), _tpu_node("c")], "3")
        changed, removed = cache.drain()
        assert set(changed) == {"a", "c"} and removed == frozenset({"b"})

    def test_apply_modified_heartbeat_does_not_dirty(self):
        cache = NodeCache()
        cache.seed([_tpu_node("a")], "1")
        cache.drain()
        hb = _tpu_node("a")
        hb["metadata"]["resourceVersion"] = "2"
        hb["status"]["conditions"][1]["lastHeartbeatTime"] = "t"
        cache.apply("MODIFIED", hb)
        assert cache.pending() == 0 and cache.resource_version == "2"

    def test_apply_delete_and_bookmark(self):
        cache = NodeCache()
        cache.seed([_tpu_node("a")], "1")
        cache.drain()
        cache.apply("DELETED", {"metadata": {"name": "a", "resourceVersion": "5"}})
        changed, removed = cache.drain()
        assert not changed and removed == frozenset({"a"})
        cache.note_bookmark({"metadata": {"resourceVersion": "9"}})
        assert cache.resource_version == "9" and cache.pending() == 0

    def test_delete_then_readd_is_changed_not_removed(self):
        cache = NodeCache()
        cache.seed([_tpu_node("a")], "1")
        cache.drain()
        cache.apply("DELETED", {"metadata": {"name": "a"}})
        cache.apply("ADDED", _tpu_node("a", ready=False))
        changed, removed = cache.drain()
        assert set(changed) == {"a"} and not removed

    def test_projected_seed_diffs_like_a_raw_seed(self):
        cache = NodeCache()
        cache.seed(_projected([_tpu_node("a"), _tpu_node("b")], "1"), "1")
        changed, removed = cache.drain()
        assert set(changed) == {"a", "b"} and not removed
        cache.seed(_projected([_tpu_node("a", ready=False), _tpu_node("c")], "2"), "2")
        changed, removed = cache.drain()
        assert set(changed) == {"a", "c"} and removed == frozenset({"b"})
        assert "managedFields" not in changed["a"].get("metadata", {})

    def test_digests_agree_across_raw_seed_event_and_projected_relist(self):
        cache = NodeCache()
        cache.seed([_tpu_node("a"), _tpu_node("b")], "1")
        cache.drain()
        hb = _tpu_node("a")
        hb["status"]["conditions"][1]["lastHeartbeatTime"] = "t2"
        hb["spec"]["podCIDR"] = "10.0.0.0/24"
        cache.apply("MODIFIED", hb)
        assert cache.pending() == 0
        cache.seed(_projected([_tpu_node("a"), _tpu_node("b")], "3"), "3")
        assert cache.pending() == 0
        cache.seed(_projected([_tpu_node("a", ready=False), _tpu_node("b")], "4"), "4")
        changed, removed = cache.drain()
        assert set(changed) == {"a"} and not removed


def _client(world):
    cfg = port_cluster.ClusterConfig(
        server=f"http://127.0.0.1:{world['server'].server_address[1]}")
    return port_cluster.KubeClient(cfg)


class TestWatchTransport:
    def test_watch_nodes_decodes_frames(self, stream_world):
        client = _client(stream_world)
        try:
            stream = client.watch_nodes("100")
            stream_world["script"].push(
                fx.watch_event("ADDED", _tpu_node("ws-new"), resource_version="101"))
            stream_world["script"].push(fx.watch_bookmark("102"))
            stream_world["script"].push(None)
            events = [json.loads(line) for line in stream.iter_lines()]
            assert [e["type"] for e in events] == ["ADDED", "BOOKMARK"]
            assert events[0]["object"]["metadata"]["name"] == "ws-new"
        finally:
            client.close()

    def test_connect_410_raises_watch_gone(self, stream_world):
        stream_world["script"]._stanzas.insert(0, {"status": 410})
        client = _client(stream_world)
        try:
            with pytest.raises(port_cluster.WatchGone):
                client.watch_nodes("100")
        finally:
            client.close()

    def test_list_nodes_with_rv_returns_resource_version(self, stream_world):
        client = _client(stream_world)
        try:
            items, rv = client.list_nodes_with_rv()
            assert len(items) == 4 and rv == "100"
        finally:
            client.close()


class TestStreamEngine:
    def test_seed_tick_matches_poll_mode_payload(self, stream_world):
        engine = stream_world["make_engine"]()
        result, delta = engine.tick()
        assert delta == frozenset(f"ws-{i}" for i in range(4))
        poll = port_checker.run_check(
            port_cli.parse_args(["--json"]),
            nodes=[json.loads(json.dumps(n)) for n in stream_world["nodes"]])
        assert result.exit_code == poll.exit_code == 0
        assert result.payload["nodes"] == poll.payload["nodes"]
        assert result.payload["slices"] == poll.payload["slices"]
        assert result.payload["total_chips"] == poll.payload["total_chips"] == 16
        assert result.payload["watch_stream"]["relists_total"] == {"seed": 1}

    def test_steady_tick_is_a_noop_with_fresh_transitions(self, stream_world):
        engine = stream_world["make_engine"]()
        first, _ = engine.tick()
        lists_before = len(stream_world["list_requests"])
        result, delta = engine.tick()
        assert delta == frozenset()
        assert result.exit_code == first.exit_code
        assert result.payload["nodes"] is first.payload["nodes"]
        assert result.payload is not first.payload
        assert len(stream_world["list_requests"]) == lists_before

    def test_steady_ticks_produce_rollups_with_analytics(self, stream_world, tmp_path):
        engine = stream_world["make_engine"](
            "--history", str(tmp_path / "h.jsonl"), "--analytics", str(tmp_path / "ana"))
        first, _ = engine.tick()
        assert set(first.analytics_docs) == {"slo", "offenders", "flaps"}
        samples_first = first.payload["analytics"]["sketch_samples"]
        steady = None
        for _ in range(3):
            steady, delta = engine.tick()
            assert delta == frozenset()
        slo = steady.analytics_docs["slo"]
        assert slo["fleet"]["nodes"] == 4 and slo["source"] == "rollups"
        assert slo["sketch_alpha"] == pytest.approx(0.01)
        samples_steady = steady.payload["analytics"]["sketch_samples"]
        assert samples_steady.get("round_ms", 0) >= samples_first.get("round_ms", 0) + 3
        stats = port_checker._build_analytics(engine.args)["store"].node_stats
        assert stats["ws-0"]["n"] >= 4 and stats["ws-0"]["ok"] == stats["ws-0"]["n"]

    def test_event_flips_grade_and_back(self, stream_world):
        engine = stream_world["make_engine"]()
        engine.tick()
        for i in range(4):
            stream_world["script"].push(fx.watch_event(
                "MODIFIED", _tpu_node(f"ws-{i}", ready=False), resource_version=str(200 + i)))
        _wait(lambda: engine.cache.pending() >= 4)
        result, delta = engine.tick()
        assert delta == frozenset(f"ws-{i}" for i in range(4))
        assert result.exit_code == port_checker.EXIT_NONE_READY
        assert result.payload["ready_chips"] == 0
        stream_world["script"].push(
            fx.watch_event("MODIFIED", _tpu_node("ws-2"), resource_version="210"))
        _wait(lambda: engine.cache.pending() >= 1)
        result, delta = engine.tick()
        assert delta == frozenset({"ws-2"}) and result.payload["ready_chips"] == 4

    def test_deleted_node_leaves_the_payload(self, stream_world):
        engine = stream_world["make_engine"]()
        engine.tick()
        stream_world["script"].push(
            fx.watch_event("DELETED", _tpu_node("ws-3"), resource_version="300"))
        _wait(lambda: engine.cache.pending() >= 1)
        result, delta = engine.tick()
        assert "ws-3" in delta and result.payload["total_nodes"] == 3
        assert all(n["name"] != "ws-3" for n in result.payload["nodes"])

    def test_stream_end_triggers_exactly_one_relist(self, stream_world):
        engine = stream_world["make_engine"]()
        engine.tick()
        lists_before = len(stream_world["list_requests"])
        stream_world["script"].push(None)
        _wait(lambda: not engine.stream_alive(), what="worker exit")
        result, _ = engine.tick()
        assert result.payload["watch_stream"]["relists_total"] == {"seed": 1, "stream_end": 1}
        assert len(stream_world["list_requests"]) == lists_before + 1
        result, delta = engine.tick()
        assert delta == frozenset()
        assert len(stream_world["list_requests"]) == lists_before + 1

    def test_failed_reconnect_does_not_relist_again(self, stream_world):
        engine = stream_world["make_engine"]("--retry-budget", "0")
        engine.tick()
        lists_before = len(stream_world["list_requests"])
        stream_world["script"].push(None)
        _wait(lambda: not engine.stream_alive(), what="worker exit")
        stream_world["script"]._stanzas.insert(0, {"status": 500})
        with pytest.raises(Exception):
            engine.tick()
        lists_after_failure = len(stream_world["list_requests"])
        assert lists_after_failure == lists_before + 1
        result, _ = engine.tick()
        assert len(stream_world["list_requests"]) == lists_after_failure
        assert result.payload["watch_stream"]["relists_total"] == {"seed": 1, "stream_end": 1}

    def test_inband_410_replay_relists_as_gone(self, stream_world):
        engine = stream_world["make_engine"]()
        engine.tick()
        stream_world["script"].push(fx.watch_error_gone())
        _wait(lambda: not engine.stream_alive(), what="worker exit on 410 replay")
        result, _ = engine.tick()
        assert result.payload["watch_stream"]["relists_total"] == {"seed": 1, "gone": 1}

    def test_mid_stream_reset_relists_as_stream_error(self, stream_world):
        engine = stream_world["make_engine"]()
        stream_world["script"]._stanzas.insert(0, {
            "events": [fx.watch_event("MODIFIED", _tpu_node("ws-0", ready=False),
                                      resource_version="150")],
            "end": "reset"})
        engine.tick()
        _wait(lambda: not engine.stream_alive(), what="worker exit on reset")
        result, _ = engine.tick()
        assert "stream_error" in result.payload["watch_stream"]["relists_total"]
        assert result.payload["total_nodes"] == 4

    def test_dead_server_raises_like_a_failed_round(self, own_server_world):
        world = own_server_world
        engine = world["make_engine"]("--retry-budget", "0")
        engine.tick()
        world["script"].close()
        world["server"].shutdown()
        world["server"].server_close()
        engine.abort_stream()
        port_checker.reset_client_cache()
        _wait(lambda: not engine.stream_alive(), what="worker death")
        with pytest.raises(Exception):
            engine.tick()

    def test_slow_drip_frames_arrive(self, stream_world):
        engine = stream_world["make_engine"]()
        stream_world["script"]._stanzas.insert(0, {
            "events": [
                fx.watch_event("MODIFIED", _tpu_node("ws-1", ready=False),
                               resource_version="160"),
                fx.watch_event("MODIFIED", _tpu_node("ws-1"), resource_version="161"),
            ],
            "frame_delay": 0.05, "end": "close"})
        engine.tick()
        _wait(lambda: engine.stats.as_dict()["events_total"].get("MODIFIED", 0) >= 2,
              what="dripped frames")


class TestIncrementalSlices:
    """The engine's slice cache must equal a from-scratch ``group_slices``
    while reusing untouched groups by reference."""

    def _engine_with(self, raw_nodes):
        engine = StreamRoundEngine(port_cli.parse_args(["--watch", "5", "--watch-stream",
                                                        "--json"]))
        engine._infos = {i.name: i for i in (port_detect.extract_node_info(n)
                                             for n in raw_nodes)}
        engine._accel_names = sorted(engine._infos)
        return engine

    def _full(self, engine):
        return port_detect.group_slices([engine._infos[n] for n in engine._accel_names])

    def test_flip_remove_and_label_move_match_full_rebuild(self):
        raw = [n for n in fx.big_mixed_cluster()
               if "google.com/tpu" in (n["status"]["allocatable"] or {})][:192]
        engine = self._engine_with(raw)
        first = engine._slices_incremental(frozenset(engine._infos))
        assert [s.to_dict() for s in first] == [s.to_dict() for s in self._full(engine)]
        dicts_before = dict(engine._slice_dicts)
        engine._slice_payload(first)
        changed = set()
        for n in raw[10:15]:
            for cond in n["status"]["conditions"]:
                if cond["type"] == "Ready":
                    cond["status"] = "False"
            info = port_detect.extract_node_info(n)
            engine._infos[info.name] = info
            changed.add(info.name)
        inc = engine._slices_incremental(frozenset(changed))
        assert engine._slice_payload(inc) == [s.to_dict() for s in self._full(engine)]
        touched = {port_detect.slice_group_key(engine._infos[n]) for n in changed}
        for key, d in dicts_before.items():
            if key not in touched:
                assert engine._slice_dicts[key] is d
        victim = raw[100]["metadata"]["name"]
        del engine._infos[victim]
        engine._accel_names = sorted(engine._infos)
        inc = engine._slices_incremental(frozenset({victim}))
        assert engine._slice_payload(inc) == [s.to_dict() for s in self._full(engine)]
        mover = raw[150]
        mover["metadata"]["labels"]["cloud.google.com/gke-nodepool"] = (
            raw[0]["metadata"]["labels"]["cloud.google.com/gke-nodepool"])
        info = port_detect.extract_node_info(mover)
        engine._infos[info.name] = info
        inc = engine._slices_incremental(frozenset({info.name}))
        assert engine._slice_payload(inc) == [s.to_dict() for s in self._full(engine)]


class TestEvidenceSemantics:
    def test_silent_ticks_bank_nothing_toward_cordon(self, stream_world, tmp_path):
        engine = stream_world["make_engine"]("--history", str(tmp_path / "h.jsonl"),
                                             "--cordon-after", "2")
        engine.tick()
        stream_world["script"].push(fx.watch_event(
            "MODIFIED", _tpu_node("ws-0", ready=False), resource_version="400"))
        _wait(lambda: engine.cache.pending() >= 1)
        result, _ = engine.tick()
        sick = next(n for n in result.payload["nodes"] if n["name"] == "ws-0")
        assert (sick["health"]["state"], sick["health"]["streak"]) == ("SUSPECT", 1)
        for _ in range(3):
            result, delta = engine.tick()
            assert delta == frozenset()
        sick = next(n for n in result.payload["nodes"] if n["name"] == "ws-0")
        assert (sick["health"]["state"], sick["health"]["streak"]) == ("SUSPECT", 1)
        bad = _tpu_node("ws-0", ready=False)
        bad["status"]["conditions"][1]["reason"] = "KubeletNotReady"
        stream_world["script"].push(fx.watch_event("MODIFIED", bad, resource_version="401"))
        _wait(lambda: engine.cache.pending() >= 1)
        result, _ = engine.tick()
        sick = next(n for n in result.payload["nodes"] if n["name"] == "ws-0")
        assert sick["health"]["state"] == "FAILED"

    def test_steady_tick_reports_no_stale_transitions(self, stream_world, tmp_path):
        engine = stream_world["make_engine"]("--history", str(tmp_path / "h.jsonl"))
        engine.tick()
        stream_world["script"].push(fx.watch_event(
            "MODIFIED", _tpu_node("ws-0", ready=False), resource_version="500"))
        _wait(lambda: engine.cache.pending() >= 1)
        result, _ = engine.tick()
        assert any(t["to"] == "FAILED" for t in result.payload["history"]["transitions"])
        result, delta = engine.tick()
        assert delta == frozenset()
        assert result.payload["history"]["transitions"] == []


class TestWatchLoopIntegration:
    def test_watch_loop_runs_stream_ticks_and_publishes(self, stream_world, monkeypatch,
                                                        capsys):
        ticks = []

        def fake_wait(stop, seconds):
            ticks.append(seconds)
            if len(ticks) == 2:
                stream_world["script"].push(fx.watch_event(
                    "MODIFIED", _tpu_node("ws-1", ready=False), resource_version="600"))
            return len(ticks) >= 4

        holder = {}
        port_app = importlib.import_module("tpu_node_checker_torch.server.app")
        orig_init = port_app.FleetStateServer.__init__

        def spy_init(self, *a, **kw):
            orig_init(self, *a, **kw)
            holder["server"] = self

        monkeypatch.setattr(port_app.FleetStateServer, "__init__", spy_init)
        monkeypatch.setattr(port_checker, "_wait_for_next_round", fake_wait)
        orig_tick = StreamRoundEngine.tick

        def synced_tick(self, tracer=None):
            if len(ticks) == 2:
                # The pushed frame lands before round 3's tick.
                _wait(lambda: self.cache.pending() > 0, what="the pushed frame")
            return orig_tick(self, tracer=tracer)

        monkeypatch.setattr(StreamRoundEngine, "tick", synced_tick)
        args = port_cli.parse_args(["--kubeconfig", stream_world["kubeconfig"], "--watch", "5",
                                    "--watch-stream", "--serve", "0", "--json"])
        assert port_checker.watch(args) == 143
        snap = holder["server"]._snap
        # Rounds 1 (the seed) and 3 (the flip) published; steady rounds did not.
        assert snap.seq == 2
        assert snap.node_docs["ws-1"]["ready"] is False
        assert "Watch-stream mode" in capsys.readouterr().err


class TestCliValidation:
    def test_watch_stream_requires_watch(self, capsys):
        with pytest.raises(SystemExit):
            port_cli.parse_args(["--watch-stream"])
        assert "--watch-stream requires --watch" in capsys.readouterr().err

    def test_no_watch_stream_overrides(self):
        args = port_cli.parse_args(["--watch", "5", "--watch-stream", "--no-watch-stream"])
        assert args.watch_stream is False

    @pytest.mark.parametrize("extra", [
        ["--probe"], ["--probe-results", "/tmp/x"], ["--node-events"],
        ["--nodes-json", "/tmp/x.json"], ["--emit-probe", "-"],
    ])
    def test_rejected_companions(self, extra, capsys):
        # The words are JAX's.
        got = []
        for cli in (port_cli, jax_cli):
            with pytest.raises(SystemExit):
                cli.parse_args(["--watch", "5", "--watch-stream", *extra])
            got.append(capsys.readouterr().err.strip().splitlines()[-1].split("error: ")[1])
        assert got[0] == got[1] and "--watch-stream" in got[0]

    @pytest.mark.parametrize("argv", [
        ["--kubeconfig", "k", "--watch", "1", "--watch-stream", "--serve", "0",
         "--cluster-name", "west", "--history", "h", "--analytics", "a"],
        ["--watch", "5", "--watch-stream", "--no-watch-stream", "--probe"],
        ["--watch", "5", "--no-watch-stream", "--watch-stream"],
    ])
    def test_parses_as_jax_parses_it(self, argv):
        port, jax = vars(port_cli.parse_args(argv)), vars(jax_cli.parse_args(argv))
        assert {k: v for k, v in port.items() if k != "device"} == jax

    def test_every_jax_flag_is_accepted_by_the_port(self):
        def flags(parser):
            return {o for a in parser._actions for o in a.option_strings}

        port, jax = flags(port_cli.build_parser()), flags(jax_cli.build_parser())
        assert jax <= port
        # The port's own flags are the only difference.
        assert port - jax == {"--device", "--probe-workload-model"}


# ---------------------------------------------------------------------------
# The port's engine beside the JAX engine, on one scripted stream
# ---------------------------------------------------------------------------


def _masked(obj):
    if isinstance(obj, dict):
        return {k: "<masked>" if k in MASKED_KEYS else _masked(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_masked(v) for v in obj]
    return obj


def _scripted_life(side, api_server, monkeypatch, tmp_path, extra):
    """One engine's life over the script: seed; a flip, heartbeats, a
    DELETED, an ADDED and a BOOKMARK; a steady tick; the server's end of
    the stream; an in-band 410; a recovery.  Each tick's masked payload,
    exit code and changed set, then the stats."""
    world = _fresh_world(*api_server, side=side)
    clock = [1_700_000_000.0]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    script = world["script"]
    engine = world["make_engine"](*[a.replace("{dir}", str(tmp_path / side)) for a in extra])
    ticks = []

    def tick():
        clock[0] += 5.0
        result, delta = engine.tick()
        ticks.append((result.exit_code, sorted(delta or ()), _masked(result.payload)))

    def rv(value):
        _wait(lambda: engine.cache.resource_version == value, what=f"resourceVersion {value}")

    try:
        tick()
        script.push(fx.watch_event("MODIFIED", _tpu_node("ws-0", ready=False),
                                   resource_version="200"))
        for i in range(20):
            hb = _tpu_node("ws-1")
            hb["status"]["conditions"][1]["lastHeartbeatTime"] = f"2026-10-17T00:00:{i:02d}Z"
            script.push(fx.watch_event("MODIFIED", hb, resource_version=str(201 + i)))
        script.push(fx.watch_event("DELETED", _tpu_node("ws-3"), resource_version="221"))
        script.push(fx.watch_event("ADDED", _tpu_node("ws-9"), resource_version="222"))
        script.push(fx.watch_bookmark("223"))
        rv("223")
        tick()
        tick()
        script.push(None)
        _wait(lambda: not engine.stream_alive(), what="the stream's end")
        tick()
        script.push(fx.watch_error_gone())
        script.push(None)
        _wait(lambda: not engine.stream_alive(), what="the in-band 410")
        tick()
        script.push(fx.watch_event("MODIFIED", _tpu_node("ws-2", ready=False),
                                   resource_version="300"))
        script.push(fx.watch_bookmark("301"))
        rv("301")
        tick()
        stats = engine.stats.as_dict()
        stats.pop("stream_age_seconds")
        return ticks, stats, len(world["list_requests"])
    finally:
        _close_world(world)


class TestAgainstJax:
    @pytest.mark.parametrize("extra", [
        (),
        ("--history", "{dir}/h.jsonl", "--cordon-after", "2", "--analytics", "{dir}/a"),
    ], ids=["plain", "history-analytics"])
    def test_scripted_stream_equals_jax(self, api_server, monkeypatch, tmp_path, extra):
        port = _scripted_life("port", api_server, monkeypatch, tmp_path, extra)
        jax = _scripted_life("jax", api_server, monkeypatch, tmp_path, extra)
        assert port[0] == jax[0]
        assert port[1:] == jax[1:]
        ticks, stats, lists = port
        assert [t[0] for t in ticks] == [0, 0, 0, 0, 0, 0]
        assert ticks[1][1] == ["ws-0", "ws-3", "ws-9"]
        assert ticks[2][1] == []
        assert stats["relists_total"] == {"seed": 1, "stream_end": 1, "gone": 1}
        assert stats["events_total"]["MODIFIED"] == 22
        assert stats["events_total"]["BOOKMARK"] == 2
        assert lists == 3
