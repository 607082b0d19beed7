"""The port's federation tier (``--federate``, ``--federate-feed``,
``--federate-interval``, ``--federate-workers``,
``--fleet-disruption-budget``), held against the JAX package's.

The port's ``federation/aggregator.py`` and ``federation/merge.py`` are
verbatim copies (``tests/test_torch_copies.py``).  Here they run: the same
cases as ``tests/test_federation.py`` with the port's modules (the
endpoints registry, the consistent-hash shards, the merge's byte-joined
blocks and their reuse by reference, the aggregator end to end over real
upstream fleet APIs, the fetch tier's hardening, the ``/api/v1/watch`` feed
consumer, the CLI's rules and the federated analytics), and then the
port's and the JAX aggregator side by side over the same upstreams: equal
global bodies under the masks named in ``MASKED_KEYS``, the same lease
grants and denials under ``--fleet-disruption-budget 1/10m``, and the same
usage errors word for word.

The upstream checkers are the port's own fleet state API
(``server/app.py``) with a published round.  The read-only cases share one
set of upstreams per module; a case that publishes to or stops an upstream
makes its own.  Nothing sleeps for pacing: a wait on a real stream thread
is a bounded poll, marked as such.

The port is reached through ``importlib.import_module``:
tests/test_dependency_surface.py rejects any other ``import`` in tests/.
"""

import gzip
import http.client
import importlib
import json
import os
import time
import types

import pytest

from tpu_node_checker import cli as jax_cli
from tpu_node_checker.federation import aggregator as jax_aggregator
from tpu_node_checker.server import app as jax_app

port_checker = importlib.import_module("tpu_node_checker_torch.checker")
port_cli = importlib.import_module("tpu_node_checker_torch.cli")
port_aggregator = importlib.import_module("tpu_node_checker_torch.federation.aggregator")
port_endpoints = importlib.import_module("tpu_node_checker_torch.federation.endpoints")
port_merge = importlib.import_module("tpu_node_checker_torch.federation.merge")
port_app = importlib.import_module("tpu_node_checker_torch.server.app")
port_snapshot = importlib.import_module("tpu_node_checker_torch.server.snapshot")
port_sketch = importlib.import_module("tpu_node_checker_torch.analytics.sketch")

FederationEngine = port_aggregator.FederationEngine
FleetStateServer = port_app.FleetStateServer
ClusterView = port_merge.ClusterView
build_global_snapshot = port_merge.build_global_snapshot
extract_node_entries = port_merge.extract_node_entries
build_snapshot = port_snapshot.build_snapshot

WALL_CLOCK_BUDGET_S = 20.0
# The masks between the port's and the JAX aggregator's global bodies: a
# merge round's trace id is random, and its ms values are wall times.
# The clock both read is pinned, so every timestamp is compared.
MASKED_KEYS = ("trace_id",)
MASKED_SUFFIXES = ("_ms",)
# The /metrics families compared: the federation's own, less its durations
# and the feed's frame counts and lag (how a real stream's frames coalesce
# and when its heartbeats land are wall-time matters).
UNCOMPARED_METRICS = ("round_duration_ms", "fetch_duration", "federation_feed_")
GLOBAL_PATHS = ["/api/v1/global/summary", "/api/v1/global/clusters",
                "/api/v1/global/clusters/us-a", "/api/v1/global/clusters/eu-b",
                "/api/v1/global/nodes", "/api/v1/global/analytics",
                "/api/v1/global/clusters/nope", "/readyz", "/healthz", "/api/v1/summary"]


@pytest.fixture(autouse=True)
def _wall_clock_guard():
    t0 = time.perf_counter()
    yield
    elapsed = time.perf_counter() - t0
    assert elapsed < WALL_CLOCK_BUDGET_S, (
        f"federation test burned {elapsed:.1f}s of wall-clock — a real "
        "sleep or a wedged fetch leaked in"
    )


@pytest.fixture(autouse=True)
def _no_outside_settings(monkeypatch):
    for k in [k for k in os.environ if k.startswith("TNC_")]:
        monkeypatch.delenv(k)


def _req(port, method, path, headers=None, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.headers.items()), resp.read()
    finally:
        conn.close()


def _round_payload(cluster, n, healthy=True, name_prefix=None):
    prefix = name_prefix or f"{cluster}-node"
    return {
        "total_nodes": n,
        "ready_nodes": n if healthy else 0,
        "total_chips": n * 8,
        "ready_chips": n * 8 if healthy else 0,
        "nodes": [
            {"name": f"{prefix}-{i}", "ready": healthy,
             "accelerators": 8, "padding": "x" * 40}
            for i in range(n)
        ],
        "slices": [],
        "cluster": cluster,
        "cluster_source": "flag",
        "exit_code": 0 if healthy else 3,
    }


class _Round:
    def __init__(self, payload, exit_code=0):
        self.payload = payload
        self.exit_code = exit_code


def _fixture_cluster(cluster, n, healthy=True, name_prefix=None, feed=True, port=0):
    """One upstream checker: the port's fleet state API with a published
    round, the wire the two tiers speak."""
    srv = FleetStateServer(port, host="127.0.0.1", feed=feed)
    payload = _round_payload(cluster, n, healthy=healthy, name_prefix=name_prefix)
    srv.publish(_Round(payload, payload["exit_code"]))
    return srv


def _write_endpoints(path, servers):
    path.write_text(json.dumps({
        "clusters": [
            {"name": name, "url": f"http://127.0.0.1:{srv.port}"}
            for name, srv in servers
        ]
    }))


def _args(path, extra=(), cli=port_cli):
    return cli.parse_args(
        ["--federate", str(path), "--serve", "0", "--retry-budget", "0", *extra]
    )


def _delta(srv, before):
    return {k: n - before.get(k, 0) for k, n in srv.stats.requests.items()
            if n != before.get(k, 0)}


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """The upstreams the read-only cases share: us-a (5 nodes), eu-b (3)
    and ``their-name`` (2), with one endpoints file for the first two,
    one for us-a alone and one naming the third ``our-name``."""
    servers = {name: _fixture_cluster(name, n)
               for name, n in (("us-a", 5), ("eu-b", 3), ("their-name", 2))}
    root = tmp_path_factory.mktemp("fleet")
    files = {"both": root / "both.json", "us-a": root / "us-a.json",
             "mismatch": root / "mismatch.json"}
    _write_endpoints(files["both"], [("us-a", servers["us-a"]), ("eu-b", servers["eu-b"])])
    _write_endpoints(files["us-a"], [("us-a", servers["us-a"])])
    _write_endpoints(files["mismatch"], [("our-name", servers["their-name"])])
    yield types.SimpleNamespace(servers=servers, files=files)
    for srv in servers.values():
        srv.close()


# ---------------------------------------------------------------------------
# Endpoints registry
# ---------------------------------------------------------------------------


class TestEndpoints:
    def test_load_valid(self, tmp_path):
        p = tmp_path / "endpoints.json"
        p.write_text(json.dumps({"clusters": [
            {"name": "us-a", "url": "http://a:8080/"},
            {"name": "eu-b", "url": "https://b:8080", "token": "t"},
        ]}))
        eps = port_endpoints.load_endpoints(str(p))
        assert [(e.name, e.url, e.token) for e in eps] == [
            ("us-a", "http://a:8080", None),
            ("eu-b", "https://b:8080", "t"),
        ]

    @pytest.mark.parametrize("doc,hint", [
        ("not json {", "not valid JSON"),
        (json.dumps([]), "'clusters' list"),
        (json.dumps({"clusters": []}), "empty"),
        (json.dumps({"clusters": ["x"]}), "not an object"),
        (json.dumps({"clusters": [{"url": "http://a"}]}), "no 'name'"),
        (json.dumps({"clusters": [{"name": "a/b", "url": "http://a"}]}),
         "must not contain '/'"),
        (json.dumps({"clusters": [{"name": "a", "url": "ftp://a"}]}), "http(s)"),
        (json.dumps({"clusters": [{"name": "a", "url": "http://a"},
                                  {"name": "a", "url": "http://b"}]}), "duplicate"),
        (json.dumps({"clusters": [{"name": "a", "url": "http://a", "token": 5}]}), "token"),
    ])
    def test_malformed_is_a_named_error(self, tmp_path, doc, hint):
        p = tmp_path / "endpoints.json"
        p.write_text(doc)
        with pytest.raises(port_endpoints.EndpointsError) as err:
            port_endpoints.load_endpoints(str(p))
        assert hint in str(err.value)


class TestShardClusters:
    def test_every_cluster_assigned_exactly_once(self):
        names = [f"cluster-{i}" for i in range(50)]
        shards = port_endpoints.shard_clusters(names, 4)
        flat = [n for shard in shards.values() for n in shard]
        assert sorted(flat) == sorted(names)
        assert set(shards) <= set(range(4))

    def test_deterministic_and_stable_under_cluster_churn(self):
        names = [f"cluster-{i}" for i in range(30)]
        first = port_endpoints.shard_clusters(names, 4)
        assert first == port_endpoints.shard_clusters(names, 4)
        # A new cluster never moves an existing one.
        grown = port_endpoints.shard_clusters(names + ["brand-new"], 4)
        slot_of = {n: s for s, shard in grown.items() for n in shard}
        for slot, shard in first.items():
            for name in shard:
                assert slot_of[name] == slot

    def test_worker_resize_moves_a_minority(self):
        names = [f"cluster-{i}" for i in range(200)]
        before = {n: s for s, shard in port_endpoints.shard_clusters(names, 4).items()
                  for n in shard}
        after = {n: s for s, shard in port_endpoints.shard_clusters(names, 5).items()
                 for n in shard}
        moved = sum(1 for n in names if before[n] != after[n])
        assert moved < len(names) // 2, moved

    def test_single_worker_short_circuit(self):
        assert port_endpoints.shard_clusters(["a", "b"], 1) == {0: ["a", "b"]}


# ---------------------------------------------------------------------------
# Entry extraction and the merge
# ---------------------------------------------------------------------------


class TestExtractNodeEntries:
    def test_round_trips_a_real_snapshot_body(self):
        payload = _round_payload("us-a", 5)
        snap = build_snapshot(payload, 0, 7, 123.0)
        entries, head = extract_node_entries(snap.entities["nodes"].raw)
        assert head["round"] == 7 and head["count"] == 5
        assert head["cluster"] == "us-a"
        assert json.loads(b"[" + entries + b"]") == payload["nodes"]

    def test_empty_fleet(self):
        snap = build_snapshot({"nodes": [], "cluster": "us-a"}, 0, 1, 1.0)
        entries, head = extract_node_entries(snap.entities["nodes"].raw)
        assert entries == b"" and head["count"] == 0

    def test_malformed_body_raises(self):
        with pytest.raises(ValueError):
            extract_node_entries(b'{"no": "nodes here"}')


def _view(name, n, healthy=True, stale_rounds=0, url=None, name_prefix=None):
    view = ClusterView(name, url or f"http://{name}:8080")
    payload = _round_payload(name, n, healthy=healthy, name_prefix=name_prefix)
    snap = build_snapshot(payload, payload["exit_code"], 3, 100.0)
    entries, head = extract_node_entries(snap.entities["nodes"].raw)
    view.summary_doc = json.loads(snap.entities["summary"].raw)
    view.summary_etag = snap.entities["summary"].etag
    view.nodes_entries = entries
    view.nodes_etag = snap.entities["nodes"].etag
    view.nodes_count = head["count"]
    view.nodes_round = head["round"]
    view.record_success()
    for _ in range(stale_rounds):
        view.record_failure("ConnectionRefusedError: injected")
    return view


class TestMerge:
    def test_duplicate_node_names_across_clusters_both_survive(self):
        a = _view("us-a", 3, name_prefix="shared-node")
        b = _view("eu-b", 2, name_prefix="shared-node")
        doc = json.loads(build_global_snapshot([a, b], 1, 10.0).entity("global/nodes").raw)
        assert doc["count"] == 5
        by_cluster = {c["cluster"]: c for c in doc["clusters"]}
        assert [n["name"] for n in by_cluster["us-a"]["nodes"]] == [
            "shared-node-0", "shared-node-1", "shared-node-2"]
        assert [n["name"] for n in by_cluster["eu-b"]["nodes"]] == [
            "shared-node-0", "shared-node-1"]

    def test_one_stale_one_fresh_summary_semantics(self):
        snap = build_global_snapshot([_view("us-a", 4), _view("eu-b", 2, stale_rounds=3)],
                                     5, 10.0)
        summary = json.loads(snap.entity("global/summary").raw)
        assert summary["healthy"] is True
        assert summary["degraded"] is True
        assert summary["degraded_clusters"] == ["eu-b"]
        assert summary["clusters"] == {"total": 2, "with_data": 2, "fresh": 1, "degraded": 1}
        assert summary["total_nodes"] == 6
        clusters = json.loads(snap.entity("global/clusters").raw)["clusters"]
        stale_entry = next(c for c in clusters if c["cluster"] == "eu-b")
        assert stale_entry["degraded"] is True
        assert stale_entry["staleness"]["rounds"] == 3
        assert "injected" in stale_entry["error"]
        nodes = json.loads(snap.entity("global/nodes").raw)
        assert {c["cluster"]: c.get("stale") for c in nodes["clusters"]} == {
            "us-a": None, "eu-b": True}

    def test_unhealthy_fresh_cluster_sinks_global_healthy(self):
        summary = json.loads(build_global_snapshot(
            [_view("us-a", 2), _view("eu-b", 2, healthy=False)], 1, 1.0
        ).entity("global/summary").raw)
        assert summary["healthy"] is False
        assert summary["unhealthy_clusters"] == ["eu-b"]
        assert summary["degraded"] is False

    def test_no_fresh_data_is_not_healthy_but_still_serves(self):
        summary = json.loads(build_global_snapshot(
            [_view("us-a", 3, stale_rounds=1)], 1, 1.0).entity("global/summary").raw)
        assert summary["healthy"] is False
        assert summary["total_nodes"] == 3

    def test_nodes_entity_reused_by_reference_when_unchanged(self):
        a, b = _view("us-a", 3), _view("eu-b", 3)
        first = build_global_snapshot([a, b], 1, 1.0)
        second = build_global_snapshot([a, b], 2, 2.0, prev=first)
        assert second.entity("global/nodes") is first.entity("global/nodes")
        b.record_failure("boom")
        block_a = a.block()
        third = build_global_snapshot([a, b], 3, 3.0, prev=second)
        assert third.entity("global/nodes") is not first.entity("global/nodes")
        assert a.block() is block_a

    def test_etagless_upstream_content_change_rebuilds_nodes(self):
        view = _view("us-a", 2)
        view.nodes_etag = None
        view.nodes_fp = "sha256:first"
        first = build_global_snapshot([view], 1, 1.0)
        snap = build_snapshot(_round_payload("us-a", 3), 0, 2, 2.0)
        view.nodes_entries, head = extract_node_entries(snap.entities["nodes"].raw)
        view.nodes_count = head["count"]
        view.nodes_fp = "sha256:second"
        second = build_global_snapshot([view], 2, 2.0, prev=first)
        assert second.entity("global/nodes") is not first.entity("global/nodes")
        assert json.loads(second.entity("global/nodes").raw)["count"] == 3
        third = build_global_snapshot([view], 3, 3.0, prev=second)
        assert third.entity("global/nodes") is second.entity("global/nodes")
        # A round advance over identical entries still rebuilds: the block
        # head carries the upstream round.
        view.nodes_round = (view.nodes_round or 0) + 1
        fourth = build_global_snapshot([view], 4, 4.0, prev=third)
        assert fourth.entity("global/nodes") is not third.entity("global/nodes")
        by_cluster = json.loads(fourth.entity("global/nodes").raw)["clusters"]
        assert by_cluster[0]["round"] == view.nodes_round

    def test_gzip_member_concat_decompresses_byte_identical(self):
        snap = build_global_snapshot([_view(f"c{i:02d}", 8) for i in range(4)], 1, 1.0)
        entity = snap.entity("global/nodes")
        assert entity.gz is not None
        assert gzip.decompress(entity.gz) == entity.raw


# ---------------------------------------------------------------------------
# The aggregator end to end (real upstream fleet APIs, real HTTP both tiers)
# ---------------------------------------------------------------------------


def _own_fleet(tmp_path, specs, feed=True):
    servers = {name: _fixture_cluster(name, n, feed=feed) for name, n in specs}
    endpoints = tmp_path / "endpoints.json"
    _write_endpoints(endpoints, list(servers.items()))
    return servers, endpoints


class TestFederationE2E:
    def test_merged_view_serves_and_polls_304(self, fleet):
        engine = FederationEngine(_args(fleet.files["both"]))
        agg = FleetStateServer(0, host="127.0.0.1", federation=True,
                               readiness=engine.readiness)
        try:
            engine.round(agg)
            status, headers, body = _req(agg.port, "GET", "/api/v1/global/summary")
            assert status == 200
            summary = json.loads(body)
            assert summary["healthy"] is True and summary["total_nodes"] == 8
            status, _, _ = _req(agg.port, "GET", "/api/v1/global/summary",
                                headers={"If-None-Match": headers["ETag"]})
            assert status == 304
            doc = json.loads(_req(agg.port, "GET", "/api/v1/global/nodes")[2])
            assert doc["count"] == 8 and doc["cluster_count"] == 2
            status, _, body = _req(agg.port, "GET", "/api/v1/global/clusters/eu-b")
            assert status == 200 and json.loads(body)["cluster"]["reachable"] is True
            assert _req(agg.port, "GET", "/api/v1/global/clusters/nope")[0] == 404
            status, _, body = _req(agg.port, "GET", "/api/v1/summary")
            assert status == 404 and b"global" in body
        finally:
            agg.close()
            engine.close()

    def test_steady_round_costs_one_304_per_endpoint(self, fleet):
        engine = FederationEngine(_args(fleet.files["us-a"]))
        try:
            first = engine.round()
            upstream = fleet.servers["us-a"]
            before = dict(upstream.stats.requests)
            second = engine.round()
            assert _delta(upstream, before) == {
                ("GET", "/api/v1/summary", 304): 1,
                ("GET", "/api/v1/nodes", 304): 1,
            }
            assert second.entity("global/nodes") is first.entity("global/nodes")
        finally:
            engine.close()

    def test_killed_cluster_degrades_only_its_shard(self, tmp_path):
        servers, endpoints = _own_fleet(tmp_path, [("us-a", 5), ("eu-b", 3)])
        engine = FederationEngine(_args(endpoints))
        agg = FleetStateServer(0, host="127.0.0.1", federation=True,
                               readiness=engine.readiness)
        try:
            engine.round(agg)
            servers["eu-b"].close()
            engine.round(agg)
            status, _, body = _req(agg.port, "GET", "/api/v1/global/summary")
            assert status == 200
            summary = json.loads(body)
            assert summary["healthy"] is True and summary["degraded"] is True
            assert summary["degraded_clusters"] == ["eu-b"]
            assert summary["total_nodes"] == 8
            status, _, body = _req(agg.port, "GET", "/readyz")
            assert status == 200
            detail = json.loads(body)["clusters"]["eu-b"]
            assert detail["reachable"] is False and detail["staleness_rounds"] == 1
            engine.round(agg)
            body = _req(agg.port, "GET", "/api/v1/global/clusters/eu-b")[2]
            assert json.loads(body)["cluster"]["staleness"]["rounds"] == 2
            # The last cluster too: blind, so not ready; the data still serves.
            servers["us-a"].close()
            engine.round(agg)
            status, _, body = _req(agg.port, "GET", "/readyz")
            assert status == 503
            assert "every cluster shard is degraded" in json.loads(body)["reason"]
            assert _req(agg.port, "GET", "/api/v1/global/summary")[0] == 200
        finally:
            agg.close()
            engine.close()

    def test_cluster_disappearing_and_joining_between_rounds(self, tmp_path, fleet):
        endpoints = tmp_path / "endpoints.json"
        _write_endpoints(endpoints, [("us-a", fleet.servers["us-a"]),
                                     ("eu-b", fleet.servers["eu-b"])])
        engine = FederationEngine(_args(endpoints))
        try:
            snap = engine.round()
            assert json.loads(snap.entity("global/summary").raw)["clusters"]["total"] == 2
            _write_endpoints(endpoints, [("us-a", fleet.servers["us-a"])])
            snap = engine.round()
            summary = json.loads(snap.entity("global/summary").raw)
            assert summary["clusters"]["total"] == 1 and summary["total_nodes"] == 5
            doc = json.loads(snap.entity("global/nodes").raw)
            assert [c["cluster"] for c in doc["clusters"]] == ["us-a"]
            assert snap.cluster_entity("eu-b") is None
            _write_endpoints(endpoints, [("us-a", fleet.servers["us-a"]),
                                         ("ap-c", fleet.servers["their-name"])])
            snap = engine.round()
            assert json.loads(snap.entity("global/summary").raw)["total_nodes"] == 7
        finally:
            engine.close()

    def test_malformed_endpoints_rewrite_keeps_last_good_set(self, tmp_path, fleet):
        endpoints = tmp_path / "endpoints.json"
        _write_endpoints(endpoints, [("us-a", fleet.servers["us-a"])])
        engine = FederationEngine(_args(endpoints))
        try:
            engine.round()
            endpoints.write_text("{ not json")
            summary = json.loads(engine.round().entity("global/summary").raw)
            assert summary["clusters"]["total"] == 1 and summary["healthy"] is True
        finally:
            engine.close()

    def test_single_cluster_federated_view_is_byte_identical(self, fleet):
        engine = FederationEngine(_args(fleet.files["us-a"]))
        upstream = fleet.servers["us-a"]
        try:
            snap = engine.round()
            upstream_entries, head = extract_node_entries(
                _req(upstream.port, "GET", "/api/v1/nodes")[2])
            global_body = snap.entity("global/nodes").raw
            expected_block = (
                json.dumps({"cluster": "us-a", "round": head["round"],
                            "count": head["count"]}, ensure_ascii=False)[:-1].encode()
                + b', "nodes": [' + upstream_entries + b"]}")
            assert expected_block in global_body
            assert global_body.count(upstream_entries) == 1
            embedded = json.loads(snap.cluster_entity("us-a").raw)["summary"]
            assert embedded == json.loads(_req(upstream.port, "GET", "/api/v1/summary")[2])
        finally:
            engine.close()

    def test_upstream_name_mismatch_is_surfaced(self, fleet):
        engine = FederationEngine(_args(fleet.files["mismatch"]))
        try:
            entry = json.loads(engine.round().cluster_entity("our-name").raw)["cluster"]
            assert entry["reported_cluster"] == "their-name"
        finally:
            engine.close()

    def test_federate_mode_loop_exits_143_on_sigterm(self, fleet, monkeypatch):
        seen = {}
        monkeypatch.setattr(port_checker, "_wait_for_next_round",
                            lambda stop, s: seen.setdefault("waited", True) or True)
        assert port_aggregator.federate(_args(fleet.files["us-a"])) == 128 + 15
        assert seen == {"waited": True}

    def test_global_routes_on_a_plain_checker_404_helpfully(self, fleet):
        port = fleet.servers["us-a"].port
        status, _, body = _req(port, "GET", "/api/v1/global/summary")
        assert status == 404 and b"--federate" in body
        assert _req(port, "GET", "/api/v1/global/clusters/x")[0] == 404

    def test_federation_metrics_families(self, tmp_path):
        servers, endpoints = _own_fleet(tmp_path, [("us-a", 2)])
        engine = FederationEngine(_args(endpoints))
        agg = FleetStateServer(0, host="127.0.0.1", federation=True,
                               readiness=engine.readiness)
        try:
            engine.round(agg)
            servers["us-a"].close()
            engine.round(agg)
            text = _req(agg.port, "GET", "/metrics")[2].decode()
            assert 'tpu_node_checker_federation_clusters{state="degraded"} 1.0' in text
            assert 'tpu_node_checker_federation_cluster_up{cluster="us-a"} 0.0' in text
            assert ('tpu_node_checker_federation_staleness_rounds{cluster="us-a"} 1.0'
                    in text)
            assert ('tpu_node_checker_federation_fetch_total{cluster="us-a",'
                    'result="fresh"} 2' in text)
            assert "tpu_node_checker_federation_round_duration_ms" in text
            assert "tpu_node_checker_federation_workers 4.0" in text
            assert "tpu_node_checker_last_run_timestamp_seconds" in text
            assert "tpu_node_checker_api_server_requests_total" in text
        finally:
            agg.close()
            engine.close()


# ---------------------------------------------------------------------------
# Fetch-tier hardening
# ---------------------------------------------------------------------------


class TestFetchTierHardening:
    def test_mangled_200_does_not_poison_the_etag_cache(self, tmp_path):
        servers, endpoints = _own_fleet(tmp_path, [("us-a", 3)])
        engine = FederationEngine(_args(endpoints, extra=("--federate-workers", "1")))
        try:
            engine.round()
            servers["us-a"].publish(_Round(_round_payload("us-a", 4), 0))
            session = engine._session(0)
            real_get = session.get
            corrupt = [True]

            def truncating_get(url, **kw):
                resp = real_get(url, **kw)
                if url.endswith("/api/v1/nodes") and corrupt[0]:
                    corrupt[0] = False
                    resp._body = resp._body[:-10]
                return resp

            session.get = truncating_get
            engine.round()
            view = engine.views["us-a"]
            assert view.stale and "ValueError" in view.last_error
            snap = engine.round()
            assert not engine.views["us-a"].stale
            assert json.loads(snap.entity("global/nodes").raw)["count"] == 4
        finally:
            engine.close()
            for srv in servers.values():
                srv.close()

    def test_fetch_tier_fingerprints_etagless_bodies(self, tmp_path):
        servers, endpoints = _own_fleet(tmp_path, [("us-a", 2)])
        upstream = servers["us-a"]
        engine = FederationEngine(_args(endpoints))
        try:
            view = engine.views["us-a"]
            bodies = {"/api/v1/nodes": _req(upstream.port, "GET", "/api/v1/nodes")[2],
                      "/api/v1/summary": _req(upstream.port, "GET", "/api/v1/summary")[2]}

            class _StrippedResp:
                def __init__(self, body):
                    self.status_code, self.content, self.headers = 200, body, {}

                def json(self):
                    return json.loads(self.content)

            session = types.SimpleNamespace(
                get=lambda url, headers=None, timeout=None: _StrippedResp(
                    bodies["/" + url.split("/", 3)[3]]))
            engine._fetch_cluster(session, view)
            assert view.nodes_etag is None
            fp = view.nodes_fp
            assert fp and fp.startswith("sha256:")
            engine._fetch_cluster(session, view)
            assert view.nodes_fp == fp
            upstream.publish(_Round(_round_payload("us-a", 5), 0))
            bodies["/api/v1/nodes"] = _req(upstream.port, "GET", "/api/v1/nodes")[2]
            engine._fetch_cluster(session, view)
            assert view.nodes_fp != fp
        finally:
            engine.close()
            upstream.close()

    def test_dead_cluster_backs_off_without_starving_shardmates(self, tmp_path):
        servers, endpoints = _own_fleet(tmp_path, [("us-a", 2), ("eu-b", 2)])
        engine = FederationEngine(_args(endpoints, extra=("--federate-workers", "1")))
        try:
            dead_port = servers["eu-b"].port
            servers["eu-b"].close()
            for _ in range(6):
                engine.round()
            dead = engine.views["eu-b"]
            assert dead.fetch_errors == 4, dead.fetch_errors
            ok, _, detail = engine.readiness()
            assert ok
            assert detail["clusters"]["eu-b"]["breaker_backoff_rounds"] == 2
            engine.round()
            engine.round()
            assert dead.fetch_errors == 4
            assert dead.rounds_behind == 8
            mate = engine.views["us-a"]
            assert not mate.stale and mate.fetch_not_modified == 2 * 7
            servers["eu-b"] = _fixture_cluster("eu-b", 2, port=dead_port)
            engine.round()
            assert not dead.stale and dead.backoff_skip == 0
        finally:
            engine.close()
            for srv in servers.values():
                srv.close()

    def test_shard_transitions_logged_once_per_edge(self, tmp_path, capsys):
        servers, endpoints = _own_fleet(tmp_path, [("us-a", 2), ("eu-b", 2)])
        engine = FederationEngine(_args(endpoints))
        try:
            port = servers["eu-b"].port
            engine.round()
            assert "shard" not in capsys.readouterr().err
            servers["eu-b"].close()
            engine.round()
            err = capsys.readouterr().err
            event = json.loads([x for x in err.splitlines() if '"shard-degraded"' in x][0])
            assert event["shard"] == "eu-b" and event["trace_id"]
            assert "us-a" not in err
            engine.round()
            assert "shard-degraded" not in capsys.readouterr().err
            servers["eu-b"] = _fixture_cluster("eu-b", 2, port=port)
            engine.round()
            err = capsys.readouterr().err
            event = json.loads([x for x in err.splitlines() if '"shard-recovered"' in x][0])
            assert event["shard"] == "eu-b"
            engine.round()
            assert "shard" not in capsys.readouterr().err
        finally:
            engine.close()
            for srv in servers.values():
                srv.close()


# ---------------------------------------------------------------------------
# Streaming federation (--federate-feed)
# ---------------------------------------------------------------------------


def _feed_args(path, extra=(), cli=port_cli):
    return _args(path, extra=("--federate-feed", *extra), cli=cli)


def _wait_streams(engine):
    """Bounded wait for every upstream stream to be open with verified
    state."""
    deadline = time.perf_counter() + 10.0
    while True:
        clients = dict(engine._feeds)
        if len(clients) == len(engine.views) and all(
                c._state is not None for c in clients.values()):
            return
        assert time.perf_counter() < deadline, (
            f"streams never opened: {len(clients)}/{len(engine.views)}")
        time.sleep(0.01)  # tnc: allow-test-wall-clock(bounded 10s wait for REAL stream threads to verify their seeded state)


def _wait_applied(client, target_etag, what="frame"):
    """Bounded wait for the client's applied cursor to reach the etag just
    published."""
    deadline = time.perf_counter() + 10.0
    while True:
        with client._lock:
            state = client._state
        if state is not None and state[0] == target_etag:
            return
        assert time.perf_counter() < deadline, f"{what} never applied"
        time.sleep(0.01)  # tnc: allow-test-wall-clock(bounded 10s wait for a REAL pushed frame to fold and digest-verify)


class TestStreamingFederation:
    def test_steady_stream_round_costs_zero_fetches(self, tmp_path):
        servers, endpoints = _own_fleet(tmp_path, [("us-a", 4), ("eu-b", 3)])
        engine = FederationEngine(_feed_args(endpoints))
        try:
            first = engine.round()
            _wait_streams(engine)
            before = {n: dict(srv.stats.requests) for n, srv in servers.items()}
            second = engine.round()
            third = engine.round()
            for name, srv in servers.items():
                assert set(_delta(srv, before[name])) <= {("GET", "/api/v1/watch", 200)}
            assert second.entity("global/nodes") is first.entity("global/nodes")
            assert third.entity("global/nodes") is first.entity("global/nodes")
        finally:
            engine.close()
            for srv in servers.values():
                srv.close()

    def test_stream_view_is_byte_identical_to_poll_view(self, tmp_path):
        servers, endpoints = _own_fleet(tmp_path, [("us-a", 6)])
        stream = FederationEngine(_feed_args(endpoints))
        poll = FederationEngine(_args(endpoints))
        try:
            stream.round()
            poll.round()
            _wait_streams(stream)
            payload = _round_payload("us-a", 6, healthy=False)
            servers["us-a"].publish(_Round(payload, payload["exit_code"]))
            _wait_applied(stream._feeds["us-a"], servers["us-a"]._snap.entities["nodes"].etag)
            stream_snap, poll_snap = stream.round(), poll.round()
            sv, pv = stream.views["us-a"], poll.views["us-a"]
            assert sv.nodes_entries == pv.nodes_entries
            assert sv.nodes_etag == pv.nodes_etag
            assert sv.summary_doc == pv.summary_doc
            s_doc = json.loads(stream_snap.entity("global/nodes").raw)
            p_doc = json.loads(poll_snap.entity("global/nodes").raw)
            for doc in (s_doc, p_doc):
                doc.pop("ts", None)
                doc.pop("round", None)
            assert s_doc == p_doc
            assert sv.block() == pv.block()
        finally:
            stream.close()
            poll.close()
            for srv in servers.values():
                srv.close()

    def test_feedless_upstream_silently_falls_back_to_polling(self, tmp_path, capsys):
        servers, endpoints = _own_fleet(tmp_path, [("us-a", 3)], feed=False)
        engine = FederationEngine(_feed_args(endpoints))
        try:
            engine.round()
            deadline = time.perf_counter() + 10.0
            while "us-a" not in engine._feed_unsupported:
                engine.round()
                assert time.perf_counter() < deadline, "404 probe never landed"
                time.sleep(0.01)  # tnc: allow-test-wall-clock(bounded 10s wait for the REAL probe thread's 404 exit)
            before = dict(servers["us-a"].stats.requests)
            engine.round()
            engine.round()
            assert _delta(servers["us-a"], before) == {
                ("GET", "/api/v1/summary", 304): 2,
                ("GET", "/api/v1/nodes", 304): 2,
            }
            assert engine._feeds == {}
            assert not engine.views["us-a"].stale
            assert "feed-lost" not in capsys.readouterr().err
        finally:
            engine.close()
            for srv in servers.values():
                srv.close()

    def test_dead_feed_degrades_only_its_shard(self, tmp_path, capsys):
        servers, endpoints = _own_fleet(tmp_path, [("us-a", 4), ("eu-b", 3)])
        engine = FederationEngine(_feed_args(endpoints))
        agg = FleetStateServer(0, host="127.0.0.1", federation=True,
                               readiness=engine.readiness)
        try:
            engine.round(agg)
            _wait_streams(engine)
            mate_before = dict(servers["us-a"].stats.requests)
            dead_client = engine._feeds["eu-b"]
            servers["eu-b"].close()
            dead_client.thread.join(timeout=10)
            assert not dead_client.thread.is_alive(), "stream outlived server"
            engine.round(agg)
            err = capsys.readouterr().err
            event = json.loads([x for x in err.splitlines() if '"feed-lost"' in x][0])
            assert event["cluster"] == "eu-b" and "us-a" not in err
            assert engine.views["eu-b"].stale and not engine.views["us-a"].stale
            assert set(_delta(servers["us-a"], mate_before)) <= {
                ("GET", "/api/v1/watch", 200)}
            summary = json.loads(_req(agg.port, "GET", "/api/v1/global/summary")[2])
            assert summary["degraded_clusters"] == ["eu-b"]
            assert summary["total_nodes"] == 7
        finally:
            agg.close()
            engine.close()
            for srv in servers.values():
                srv.close()

    def test_restart_resumes_at_cursor_without_resync(self, tmp_path):
        servers, endpoints = _own_fleet(tmp_path, [("us-a", 5)])
        upstream = servers["us-a"]
        first = FederationEngine(_feed_args(endpoints))
        try:
            first.round()
            _wait_streams(first)
            payload = _round_payload("us-a", 5, healthy=False)
            upstream.publish(_Round(payload, payload["exit_code"]))
            _wait_applied(first._feeds["us-a"], upstream._snap.entities["nodes"].etag)
            first.round()
        finally:
            first.close()
        restarted = FederationEngine(_feed_args(endpoints))
        try:
            resyncs_before = upstream._feed.stats()[1]
            restarted.round()
            _wait_streams(restarted)
            assert upstream._feed.stats()[1] == resyncs_before
            before = dict(upstream.stats.requests)
            upstream.publish(_Round(_round_payload("us-a", 5)))
            _wait_applied(restarted._feeds["us-a"], upstream._snap.entities["nodes"].etag)
            snap = restarted.round()
            assert json.loads(snap.entity("global/summary").raw)["healthy"] is True
            assert set(_delta(upstream, before)) <= {("GET", "/api/v1/watch", 200)}
        finally:
            restarted.close()
            upstream.close()

    def test_aggregator_of_aggregators_stacks_by_construction(self, tmp_path):
        servers, endpoints = _own_fleet(tmp_path, [("leaf-a", 3), ("leaf-b", 2)])
        mid_engine = FederationEngine(_feed_args(endpoints))
        mid_srv = FleetStateServer(0, host="127.0.0.1", federation=True,
                                   readiness=mid_engine.readiness)
        top_ep = tmp_path / "top.endpoints.json"
        _write_endpoints(top_ep, [("mid-0", mid_srv)])
        top_engine = FederationEngine(_feed_args(top_ep))
        try:
            mid_engine.round(mid_srv)
            top_snap = top_engine.round()
            view = top_engine.views["mid-0"]
            assert view.tier == "aggregator" and view.entries_key == "clusters"
            assert json.loads(top_snap.entity("global/summary").raw)["total_nodes"] == 5
            _wait_streams(mid_engine)
            _wait_streams(top_engine)
            payload = _round_payload("leaf-a", 3, healthy=False)
            servers["leaf-a"].publish(_Round(payload, payload["exit_code"]))
            _wait_applied(mid_engine._feeds["leaf-a"],
                          servers["leaf-a"]._snap.entities["nodes"].etag, what="leaf delta")
            mid_snap = mid_engine.round(mid_srv)
            _wait_applied(top_engine._feeds["mid-0"], mid_snap.entity("global/nodes").etag,
                          what="mid delta")
            top_snap = top_engine.round()
            nodes = json.loads(top_snap.entity("global/nodes").raw)
            mid_block = next(c for c in nodes["clusters"] if c["cluster"] == "mid-0")
            leaf_a = next(c for c in mid_block["clusters"] if c["cluster"] == "leaf-a")
            assert all(n["ready"] is False for n in leaf_a["nodes"])
            assert json.loads(top_snap.entity("global/summary").raw)["total_nodes"] == 5
        finally:
            top_engine.close()
            mid_srv.close()
            mid_engine.close()
            for srv in servers.values():
                srv.close()

    def test_feed_metric_families(self, tmp_path):
        servers, endpoints = _own_fleet(tmp_path, [("us-a", 3)])
        engine = FederationEngine(_feed_args(endpoints))
        agg = FleetStateServer(0, host="127.0.0.1", federation=True,
                               readiness=engine.readiness)
        try:
            engine.round(agg)
            _wait_streams(engine)
            servers["us-a"].publish(_Round(_round_payload("us-a", 3)))
            _wait_applied(engine._feeds["us-a"], servers["us-a"]._snap.entities["nodes"].etag)
            engine.round(agg)
            text = _req(agg.port, "GET", "/metrics")[2].decode()
            assert ('tpu_node_checker_federation_feed_frames_total'
                    '{cluster="us-a",kind="delta"} 1') in text
            assert ('tpu_node_checker_federation_feed_frames_total'
                    '{cluster="us-a",kind="resync"} 0') in text
            assert "tpu_node_checker_federation_feed_resyncs_total" in text
            assert 'tpu_node_checker_federation_feed_lag_seconds{cluster="us-a"}' in text
        finally:
            agg.close()
            engine.close()
            for srv in servers.values():
                srv.close()

    def test_poll_mode_without_flag_never_touches_watch(self, tmp_path):
        servers, endpoints = _own_fleet(tmp_path, [("us-a", 2)])
        engine = FederationEngine(_args(endpoints))
        try:
            engine.round()
            engine.round()
            assert engine.feed_mode is False and engine._feeds == {}
            assert not any(path == "/api/v1/watch"
                           for (_m, path, _s) in servers["us-a"].stats.requests)
        finally:
            engine.close()
            for srv in servers.values():
                srv.close()


# ---------------------------------------------------------------------------
# CLI validation, word for word against the JAX CLI
# ---------------------------------------------------------------------------


def _outcome(cli, argv, capsys):
    try:
        args = cli.parse_args(argv)
    except SystemExit as exc:
        return ("usage", exc.code, capsys.readouterr().err.strip().splitlines()[-1]
                .split("error: ", 1)[-1])
    return ("parsed", {k: v for k, v in vars(args).items() if k != "device"})


def _same_outcome(argv, capsys):
    port, jax = _outcome(port_cli, argv, capsys), _outcome(jax_cli, argv, capsys)
    assert port == jax
    return port


class TestFederateCliValidation:
    def test_requires_serve(self, capsys):
        assert _same_outcome(["--federate", "eps.json"], capsys) == (
            "usage", 2, "--federate requires --serve PORT (serving the merged global view "
            "is the aggregator's whole job)")

    @pytest.mark.parametrize("extra", [
        ["--watch", "30"], ["--kubeconfig", "kc"], ["--cluster-name", "x"],
        ["--nodes-json", "f.json"], ["--probe"], ["--history", "h.jsonl"],
        ["--log-jsonl", "t.jsonl"], ["--slack-webhook", "https://hooks.example"],
        ["--cordon-failed"], ["--serve-token", "t"], ["--write-rps", "5"], ["--json"],
        ["--debug"],
    ])
    def test_round_and_write_flags_rejected(self, extra, capsys):
        kind, code, message = _same_outcome(
            ["--federate", "eps.json", "--serve", "0", *extra], capsys)
        assert (kind, code) == ("usage", 2)
        assert message == (f"--federate runs no check rounds (and serves no write path): "
                           f"{extra[0]} would silently do nothing")

    @pytest.mark.parametrize("extra", [
        ["--federate-interval", "5"], ["--federate-workers", "2"], ["--federate-feed"],
    ])
    def test_federate_knobs_require_federate(self, extra, capsys):
        assert _same_outcome(["--serve", "0", "--history", "h.jsonl", *extra], capsys) == (
            "usage", 2, f"{extra[0]} requires --federate")

    @pytest.mark.parametrize("extra,message", [
        (["--federate-interval", "0"], "--federate-interval must be a positive number of "
         "seconds"),
        (["--federate-interval", "-1"], "--federate-interval must be a positive number of "
         "seconds"),
        (["--federate-workers", "0"], "--federate-workers must be at least 1"),
    ])
    def test_bounds(self, extra, message, capsys):
        assert _same_outcome(["--federate", "eps.json", "--serve", "0", *extra],
                             capsys) == ("usage", 2, message)

    def test_accepted_shape(self, capsys):
        argv = ["--federate", "eps.json", "--serve", "8080", "--federate-interval", "5",
                "--federate-workers", "8", "--federate-feed", "--serve-workers", "2",
                "--retry-budget", "3", "--fleet-disruption-budget", "4/10m", "--event-log",
                "ev.jsonl", "--trace", "t.json"]
        kind, args = _same_outcome(argv, capsys)
        assert kind == "parsed"
        assert (args["federate"], args["federate_interval"], args["federate_workers"],
                args["federate_feed"], args["fleet_disruption_budget"]) == (
            "eps.json", 5.0, 8, True, "4/10m")

    @pytest.mark.parametrize("argv", [
        ["--fleet-disruption-budget", "2"],
        ["--federate", "e", "--serve", "0", "--fleet-disruption-budget", "2/0"],
        ["--federate", "e", "--serve", "0", "--fleet-disruption-budget", "x"],
        ["--emit-probe", "-", "--fleet-disruption-budget", "2"],
        ["--serve", "0", "--history", "h", "--fleet-disruption-budget", "2"],
        ["--federate", "e", "--serve", "0", "--slice-floor-pct", "50"],
        ["--federate", "e", "--serve", "70000"],
        ["--serve", "0", "--event-log", "e"],
        ["--federate", "e", "--serve", "0", "--event-log", "e"],
        ["--federate", "e", "--serve", "0", "--metrics-port", "0"],
    ])
    def test_fleet_budget_and_serving_rules_equal_jax(self, argv, capsys):
        _same_outcome(argv, capsys)

    def test_dispatch_runs_federate_before_the_loop(self, monkeypatch):
        calls = []
        monkeypatch.setattr(port_aggregator, "federate", lambda args: calls.append(args) or 143)
        assert port_cli.main(["--federate", "e.json", "--serve", "0"]) == 143
        assert calls[0].federate == "e.json"


# ---------------------------------------------------------------------------
# Federated analytics: sketch blocks across the tier boundary
# ---------------------------------------------------------------------------


def _slo_fixture(cluster, avails):
    """A per-cluster slo document as ``queries.build_analytics_docs`` makes
    it: mergeable sketches beside the percentile text."""
    return {
        "fleet": {
            "nodes": len(avails),
            "availability_pct": None, "mtbf_s": None, "mttr_s": None,
            "sketches": {
                "availability_pct": port_sketch.sketch_of(avails).to_doc(),
                "mtbf_s": None, "mttr_s": None,
            },
        },
        "groups": [],
        "streams": {},
        "offenders": [{"node": f"{cluster}-node-0", "availability_pct": min(avails),
                       "flips": 3, "mttr_s": 45.0, "last_ok": True}],
        "sketch_alpha": port_sketch.DEFAULT_ALPHA,
        "source": "rollups",
    }


class TestGlobalAnalytics:
    def test_endpoint_merges_and_survives_missing_upstreams(self, tmp_path):
        servers, endpoints = _own_fleet(tmp_path, [("us-a", 4), ("eu-b", 3)])
        engine = FederationEngine(_args(endpoints))
        agg = FleetStateServer(0, host="127.0.0.1", federation=True,
                               readiness=engine.readiness)
        try:
            engine.round(agg)
            status, _, body = _req(agg.port, "GET", "/api/v1/global/analytics")
            assert status == 404 and b"analytics" in body
            servers["us-a"].publish_analytics(
                {"slo": _slo_fixture("us-a", [91.0, 97.5, 99.9, 100.0])})
            servers["us-a"].publish(_Round(_round_payload("us-a", 5), 0))
            engine.round(agg)
            status, headers, body = _req(agg.port, "GET", "/api/v1/global/analytics")
            assert status == 200
            doc = json.loads(body)
            assert doc["source"] == "sketches" and set(doc["clusters"]) == {"us-a"}
            assert doc["fleet"]["nodes"] == 4
            assert abs(doc["fleet"]["availability_pct"]["p50"] - 97.5) <= 0.01 * 97.5
            assert doc["offenders"][0]["cluster"] == "us-a"
            assert _req(agg.port, "GET", "/api/v1/global/analytics",
                        headers={"If-None-Match": headers["ETag"]})[0] == 304
        finally:
            agg.close()
            engine.close()
            for srv in servers.values():
                srv.close()

    def test_analytics_slo_block_rides_the_delta_feed(self, tmp_path):
        servers, endpoints = _own_fleet(tmp_path, [("us-a", 4)])
        engine = FederationEngine(_feed_args(endpoints))
        try:
            engine.round()
            _wait_streams(engine)
            servers["us-a"].publish_analytics(
                {"slo": _slo_fixture("us-a", [88.0, 99.0, 100.0])})
            client = dict(engine._feeds)["us-a"]
            deadline = time.perf_counter() + 10.0
            while True:
                with client._lock:
                    if "analytics_slo" in client._blocks:
                        break
                assert time.perf_counter() < deadline, "block never arrived"
                time.sleep(0.01)  # tnc: allow-test-wall-clock(bounded 10s wait for a REAL pushed analytics_slo frame)
            before = dict(servers["us-a"].stats.requests)
            snap = engine.round()
            assert set(_delta(servers["us-a"], before)) <= {("GET", "/api/v1/watch", 200)}
            assert engine.views["us-a"].analytics_doc is not None
            doc = json.loads(snap.entities["global/analytics"].raw)
            assert doc["fleet"]["nodes"] == 3 and set(doc["clusters"]) == {"us-a"}
        finally:
            engine.close()
            for srv in servers.values():
                srv.close()


# ---------------------------------------------------------------------------
# The port's aggregator beside the JAX aggregator, over the same upstreams
# ---------------------------------------------------------------------------


def _masked(obj):
    if isinstance(obj, dict):
        return {k: "<masked>" if k in MASKED_KEYS or k.endswith(MASKED_SUFFIXES)
                else _masked(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_masked(v) for v in obj]
    return obj


class _Pinned:
    """The wall clock both aggregators read: one second a round."""

    def __init__(self):
        self.t = 1_700_000_001.0

    def __call__(self):
        return self.t


def _side(package, endpoints, extra=()):
    """An aggregator as ``federate`` builds it, on one package."""
    aggregator, app, cli = {
        "port": (port_aggregator, port_app, port_cli),
        "jax": (jax_aggregator, jax_app, jax_cli),
    }[package]
    engine = aggregator.FederationEngine(_args(endpoints, extra=extra, cli=cli))
    server = app.FleetStateServer(
        0, host="127.0.0.1", federation=True, readiness=engine.readiness,
        lease=engine.lease_budget.grant if engine.lease_budget is not None else None)
    return engine, server


def _read_global(port, etags):
    got = {}
    for path in GLOBAL_PATHS:
        status, headers, body = _req(port, "GET", path)
        doc = json.loads(body) if body else None
        got[path] = (status, headers.get("X-TNC-Round"), _masked(doc))
        if path in etags and "ETag" in headers:
            got[path + " 304"] = _req(port, "GET", path,
                                      headers={"If-None-Match": etags[path]})[0]
        if "ETag" in headers:
            etags[path] = headers["ETag"]
    status, headers, gz = _req(port, "GET", "/api/v1/global/nodes",
                               headers={"Accept-Encoding": "gzip"})
    raw = _req(port, "GET", "/api/v1/global/nodes")[2]
    got["gzip"] = headers.get("Content-Encoding") == "gzip" and gzip.decompress(gz) == raw
    status, headers, body = _req(port, "HEAD", "/api/v1/global/nodes")
    got["head"] = (status, body, headers.get("Content-Length") == str(len(raw)))
    metrics = _req(port, "GET", "/metrics")[2].decode().splitlines()
    got["metrics"] = sorted(
        x for x in metrics if x.startswith("tpu_node_checker_federation_")
        and not any(m in x for m in UNCOMPARED_METRICS))
    return got


class TestAgainstJax:
    @pytest.mark.parametrize("feed", [False, True], ids=["poll", "feed"])
    def test_global_bodies_equal_jax(self, tmp_path, monkeypatch, feed):
        # Rounds over the same upstreams: both fresh; us-a republished
        # unhealthy with analytics; eu-b stopped (its shard alone stale);
        # eu-b back on its port (recovered).
        clock = _Pinned()
        monkeypatch.setattr(time, "time", clock)
        servers, endpoints = _own_fleet(tmp_path, [("us-a", 5), ("eu-b", 3)])
        extra = ("--federate-workers", "2", "--federate-feed") if feed else (
            "--federate-workers", "2")
        sides = {p: _side(p, endpoints, extra) for p in ("port", "jax")}
        etags = {p: {} for p in sides}
        seen = {p: [] for p in sides}

        def step():
            clock.t += 1.0
            for p, (engine, server) in sides.items():
                engine.round(server)
                seen[p].append(_read_global(server.port, etags[p]))

        try:
            step()
            payload = _round_payload("us-a", 5, healthy=False)
            servers["us-a"].publish_analytics(
                {"slo": _slo_fixture("us-a", [91.0, 97.5, 100.0])})
            servers["us-a"].publish(_Round(payload, payload["exit_code"]))
            if feed:
                for engine, _ in sides.values():
                    _wait_streams(engine)
                    _wait_applied(engine._feeds["us-a"],
                                  servers["us-a"]._snap.entities["nodes"].etag)
            step()
            port = servers["eu-b"].port
            servers["eu-b"].close()
            if feed:
                for engine, _ in sides.values():
                    engine._feeds["eu-b"].thread.join(timeout=10)
            step()
            servers["eu-b"] = _fixture_cluster("eu-b", 3, port=port)
            step()
        finally:
            for engine, server in sides.values():
                server.close()
                engine.close()
            for srv in servers.values():
                srv.close()
        assert seen["port"] == seen["jax"]
        summaries = [r["/api/v1/global/summary"][2] for r in seen["port"]]
        assert [s["degraded_clusters"] for s in summaries] == [[], [], ["eu-b"], []]
        assert [s["healthy"] for s in summaries] == [True, False, False, False]
        assert seen["port"][1]["/api/v1/global/analytics"][0] == 200
        assert all(r["gzip"] and r["head"][:2] == (200, b"") for r in seen["port"])

    def test_lease_grants_and_denials_equal_jax(self, tmp_path, fleet):
        # --fleet-disruption-budget 1/10m: the first cordon is granted, the
        # second in the window denied (allowance 0), malformed asks 400.
        asks = [{"count": 1, "action": "cordon", "node": "a", "cluster": "us-a"},
                {"count": 1, "action": "cordon", "node": "b", "cluster": "eu-b"},
                {"count": 0}, {"count": True}, "[1]", "{not json"]
        got = {}
        for package in ("port", "jax"):
            engine, server = _side(package, fleet.files["both"],
                                   ("--fleet-disruption-budget", "1/10m"))
            try:
                engine.round(server)
                got[package] = [
                    _req(server.port, "POST", "/api/v1/global/disruption-lease",
                         headers={"Content-Type": "application/json"},
                         body=a if isinstance(a, str) else json.dumps(a))[::2]
                    for a in asks]
                got[package].append(sorted(
                    x for x in _req(server.port, "GET", "/metrics")[2].decode().splitlines()
                    if x.startswith(("tpu_node_checker_federation_lease",
                                     "tpu_node_checker_federation_fleet_budget"))))
            finally:
                server.close()
                engine.close()
        assert got["port"] == got["jax"]
        statuses = [s for s, _ in got["port"][:-1]]
        assert statuses == [200, 409, 400, 400, 400, 400]
        bodies = [json.loads(b) for _, b in got["port"][:2]]
        assert [b["granted"] for b in bodies] == [True, False]
        assert bodies[1]["remaining"] == 0

    def test_lease_without_a_fleet_budget_is_404_as_jax(self, fleet):
        got = {}
        for package in ("port", "jax"):
            engine, server = _side(package, fleet.files["us-a"])
            try:
                engine.round(server)
                got[package] = _req(server.port, "POST", "/api/v1/global/disruption-lease",
                                    body=json.dumps({"count": 1}))[::2]
            finally:
                server.close()
                engine.close()
        assert got["port"] == got["jax"] and got["port"][0] == 404

    def test_federate_loop_events_and_trace_equal_jax(self, tmp_path, monkeypatch, fleet):
        # The mode loop of each CLI: one round, its --event-log lines and
        # its --trace document (the upstream's round stitched in), then
        # SIGTERM's 143.
        got = {}
        for package, checker, cli in (("port", port_checker, port_cli),
                                      ("jax", importlib.import_module(
                                          "tpu_node_checker.checker"), jax_cli)):
            monkeypatch.setattr(checker, "_wait_for_next_round", lambda stop, s: True)
            trace, events = tmp_path / f"{package}.trace", tmp_path / f"{package}.events"
            rc = cli.main(["--federate", str(fleet.files["us-a"]), "--serve", "0",
                           "--retry-budget", "0", "--trace", str(trace),
                           "--event-log", str(events)])
            doc = json.loads(trace.read_text())
            tracks = sorted(e["args"]["name"] for e in doc["traceEvents"]
                            if e.get("name") == "process_name")
            got[package] = (rc, tracks, doc["otherData"]["mode"],
                            events.read_text() if events.exists() else "")
        assert got["port"] == got["jax"]
        assert got["port"][0] == 143
