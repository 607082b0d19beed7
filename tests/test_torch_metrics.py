"""The port's emitter scrape, held against the JAX package's.

``tpu_node_checker_torch/metrics.py`` copies the families an emitter pod
serves (``tpu_node_checker_probe_*``, ``exit_code``, ``check_duration_ms``,
``last_run_timestamp_seconds``) and the ``MetricsServer`` that serves them,
over copies of the JAX package's router and entity
(``tpu_node_checker_torch/server/router.py`` and ``server/snapshot.py``).  The PrometheusRule and the
dashboards read these names, so each body here must equal JAX's byte for
byte, with the clock pinned in both modules, and each HTTP exchange must
give the same status, headers and body.

torch and the port are reached through ``importlib.import_module``:
tests/test_dependency_surface.py rejects any other ``import`` in tests/.
"""

import gzip
import http.client
import importlib
from http.server import BaseHTTPRequestHandler

import pytest

from tpu_node_checker import checker as jax_checker
from tpu_node_checker import metrics as jax_metrics
from tpu_node_checker.server import router as jax_router
from tpu_node_checker.server import snapshot as jax_snapshot

port_metrics = importlib.import_module("tpu_node_checker_torch.metrics")
port_router = importlib.import_module("tpu_node_checker_torch.server.router")
port_snapshot = importlib.import_module("tpu_node_checker_torch.server.snapshot")

NOW = 1_760_000_123.25


class PinnedClock:
    @staticmethod
    def time():
        return NOW


@pytest.fixture
def pinned(monkeypatch):
    """The scrape's timestamp and the HTTP Date header, pinned in both."""
    monkeypatch.setattr(jax_metrics, "time", PinnedClock)
    monkeypatch.setattr(port_metrics, "time", PinnedClock)
    monkeypatch.setattr(BaseHTTPRequestHandler, "date_time_string",
                        lambda self, timestamp=None: "Sat, 17 Oct 2026 08:00:00 GMT")


BASE = {
    "ok": True, "level": "compute", "hostname": "gke-h100-0", "elapsed_ms": 7412.5,
    "device_count": 1, "platform": "gpu", "device_kinds": ["NVIDIA H100 80GB HBM3"],
    "schema": 1, "written_at": NOW - 1.0,
}

REPORTS = {
    "compute": {**BASE, "matmul_tflops": 428.442, "int8_tops": 42.061, "hbm_gbps": 2410.85,
                "dma_gbps": 97.75, "dispatch_overhead_ms": 0.03},
    "enumerate": {**BASE, "level": "enumerate"},
    "failed": {**BASE, "ok": False, "error": "dma_stream mismatch", "matmul_tflops": 300},
    "hbm capacity": {**BASE, "hbm_capacity": {"generation": "h100", "min_gb": 79.6,
                                              "ok": True, "expected_gb": 80}},
    "hbm capacity without min_gb": {**BASE, "hbm_capacity": {"skipped": "no limit"}},
    "perf floor with ratios": {**BASE, "perf_floor": {
        "generation": "custom", "ok": False, "failed": ["int8_tops"],
        "ratios": {"matmul_tflops": 0.9871, "int8_tops": 0.05, "hbm_gbps": 1.0112}}},
    "perf floor skipped": {**BASE, "perf_floor": {"skipped": "platform 'gpu' has no table"}},
    "ici axes": {**BASE, "level": "collective", "device_count": 4, "collective_ok": True,
                 "ring_ok": False, "collective_busbw_gbps": 58.3, "ring_link_gbps": 17.7,
                 "ici_axis_ok": {"t0": True, "t1": False},
                 "ici_axis_busbw_gbps": {"t1": 9.4, "t0": 31.5, "bogus": "n/a"}},
    "fault domains": {**BASE, "level": "collective", "device_count": 4,
                      "fault_domain_ok": {"dcn": False, "t0": True},
                      "fault_domain_busbw_gbps": {"dcn": 12.0, "t0": 40.25},
                      "dcn_busbw_gbps": 12.0},
    "bad links empty": {**BASE, "level": "collective", "ring_bad_links": []},
    "bad links named": {**BASE, "level": "collective", "ring_bad_links": ["0->1", "2->3"]},
    "bool telemetry left out": {**BASE, "matmul_tflops": True, "int8_tops": None,
                                "device_count": False, "workload_step_ms": 12.5,
                                "collective_ok": "yes"},
    "label escaping": {**BASE, "level": 'com"pu\\te\n'},
}


def _bodies(report, rc, override=None):
    jax = jax_metrics.render_metrics(
        jax_checker.CheckResult(exit_code=rc, payload={"local_probe": report}),
        exit_code_override=override)
    port = port_metrics.render_metrics(
        port_metrics.CheckResult(exit_code=rc, payload={"local_probe": report}),
        exit_code_override=override)
    return jax, port


@pytest.mark.usefixtures("pinned")
class TestRender:
    @pytest.mark.parametrize("case", list(REPORTS))
    def test_body_equals_jax(self, case):
        report = REPORTS[case]
        jax, port = _bodies(report, 0 if report["ok"] else 3)
        assert port == jax
        assert f"tpu_node_checker_last_run_timestamp_seconds {NOW}\n" in port

    def test_every_probe_family_is_reached(self):
        names = set()
        for report in REPORTS.values():
            _, port = _bodies(report, 0)
            names |= {ln.split()[2] for ln in port.splitlines() if ln.startswith("# TYPE")}
        probe = {n for n in names if n.startswith("tpu_node_checker_probe_")}
        assert probe == {f"tpu_node_checker_probe_{s}" for s in (
            "ok", "devices", "matmul_tflops", "int8_tops", "hbm_gbps", "dma_gbps",
            "collective_busbw_gbps", "dcn_busbw_gbps", "dispatch_overhead_ms",
            "ring_link_gbps", "workload_step_ms", "collective_ok", "ring_ok",
            "hbm_capacity_ok", "hbm_min_gb", "perf_floor_ok", "perf_floor_ratio",
            "ici_axis_ok", "axis_busbw_gbps", "fault_domain_ok", "ring_bad_links",
            "ring_bad_link")}
        assert names - probe == {"tpu_node_checker_exit_code",
                                 "tpu_node_checker_check_duration_ms",
                                 "tpu_node_checker_last_run_timestamp_seconds"}

    def test_exit_code_override_and_empty_payload_equal_jax(self):
        assert _bodies(REPORTS["compute"], 0, override=1)[0] == \
            _bodies(REPORTS["compute"], 0, override=1)[1]
        jax = jax_metrics.render_metrics(jax_checker.CheckResult(exit_code=1, payload={}))
        port = port_metrics.render_metrics(port_metrics.CheckResult(exit_code=1))
        assert port == jax

    def test_duration_is_the_probes_elapsed_ms(self):
        _, port = _bodies(REPORTS["compute"], 0)
        assert "tpu_node_checker_check_duration_ms 7412.5\n" in port


def test_entity_and_etag_equal_jax():
    for raw in (b"", b"short", b"# HELP x\n" * 100):
        port = port_snapshot.Entity(raw, port_metrics.METRICS_CONTENT_TYPE)
        jax = jax_snapshot.Entity(raw, jax_metrics.METRICS_CONTENT_TYPE)
        assert (port.etag, port.gz, port.content_type) == (jax.etag, jax.gz, jax.content_type)
        assert port.etag == jax_snapshot.entity_tag(raw) == port_snapshot.entity_tag(raw)
    assert (port_snapshot._GZIP_LEVEL, port_snapshot._GZIP_MIN_BYTES) == (
        jax_snapshot._GZIP_LEVEL, jax_snapshot._GZIP_MIN_BYTES)


@pytest.mark.parametrize("inm,etag,want", [
    ("*", '"a"', True), ('"a"', '"a"', True), ('W/"a"', '"a"', True),
    ('"b", W/"a"', '"a"', True), ('"b"', '"a"', False), ("", '"a"', False),
])
def test_etag_matching_equals_jax(inm, etag, want):
    assert port_router._etag_matches(inm, etag) == jax_router._etag_matches(inm, etag) == want


@pytest.mark.parametrize("method,path", [
    ("GET", "/metrics"), ("HEAD", "/metrics"), ("GET", "/"), ("GET", "/%6Detrics"),
    ("POST", "/metrics"), ("DELETE", "/"), ("GET", "/nope"), ("GET", "/metrics/x"),
])
def test_routing_equals_jax(method, path):
    def table(mod):
        r = mod.Router()
        r.add("GET", "/metrics", lambda req: mod.Response(200, b"m"))
        r.add("GET", "/", lambda req: mod.Response(200, b"m"))
        resolved = r.resolve(method, path)
        if isinstance(resolved, mod.Response):
            return resolved.status, resolved.body, resolved.headers
        return resolved[2]

    assert table(port_router) == table(jax_router)


def _exchange(port, method="GET", path="/metrics", headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request(method, path, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.getheaders(), resp.read()
    finally:
        conn.close()


def _servers():
    return (jax_metrics.MetricsServer(0, host="127.0.0.1"),
            port_metrics.MetricsServer(0, host="127.0.0.1"))


def _close(*servers):
    for s in servers:
        s.close()


@pytest.mark.usefixtures("pinned")
class TestServer:
    def test_mark_error_before_a_result_equals_jax(self):
        jax, port = _servers()
        try:
            for s in (jax, port):
                s.mark_error()
            assert _exchange(port.port) == _exchange(jax.port)
            assert _exchange(port.port)[2] == (
                b"# HELP tpu_node_checker_exit_code Exit code (1 = monitor error).\n"
                b"# TYPE tpu_node_checker_exit_code gauge\n"
                b"tpu_node_checker_exit_code 1\n")
        finally:
            _close(jax, port)

    def test_mark_error_after_a_result_equals_jax(self):
        jax, port = _servers()
        try:
            jax.update(jax_checker.CheckResult(exit_code=0,
                                               payload={"local_probe": REPORTS["compute"]}))
            port.update(port_metrics.CheckResult(exit_code=0,
                                                 payload={"local_probe": REPORTS["compute"]}))
            for s in (jax, port):
                s.mark_error()
            status, headers, body = _exchange(port.port)
            assert (status, headers, body) == _exchange(jax.port)
            assert b"tpu_node_checker_exit_code 1\n" in body
            # The timestamp's sample goes, so it goes stale; its HELP stays.
            assert b"\ntpu_node_checker_last_run_timestamp_seconds " not in body
            assert b"# HELP tpu_node_checker_last_run_timestamp_seconds" in body
            assert b"tpu_node_checker_probe_matmul_tflops 428.442\n" in body
        finally:
            _close(jax, port)

    def test_before_any_round_equals_jax(self):
        jax, port = _servers()
        try:
            assert _exchange(port.port) == _exchange(jax.port)
            assert _exchange(port.port)[2] == b"# tpu-node-checker: no check completed yet\n"
        finally:
            _close(jax, port)

    def test_every_exchange_equals_jax(self):
        jax, port = _servers()
        try:
            report = REPORTS["ici axes"]
            jax.update(jax_checker.CheckResult(exit_code=0, payload={"local_probe": report}))
            port.update(port_metrics.CheckResult(exit_code=0, payload={"local_probe": report}))
            status, headers, body = _exchange(port.port)
            etag = dict(headers)["ETag"]
            exchanges = {
                "GET /metrics": ("GET", "/metrics", {}),
                "GET /": ("GET", "/", {}),
                "HEAD": ("HEAD", "/metrics", {}),
                "304": ("GET", "/metrics", {"If-None-Match": etag}),
                "gzip": ("GET", "/metrics", {"Accept-Encoding": "gzip"}),
                "404": ("GET", "/nope", {}),
                "405": ("POST", "/metrics", {}),
            }
            got = {k: _exchange(port.port, *v) for k, v in exchanges.items()}
            assert got == {k: _exchange(jax.port, *v) for k, v in exchanges.items()}
            assert status == 200 and body.startswith(b"# HELP tpu_node_checker_probe_ok")
            hdrs = dict(got["GET /metrics"][1])
            assert hdrs["Content-Type"] == "text/plain; version=0.0.4"
            assert hdrs["Vary"] == "Accept-Encoding" and hdrs["Cache-Control"] == "no-cache"
            assert got["304"][0] == 304 and got["304"][2] == b""
            assert dict(got["304"][1])["ETag"] == etag
            assert got["HEAD"][2] == b""
            assert dict(got["HEAD"][1])["Content-Length"] == str(len(body))
            assert gzip.decompress(got["gzip"][2]) == body
            assert dict(got["gzip"][1])["Content-Encoding"] == "gzip"
            assert got["404"][0] == 404 and got["405"][0] == 405
        finally:
            _close(jax, port)

    def test_a_new_round_changes_the_etag(self, monkeypatch):
        port = port_metrics.MetricsServer(0, host="127.0.0.1")
        try:
            result = port_metrics.CheckResult(0, {"local_probe": REPORTS["compute"]})
            port.update(result)
            first = dict(_exchange(port.port)[1])["ETag"]
            monkeypatch.setattr(port_metrics, "time", type("Later", (), {
                "time": staticmethod(lambda: NOW + 300)}))
            port.update(result)
            status, headers, _ = _exchange(port.port, headers={"If-None-Match": first})
            assert status == 200 and dict(headers)["ETag"] != first
        finally:
            port.close()

    def test_close_frees_the_port(self):
        port = port_metrics.MetricsServer(0, host="127.0.0.1")
        number = port.port
        port.close()
        with pytest.raises(OSError):
            _exchange(number)
