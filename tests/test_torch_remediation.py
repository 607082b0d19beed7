"""The port's quarantine (``--cordon-failed``, ``--uncordon-recovered``,
``--drain-failed``, the repair hooks and the budget engine), held against
the JAX checker's.

Every scenario runs through both CLIs' ``main`` in this process, on the
same nodes and the same probe reports.  One fake API server per module
(an ephemeral port) serves the node LIST, applies each ``PATCH
/api/v1/nodes/NAME`` to the next LIST as a real apiserver would, serves
each node's pods and answers Eviction POSTs (429 for a pod a
PodDisruptionBudget protects); it also takes the ``--repair-webhook``
POSTs.  One fake aggregator per module answers ``POST
/api/v1/global/disruption-lease`` over the port's ``FleetLeaseBudget``, or
drops the connection when it is down.  Both are reset before each side.

The two sides must give the same exit codes, the same PATCH, eviction and
webhook bodies in the same order (the quarantine annotation's timestamp
and the webhook's ``trace_id`` aside), the same payloads less ``trace_id``
and ``timings_ms`` (and the transport's connection counts, which the
parallel PATCH workers race for, and a repair's age), the same Slack bodies, the same stderr (each event line
less ``ts`` and ``trace_id``), and under ``--watch`` the same
``--event-log`` lines and ``tpu_node_checker_remediation_*`` scrape lines.

The scenarios mirror ``tests/test_cordon.py`` and
``tests/test_remediation.py``: the legacy ``--cordon-max`` cap and its
state budget, dry run, a PATCH failure, a human cordon, an out-of-band
uncordon, a recovery that frees the budget in the same round, a
``--disruption-budget`` window, the slice floor on a TPU slice and its
exemption of GPU nodes, ``--cordon-degraded`` on a slow mesh link, a
storm whose denials are posted once, drain in
dry run and live with a PDB refusal, the fleet lease's grant, denial and
fallback after the aggregator dies, and a repair that fires once and
survives a restart.  The budget and lease scenarios also run as a
two-round ``--watch`` loop (the wait faked, nothing sleeps).

The port is reached through ``importlib.import_module``:
tests/test_dependency_surface.py rejects any other ``import`` in tests/.
"""

import copy
import http.client
import importlib
import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler
from urllib.parse import parse_qs, urlparse

import pytest

from tests import fixtures as fx
from tests.test_torch_cluster import (
    _isolated,  # noqa: F401 — the autouse fixture, for this module too
    kubeconfig,
    outcome_vs_jax,
)
from tpu_node_checker import checker as jax_checker
from tpu_node_checker import cli as jax_cli
from tpu_node_checker import metrics as jax_metrics
from tpu_node_checker import notify as jax_notify

port_checker = importlib.import_module("tpu_node_checker_torch.checker")
port_cli = importlib.import_module("tpu_node_checker_torch.cli")
port_metrics = importlib.import_module("tpu_node_checker_torch.metrics")
port_notify = importlib.import_module("tpu_node_checker_torch.notify")
port_budget = importlib.import_module("tpu_node_checker_torch.remediation.budget")

SIDES = {
    "jax": (jax_cli, jax_checker, jax_notify, jax_metrics),
    "port": (port_cli, port_checker, port_notify, port_metrics),
}
QUARANTINE = "tpu-node-checker.io/quarantined"
VOLATILE = ("trace_id", "timings_ms")
# Which pooled connection each PATCH worker picks up is a race: the
# requests sent are compared, the connections they rode are not.
POOL_RACE = ("connections_opened", "requests_reused")
LEASE_PATH = "/api/v1/global/disruption-lease"


class Cluster:
    """The fake apiserver's state: nodes (PATCHes applied), pods by node,
    the pods a PDB protects, and what it received."""

    def __init__(self):
        self.lock = threading.Lock()
        self.reset([])

    def reset(self, nodes, pods=None, pdb=(), patch_status=None):
        with self.lock:
            self.nodes = copy.deepcopy(list(nodes))
            self.pods = dict(pods or {})
            self.pdb = set(pdb)
            self.patch_status = patch_status
            self.patches, self.evictions, self.webhooks = [], [], []

    def handler(self):
        state = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _reply(self, status, doc):
                body = json.dumps(doc).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self):
                raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                return json.loads(raw) if raw else None

            def do_GET(self):  # noqa: N802 — the handler protocol's name
                url = urlparse(self.path)
                with state.lock:
                    if url.path == "/api/v1/nodes":
                        body = fx.paged_nodelist_body(state.nodes, self.path, None,
                                                      resource_version="1")
                        self.send_response(200)
                        self.send_header("Content-Type", "application/json")
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                        return
                    sel = (parse_qs(url.query).get("fieldSelector") or [""])[0]
                    items = state.pods.get(sel.rpartition("spec.nodeName=")[2], [])
                self._reply(200, {"kind": "PodList", "metadata": {}, "items": items})

            def do_PATCH(self):  # noqa: N802
                body = self._body()
                name = self.path.rpartition("/")[2]
                with state.lock:
                    state.patches.append({"node": name, "body": body})
                    if state.patch_status:
                        self._reply(state.patch_status, {"message": "injected"})
                        return
                    for node in state.nodes:
                        if node["metadata"]["name"] == name:
                            _apply_patch(node, body)
                self._reply(200, {})

            def do_POST(self):  # noqa: N802
                body = self._body()
                path = urlparse(self.path).path
                if path == "/repair":
                    with state.lock:
                        state.webhooks.append(body)
                    self._reply(200, {})
                    return
                m = re.match(r"^/api/v1/namespaces/([^/]+)/pods/([^/]+)/eviction$", path)
                if not m:
                    self._reply(404, {"message": "not found"})
                    return
                with state.lock:
                    if m.group(2) in state.pdb:
                        self._reply(429, {"kind": "Status", "reason": "TooManyRequests",
                                          "message": "Cannot evict pod as it would violate "
                                                     "the pod's disruption budget."})
                        return
                    state.evictions.append({"namespace": m.group(1), "pod": m.group(2),
                                            "body": body})
                self._reply(201, {"kind": "Status", "status": "Success"})

            def log_message(self, *args):
                pass

        return Handler


def _apply_patch(node, body):
    """A strategic-merge PATCH of ``spec.unschedulable`` and annotations."""
    spec = body.get("spec") or {}
    if "unschedulable" in spec:
        if spec["unschedulable"]:
            node["spec"]["unschedulable"] = True
        else:
            node["spec"].pop("unschedulable", None)
    for key, value in ((body.get("metadata") or {}).get("annotations") or {}).items():
        annotations = node["metadata"].setdefault("annotations", {})
        if value is None:
            annotations.pop(key, None)
        else:
            annotations[key] = value


class Aggregator:
    """The fleet lease endpoint over the port's ``FleetLeaseBudget``; when
    ``down`` it drops each connection unanswered."""

    def __init__(self):
        self.reset(1)

    def reset(self, budget, window_s=None):
        self.fleet = port_budget.FleetLeaseBudget(budget, window_s)
        self.down = False
        self.requests = []

    def handler(self):
        agg = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_POST(self):  # noqa: N802 — the handler protocol's name
                raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                if agg.down or urlparse(self.path).path != LEASE_PATH:
                    self.close_connection = True
                    return
                body = json.loads(raw)
                agg.requests.append({k: v for k, v in body.items() if k != "trace_id"})
                status, doc = agg.fleet.grant(body)
                out = json.dumps(doc).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

            def log_message(self, *args):
                pass

        return Handler


@pytest.fixture(scope="module")
def cluster():
    state = Cluster()
    server = fx.serve_http(state.handler())
    state.url = f"http://127.0.0.1:{server.server_address[1]}"
    yield state
    server.shutdown()
    server.server_close()


@pytest.fixture(scope="module")
def aggregator():
    state = Aggregator()
    server = fx.serve_http(state.handler())
    state.url = f"http://127.0.0.1:{server.server_address[1]}"
    yield state
    server.shutdown()
    server.server_close()


@pytest.fixture(autouse=True)
def _fresh_engines(monkeypatch):
    # The engine is cached across rounds in a process, as the tracker is.
    for checker in (jax_checker, port_checker):
        monkeypatch.setitem(checker._REMEDIATION_CACHE, "key", None)
        monkeypatch.setitem(checker._REMEDIATION_CACHE, "bundle", None)


def tpu_nodes(n, **kw):
    """Single-host TPU nodes of one pool (4 chips each)."""
    return [fx.make_node(f"tpu-{i}", allocatable={"google.com/tpu": "4"},
                         labels={"cloud.google.com/gke-tpu-accelerator": "tpu-v5-lite-podslice",
                                 "cloud.google.com/gke-nodepool": "p"}, **kw)
            for i in range(n)]


def gpu_nodes(n, cards=8):
    return [fx.make_node(f"gke-gpu-pool-{i}", allocatable={"nvidia.com/gpu": str(cards)})
            for i in range(n)]


def quarantined(node, cordoned=True):
    node = copy.deepcopy(node)
    node["metadata"]["annotations"] = {QUARANTINE: "1700000000"}
    if cordoned:
        node["spec"]["unschedulable"] = True
    return node


def write_reports(directory, verdicts, written_at):
    """One compute-level report per host: ``verdicts = {host: ok}``, or
    ``{host: fields}`` for a report with more than its verdict."""
    directory.mkdir(parents=True, exist_ok=True)
    for stale in directory.glob("*.json"):
        stale.unlink()
    for host, ok in verdicts.items():
        extra = ok if isinstance(ok, dict) else {"ok": ok}
        doc = {"level": "compute", "hostname": host, "written_at": written_at,
               "error": None if extra["ok"] else "matmul numerics failed"}
        (directory / f"{host}.json").write_text(json.dumps({**doc, **extra}))


def _json_docs(text):
    docs, decoder, i = [], json.JSONDecoder(), 0
    while text[i:].strip():
        i += len(text[i:]) - len(text[i:].lstrip())
        doc, i = decoder.raw_decode(text, i)
        doc = {k: v for k, v in doc.items() if k not in VOLATILE}
        for key in POOL_RACE:
            doc.get("api_transport", {}).pop(key, None)
        # A started repair's age is a wall time.
        doc.get("remediation", {}).get("repairs", {}).pop("oldest_age_s", None)
        docs.append(doc)
    return docs


def _stderr(err, workdir):
    """The text lines in order, then the event lines (emitted from the
    actuation workers, so in any order within a sweep) sorted."""
    text, events = [], []
    for line in err.splitlines():
        if line.startswith("Serving /metrics on port"):
            continue
        if line.startswith("{"):
            doc = json.loads(line)
            events.append({k: v for k, v in doc.items() if k not in ("ts", "trace_id")})
        else:
            text.append(line.replace(str(workdir), "{dir}"))
    return text + _sorted(events)


def _patch_bodies(patches):
    """PATCH bodies with the quarantine annotation's timestamp masked."""
    out = []
    for p in copy.deepcopy(patches):
        notes = (p["body"].get("metadata") or {}).get("annotations") or {}
        if notes.get(QUARANTINE) is not None:
            notes[QUARANTINE] = "<ts>"
        out.append(p)
    return out


def _scrape(port):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", "/metrics")
        body = conn.getresponse().read().decode()
    finally:
        conn.close()
    return [line for line in body.splitlines()
            if line.startswith("tpu_node_checker_remediation")]


class Scenario:
    """The same nodes and rounds through one side's CLI.

    ``rounds`` is a list of dicts: ``verdicts`` (the round's reports),
    ``lease_down`` (the aggregator drops connections from this round on)
    and ``restart`` (a new process: the engine and tracker caches reset).
    Without ``--watch`` in ``flags`` each round is one ``main`` call;
    with it, one ``main`` runs every round and the faked wait sets up the
    next.  ``{dir}`` in a flag is the side's own directory.
    """

    def __init__(self, cluster, aggregator, nodes, rounds, flags, pods=None, pdb=(),
                 patch_status=None, lease=None):
        self.cluster, self.aggregator = cluster, aggregator
        self.nodes, self.rounds, self.flags = nodes, rounds, flags
        self.pods, self.pdb, self.patch_status, self.lease = pods, pdb, patch_status, lease
        self.written_at = time.time()  # the same reports on both sides

    def run(self, side, tmp_path, capsys, monkeypatch):
        cli, checker, notify, metrics = SIDES[side]
        workdir = tmp_path / side
        workdir.mkdir()
        reports = tmp_path / "reports"  # one directory: payloads name it
        self.cluster.reset(self.nodes, self.pods, self.pdb, self.patch_status)
        if self.lease is not None:
            self.aggregator.reset(*self.lease)
        checker.reset_client_cache()
        monkeypatch.setitem(checker._HISTORY_CACHE, "key", None)
        rec = {"slack": [], "scrapes": [], "servers": [], "rc": []}

        class Recorded(metrics.MetricsServer):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                rec["servers"].append(self)

        def send(webhook, message, **kw):
            kw.pop("trace_id", None)
            rec["slack"].append((message, kw))
            return True

        def set_up(i):
            step = self.rounds[i]
            write_reports(reports, step["verdicts"], self.written_at + i)
            if step.get("lease_down"):
                self.aggregator.down = True
            if step.get("restart"):
                checker._REMEDIATION_CACHE["key"] = None
                checker._HISTORY_CACHE["key"] = None

        def wait(stop, seconds):
            for server in rec["servers"]:
                rec["scrapes"].append(_scrape(server.port))
            done = len(rec["scrapes"])
            if done < len(self.rounds):
                set_up(done)
                return False
            return True

        monkeypatch.setattr(notify, "send_slack_message", send)
        monkeypatch.setattr(checker, "_wait_for_next_round", wait)
        monkeypatch.setattr(metrics, "MetricsServer", Recorded)
        argv = [a.replace("{dir}", str(workdir)) for a in
                ["--kubeconfig", kubeconfig(workdir / "kc", self.cluster.url),
                 "--retry-budget", "0", "--probe-results", str(reports), *self.flags]]
        argv = [a.replace("{agg}", self.aggregator.url) for a in argv]
        try:
            if "--watch" in self.flags:
                set_up(0)
                rec["rc"].append(cli.main(argv))
            else:
                for i in range(len(self.rounds)):
                    set_up(i)
                    rec["rc"].append(cli.main(argv))
        finally:
            for server in rec["servers"]:
                server.close()
        out, err = capsys.readouterr()
        rec["payloads"] = _json_docs(out) if "--json" in self.flags else out
        rec["err"] = _stderr(err, workdir)
        with self.cluster.lock:
            rec["patches"] = _patch_bodies(self.cluster.patches)
            rec["evictions"] = list(self.cluster.evictions)
            rec["webhooks"] = [{k: v for k, v in w.items() if k != "trace_id"}
                               for w in self.cluster.webhooks]
            rec["nodes"] = copy.deepcopy(self.cluster.nodes)
        for node in rec["nodes"]:
            notes = node["metadata"].get("annotations") or {}
            if QUARANTINE in notes:
                notes[QUARANTINE] = "<ts>"
        rec["lease"] = list(self.aggregator.requests) if self.lease else None
        events = workdir / "events.jsonl"
        rec["events"] = _sorted(
            [{k: v for k, v in json.loads(line).items() if k not in ("ts", "trace_id")}
             for line in events.read_text().splitlines()] if events.exists() else [])
        for name in ("fired.log",):
            path = workdir / name
            rec[name] = path.read_text() if path.exists() else None
        del rec["servers"]
        return rec

    def both(self, tmp_path, capsys, monkeypatch):
        """The JAX side, then the port's; asserts them equal, returns the
        port's record."""
        jax = self.run("jax", tmp_path, capsys, monkeypatch)
        port = self.run("port", tmp_path, capsys, monkeypatch)
        for key in ("rc", "nodes", "lease", "slack", "payloads", "err", "events", "scrapes",
                    "fired.log"):
            assert port[key] == jax[key], key
        # PATCHes, evictions and hooks fan out over --api-concurrency
        # workers, so within a sweep they may land in any order.
        for key in ("patches", "evictions", "webhooks"):
            assert _sorted(port[key]) == _sorted(jax[key]), key
        return port


def _sorted(docs):
    return sorted(docs, key=lambda d: json.dumps(d, sort_keys=True))


def one_round(verdicts, **kw):
    return [dict(verdicts=verdicts, **kw)]


def _names(patches):
    return [p["node"] for p in patches]


class TestCordon:
    @pytest.mark.parametrize("cap,want", [(None, 1), ("5", 3)])
    def test_legacy_cordon_max_parity(self, cluster, aggregator, tmp_path, capsys,
                                      monkeypatch, cap, want):
        flags = ["--cordon-failed", "--json"] + (["--cordon-max", cap] if cap else [])
        got = Scenario(cluster, aggregator, tpu_nodes(3),
                       one_round({"tpu-0": False, "tpu-1": False, "tpu-2": False}),
                       flags).both(tmp_path, capsys, monkeypatch)
        assert len(got["patches"]) == want
        payload, = got["payloads"]
        assert len(payload["cordon"]["skipped_over_cap"]) == 3 - want
        assert got["rc"] == [3]
        if cap is None:
            # The legacy cap's refusals are visible: the block and its events.
            assert payload["remediation"]["denied_total"] == {"cordon-max": 2}
            assert sorted(e["event"] for e in got["err"] if isinstance(e, dict)) == \
                ["remediation-cordon", "remediation-denied", "remediation-denied"]

    def test_cap_is_a_state_budget_not_a_rate(self, cluster, aggregator, tmp_path, capsys,
                                              monkeypatch):
        nodes = [fx.make_node("tpu-human", unschedulable=True,
                              allocatable={"google.com/tpu": "4"},
                              labels={"cloud.google.com/gke-tpu-accelerator": "x"}),
                 *tpu_nodes(2)]
        got = Scenario(cluster, aggregator, nodes, one_round({"tpu-0": False, "tpu-1": True}),
                       ["--cordon-failed", "--json"]).both(tmp_path, capsys, monkeypatch)
        assert got["patches"] == []
        cordon = got["payloads"][0]["cordon"]
        assert cordon["already_cordoned"] == 1 and cordon["skipped_over_cap"] == ["tpu-0"]

    def test_dry_run_patches_nothing(self, cluster, aggregator, tmp_path, capsys, monkeypatch):
        got = Scenario(cluster, aggregator, tpu_nodes(2),
                       one_round({"tpu-0": False, "tpu-1": True}),
                       ["--cordon-failed", "--cordon-dry-run", "--json"]
                       ).both(tmp_path, capsys, monkeypatch)
        assert got["patches"] == []
        assert got["payloads"][0]["cordon"] == {
            "dry_run": True, "cordoned": ["tpu-0"], "failed": [], "already_cordoned": 0,
            "skipped_over_cap": []}
        assert "[dry-run] would cordon tpu-0 (chip probe failed)" in got["err"]

    def test_a_patch_failure_is_reported_not_fatal(self, cluster, aggregator, tmp_path, capsys,
                                                   monkeypatch):
        got = Scenario(cluster, aggregator, tpu_nodes(2),
                       one_round({"tpu-0": False, "tpu-1": True}),
                       ["--cordon-failed", "--json"], patch_status=500
                       ).both(tmp_path, capsys, monkeypatch)
        payload, = got["payloads"]
        assert got["rc"] == [0]
        assert payload["cordon"]["cordoned"] == []
        assert payload["cordon"]["failed"][0]["node"] == "tpu-0"
        assert payload["degraded"] is True and list(payload["degradation"]) == ["cordon"]

    def test_evidence_rules(self, cluster, aggregator, tmp_path, capsys, monkeypatch):
        # NotReady, already cordoned, a dead device plugin and a missing
        # report are never condemned; the one real failure is.
        nodes = [fx.make_node("tpu-notready", ready=False, allocatable={"google.com/tpu": "4"},
                              labels={"cloud.google.com/gke-tpu-accelerator": "x"}),
                 fx.make_node("tpu-deadplugin", allocatable={"google.com/tpu": "0"},
                              capacity={"cpu": "8", "google.com/tpu": "4"},
                              labels={"cloud.google.com/gke-tpu-accelerator": "x"}),
                 *tpu_nodes(2)]
        got = Scenario(cluster, aggregator, nodes,
                       one_round({"tpu-notready": False, "tpu-deadplugin": False,
                                  "tpu-0": False}),
                       ["--cordon-failed", "--cordon-max", "4", "--probe-results-required",
                        "--json"]).both(tmp_path, capsys, monkeypatch)
        assert _names(got["patches"]) == ["tpu-0"]

    def test_a_degraded_link_is_cordoned_under_the_same_rails(
            self, cluster, aggregator, tmp_path, capsys, monkeypatch):
        # Passing reports whose mesh sweep graded a link SLOW, on a v5p-64
        # slice: --cordon-degraded cordons under --cordon-max and the floor.
        nodes = fx.tpu_v5p_64_slice()
        names = [n["metadata"]["name"] for n in nodes]
        slow = {"ok": True, "level": "mesh", "mesh_degraded": True, "mesh_slow_links": ["t1/2"]}
        got = Scenario(cluster, aggregator, nodes,
                       one_round({names[0]: slow, names[1]: slow, names[2]: True}),
                       ["--cordon-degraded", "--cordon-max", "8", "--slice-floor-pct", "90",
                        "--json"]).both(tmp_path, capsys, monkeypatch)
        assert _names(got["patches"]) == [names[0]]
        payload, = got["payloads"]
        assert payload["cordon_degraded"]["cordoned"] == [names[0]]
        assert payload["cordon_degraded"]["links"]
        assert payload["remediation"]["degraded"]["nodes"] == sorted(names[:2])
        assert payload["remediation"]["denied_total"] == {"slice-floor": 1}

    def test_slack_carries_the_cordon_lines(self, cluster, aggregator, tmp_path, capsys,
                                            monkeypatch):
        got = Scenario(cluster, aggregator, tpu_nodes(3),
                       one_round({"tpu-0": True, "tpu-1": False, "tpu-2": True}),
                       ["--cordon-failed", "--slack-webhook", "http://127.0.0.1:1/hook"]
                       ).both(tmp_path, capsys, monkeypatch)
        (message, _kw), = got["slack"]
        assert "🚧 auto-cordoned (chip probe failed): `tpu-1`" in message


class TestUncordon:
    def test_recovered_quarantine_is_lifted(self, cluster, aggregator, tmp_path, capsys,
                                            monkeypatch):
        got = Scenario(cluster, aggregator, [quarantined(tpu_nodes(1)[0])],
                       one_round({"tpu-0": True}), ["--uncordon-recovered", "--json"]
                       ).both(tmp_path, capsys, monkeypatch)
        assert got["patches"] == [{"node": "tpu-0", "body": {
            "metadata": {"annotations": {QUARANTINE: None}}, "spec": {"unschedulable": False}}}]
        assert got["payloads"][0]["uncordon"]["uncordoned"] == ["tpu-0"]
        assert "unschedulable" not in got["nodes"][0]["spec"]

    @pytest.mark.parametrize("verdicts", [{"tpu-0": True}, {"tpu-0": False}, {}])
    def test_a_human_cordon_or_no_recovery_is_never_touched(
            self, cluster, aggregator, tmp_path, capsys, monkeypatch, verdicts):
        # A human's cordon (no annotation) with a passing probe; ours with a
        # failing probe; ours with no report: all stay.
        node = tpu_nodes(1, unschedulable=True)[0]
        if verdicts != {"tpu-0": True}:
            node = quarantined(node)
        got = Scenario(cluster, aggregator, [node], one_round(verdicts),
                       ["--uncordon-recovered", "--json"]).both(tmp_path, capsys, monkeypatch)
        assert got["patches"] == []

    def test_out_of_band_uncordon_clears_the_annotation(self, cluster, aggregator, tmp_path,
                                                        capsys, monkeypatch):
        got = Scenario(cluster, aggregator, [quarantined(tpu_nodes(1)[0], cordoned=False)],
                       one_round({"tpu-0": True}), ["--uncordon-recovered", "--json"]
                       ).both(tmp_path, capsys, monkeypatch)
        assert got["patches"] == [{"node": "tpu-0", "body": {
            "metadata": {"annotations": {QUARANTINE: None}}}}]
        assert got["payloads"][0]["uncordon"]["stale_annotations_cleared"] == ["tpu-0"]
        assert QUARANTINE not in got["nodes"][0]["metadata"]["annotations"]

    @pytest.mark.parametrize("dry_run", [False, True])
    def test_a_recovery_frees_the_budget_in_the_same_round(
            self, cluster, aggregator, tmp_path, capsys, monkeypatch, dry_run):
        nodes = [quarantined(tpu_nodes(2)[1]), tpu_nodes(1)[0]]
        flags = ["--uncordon-recovered", "--cordon-failed", "--json"]
        got = Scenario(cluster, aggregator, nodes, one_round({"tpu-1": True, "tpu-0": False}),
                       flags + (["--cordon-dry-run"] if dry_run else [])
                       ).both(tmp_path, capsys, monkeypatch)
        assert _names(got["patches"]) == ([] if dry_run else ["tpu-1", "tpu-0"])
        payload, = got["payloads"]
        assert payload["uncordon"]["uncordoned"] == ["tpu-1"]
        assert payload["cordon"]["cordoned"] == ["tpu-0"]


WATCH = ["--watch", "10", "--json", "--metrics-port", "0", "--event-log", "{dir}/events.jsonl",
         "--slack-webhook", "http://127.0.0.1:1/hook", "--slack-on-change"]


class TestBudgets:
    @pytest.mark.parametrize("loop", [False, True])
    def test_disruption_budget_window(self, cluster, aggregator, tmp_path, capsys,
                                      monkeypatch, loop):
        # 2 actuations per 10 minutes: round 1 cordons two of three failed
        # GPU nodes; in the loop round 2's new failure finds the window
        # spent, and a one-shot restart finds it fresh.
        verdicts = {f"gke-gpu-pool-{i}": i >= 3 for i in range(6)}
        second = dict(verdicts, **{"gke-gpu-pool-3": False})
        flags = ["--cordon-failed", "--cordon-max", "8", "--disruption-budget", "2/10m"]
        flags += WATCH if loop else ["--json"]
        got = Scenario(cluster, aggregator, gpu_nodes(6),
                       [{"verdicts": verdicts}, {"verdicts": second, "restart": not loop}],
                       flags).both(tmp_path, capsys, monkeypatch)
        assert sorted(_names(got["patches"])) == (
            ["gke-gpu-pool-0", "gke-gpu-pool-1"] if loop
            else ["gke-gpu-pool-0", "gke-gpu-pool-1", "gke-gpu-pool-2", "gke-gpu-pool-3"])
        last = got["payloads"][-1]["remediation"]
        assert last["budget"]["window_s"] == 600.0
        if loop:
            assert got["rc"] == [143]
            assert [d["node"] for d in last["denials"]] == ["gke-gpu-pool-2", "gke-gpu-pool-3"]
            assert got["scrapes"][-1] and any(
                'reason="disruption-budget"' in line for line in got["scrapes"][-1])

    @pytest.mark.parametrize("loop", [False, True])
    def test_slice_floor_on_a_tpu_slice(self, cluster, aggregator, tmp_path, capsys,
                                        monkeypatch, loop):
        # v5p-64: 16 hosts of 4 chips, one failure domain.  Floor 90 % = 58
        # chips: the first cordon leaves 60, the second would leave 56.
        nodes = fx.tpu_v5p_64_slice()
        names = [n["metadata"]["name"] for n in nodes]
        verdicts = {name: i >= 4 for i, name in enumerate(names)}
        flags = ["--cordon-failed", "--cordon-max", "8", "--slice-floor-pct", "90"]
        flags += WATCH if loop else ["--json"]
        got = Scenario(cluster, aggregator, nodes, [{"verdicts": verdicts}] * 2,
                       flags).both(tmp_path, capsys, monkeypatch)
        assert _names(got["patches"]) == [names[0]]
        block = got["payloads"][-1]["remediation"]
        assert set(block["denied_total"]) == {"slice-floor"}
        assert block["domains"] == {"total": 1, "at_floor": 0}

    def test_gpu_nodes_are_outside_every_slice_domain(self, cluster, aggregator, tmp_path,
                                                      capsys, monkeypatch):
        # A GPU node belongs to no slice (slice_group_key is None), so the
        # slice floor never refuses its cordon.
        verdicts = {f"gke-gpu-pool-{i}": i >= 3 for i in range(4)}
        got = Scenario(cluster, aggregator, gpu_nodes(4), one_round(verdicts),
                       ["--cordon-failed", "--cordon-max", "8", "--slice-floor-pct", "90",
                        "--json"]).both(tmp_path, capsys, monkeypatch)
        assert len(got["patches"]) == 3
        block = got["payloads"][0]["remediation"]
        assert block["denials"] == [] and block["domains"] == {"total": 0, "at_floor": 0}

    def test_a_storms_denials_are_posted_once(self, cluster, aggregator, tmp_path, capsys,
                                              monkeypatch):
        # Four failed GPU nodes under the Deployment's flags (--cordon-max 1):
        # one cordon, then three cordon-max denials each round; one Slack
        # post carries them, and the unchanged rounds after it post nothing.
        verdicts = {f"gke-gpu-pool-{i}": i >= 4 for i in range(8)}
        got = Scenario(cluster, aggregator, gpu_nodes(8), [{"verdicts": verdicts}] * 3,
                       ["--cordon-failed", "--disruption-budget", "2/10m",
                        "--slice-floor-pct", "90", *WATCH]).both(tmp_path, capsys, monkeypatch)
        assert _names(got["patches"]) == ["gke-gpu-pool-0"]
        (message, _kw), = got["slack"]
        assert [line for line in message.splitlines() if "remediation refused" in line]
        assert [p["remediation"]["denied_total"] for p in got["payloads"]] == \
            [{"cordon-max": 3}, {"cordon-max": 6}, {"cordon-max": 9}]
        assert sum(e["event"] == "remediation-denied" for e in got["events"]) == 9


def _pod(name, owner=None, mirror=False, grace=30):
    meta = {"name": name, "namespace": "default"}
    if owner:
        meta["ownerReferences"] = [{"kind": owner, "name": "o"}]
    if mirror:
        meta["annotations"] = {"kubernetes.io/config.mirror": "x"}
    return {"metadata": meta, "spec": {"terminationGracePeriodSeconds": grace},
            "status": {"phase": "Running"}}


PODS = {"gke-gpu-pool-0": [_pod("job-a", owner="Job", grace=60), _pod("ds-a", owner="DaemonSet"),
                           _pod("mirror-a", mirror=True)],
        "gke-gpu-pool-1": [_pod("pdb-a")]}


class TestDrain:
    @pytest.mark.parametrize("live", [False, True])
    def test_drain(self, cluster, aggregator, tmp_path, capsys, monkeypatch, live):
        # Dry run (the default) lists the blast radius and acts on nothing;
        # live, pool-0's Job pod is evicted and the node cordoned, and
        # pool-1's PDB refusal is a denial (reason pdb), the node untouched.
        verdicts = {"gke-gpu-pool-0": False, "gke-gpu-pool-1": False, "gke-gpu-pool-2": True}
        flags = ["--drain-failed", "--cordon-max", "8", "--json"]
        got = Scenario(cluster, aggregator, gpu_nodes(3), one_round(verdicts),
                       flags + (["--no-drain-dry-run"] if live else []), pods=PODS,
                       pdb={"pdb-a"}).both(tmp_path, capsys, monkeypatch)
        drain = got["payloads"][0]["drain"]
        assert drain["dry_run"] is not live
        if live:
            assert [e["pod"] for e in got["evictions"]] == ["job-a"]
            assert _names(got["patches"]) == ["gke-gpu-pool-0"]
            assert drain["drained"] == ["gke-gpu-pool-0"]
            denial, = got["payloads"][0]["remediation"]["denials"]
            assert (denial["node"], denial["reason"]) == ("gke-gpu-pool-1", "pdb")
        else:
            assert got["evictions"] == got["patches"] == []
            assert drain["drained"] == ["gke-gpu-pool-0", "gke-gpu-pool-1"]
            assert drain["grace_seconds_total"] == 60 + 30


class TestLease:
    @pytest.mark.parametrize("loop", [False, True])
    def test_grant_denial_and_fallback_after_the_aggregator_dies(
            self, cluster, aggregator, tmp_path, capsys, monkeypatch, loop):
        # A fleet budget of 3 an hour: round 1 cordons three of six failed
        # nodes and is denied the rest; the aggregator dies, and round 2
        # falls back to the allowance last leased (0): nothing more.
        verdicts = {f"gke-gpu-pool-{i}": False for i in range(6)}
        flags = ["--cordon-failed", "--cordon-max", "8", "--disruption-lease", "{agg}"]
        flags += WATCH if loop else ["--json"]
        got = Scenario(cluster, aggregator, gpu_nodes(6),
                       [{"verdicts": verdicts}, {"verdicts": verdicts, "lease_down": True}],
                       flags, lease=(3, 3600.0)).both(tmp_path, capsys, monkeypatch)
        assert len(got["patches"]) == 3
        first, second = got["payloads"][0]["remediation"], got["payloads"][-1]["remediation"]
        assert first["lease"]["granted"] == 3 and first["denied_total"] == {"lease-denied": 3}
        assert second["denied_total"].get("lease-unreachable") == 3
        assert "unreachable" in second["lease"]

    def test_a_checker_that_never_reached_the_aggregator_runs_on_its_budget(
            self, cluster, aggregator, tmp_path, capsys, monkeypatch):
        verdicts = {f"gke-gpu-pool-{i}": False for i in range(3)}
        got = Scenario(cluster, aggregator, gpu_nodes(3),
                       [{"verdicts": verdicts, "lease_down": True}],
                       ["--cordon-failed", "--cordon-max", "8", "--disruption-budget", "2",
                        "--disruption-lease", "{agg}", "--json"],
                       lease=(1,)).both(tmp_path, capsys, monkeypatch)
        assert len(got["patches"]) == 2
        block = got["payloads"][0]["remediation"]
        assert block["lease"]["fallback_grants"] == 2
        assert block["denied_total"] == {"disruption-budget": 1}


class TestRepair:
    def test_a_repair_fires_once_and_survives_a_restart(self, cluster, aggregator, tmp_path,
                                                        capsys, monkeypatch):
        verdicts = {"gke-gpu-pool-0": False, "gke-gpu-pool-1": True}
        flags = ["--cordon-failed", "--history", "{dir}/history.jsonl",
                 "--repair-cmd", 'echo "$TNC_NODE $TNC_REASON" >> {dir}/fired.log',
                 "--no-repair-dry-run", "--json"]
        rounds = [{"verdicts": verdicts}] * 3 + [{"verdicts": verdicts, "restart": True}]
        got = Scenario(cluster, aggregator, gpu_nodes(2), rounds, flags
                       ).both(tmp_path, capsys, monkeypatch)
        assert got["fired.log"] == "gke-gpu-pool-0 FAILED\n"
        assert [p["repair"]["started"] for p in got["payloads"]] == \
            [[], ["gke-gpu-pool-0"], [], []]
        assert got["payloads"][-1]["remediation"]["repairs"]["in_flight"] == ["gke-gpu-pool-0"]

    @pytest.mark.parametrize("live", [False, True])
    def test_the_webhook(self, cluster, aggregator, tmp_path, capsys, monkeypatch, live):
        verdicts = {"gke-gpu-pool-0": False, "gke-gpu-pool-1": True}
        flags = ["--cordon-failed", "--history", "{dir}/history.jsonl",
                 "--repair-webhook", cluster.url + "/repair", "--json"]
        got = Scenario(cluster, aggregator, gpu_nodes(2), [{"verdicts": verdicts}] * 2,
                       flags + (["--no-repair-dry-run"] if live else [])
                       ).both(tmp_path, capsys, monkeypatch)
        assert got["webhooks"] == ([{"node": "gke-gpu-pool-0", "domain": None,
                                     "reason": "FAILED"}] if live else [])
        assert got["payloads"][1]["repair"]["started"] == ["gke-gpu-pool-0"]


QUARANTINE_FLAGS = ["--cordon-failed", "--cordon-max", "--cordon-dry-run", "--uncordon-recovered",
                    "--cordon-degraded", "--drain-failed", "--drain-dry-run", "--no-drain-dry-run",
                    "--repair-cmd", "--repair-webhook", "--repair-dry-run",
                    "--no-repair-dry-run", "--disruption-budget", "--slice-floor-pct",
                    "--disruption-lease", "--trend", "--trend-nodes"]


@pytest.mark.parametrize("flag", QUARANTINE_FLAGS)
def test_flag_equals_jax(flag):
    # Once unknown arguments: each with JAX's type, default, words and group.
    def action(cli):
        parser = cli.build_parser()
        act = next(a for a in parser._actions if flag in a.option_strings)
        group = next(g.title for g in parser._action_groups if act in g._group_actions)
        return (act.dest, act.option_strings, type(act).__name__, act.type, act.default,
                act.metavar, act.nargs, act.const, act.help, group,
                parser.get_default(act.dest))

    assert action(port_cli) == action(jax_cli)


P = ["--probe-results", "d"]


@pytest.mark.parametrize("argv", [
    ["--probe", "--cordon-failed", "--cordon-max", "0"],
    P + ["--cordon-failed", "--drain-failed"],
    P + ["--cordon-failed", "--disruption-budget", "4/10y"],
    P + ["--cordon-failed", "--disruption-budget", "0"],
    P + ["--cordon-failed", "--slice-floor-pct", "0"],
    P + ["--drain-failed", "--slice-floor-pct", "101"],
    ["--disruption-lease", "http://agg"],
    P + ["--cordon-failed", "--repair-cmd", "c", "--repair-webhook", "u"],
    P + ["--history", "h", "--repair-webhook", "u"],
    P + ["--uncordon-recovered", "--history", "h", "--repair-cmd", "c"],
    ["--no-drain-dry-run"],
    P + ["--cordon-failed", "--no-repair-dry-run"],
    ["--probe", "--probe-level", "compute", "--cordon-degraded"],
    ["--emit-probe", "-", "--probe-results", "d", "--cordon-failed"],
    ["--emit-probe", "-", "--uncordon-recovered"],
    P + ["--uncordon-recovered", "--cordon-max", "2"],
    ["--report-fresh", "r", "--probe-results", "d", "--uncordon-recovered"],
    ["--selftest", "--cordon-degraded", "--probe-results", "d"],
    ["--trend", "t", "--cordon-failed", "--probe-results", "d"],
    P + ["--drain-failed", "--cordon-dry-run"],
])
def test_usage_error_equals_jax(capsys, argv):
    assert isinstance(outcome_vs_jax(argv, capsys), str)


@pytest.mark.parametrize("argv", [
    P + ["--cordon-failed"],
    P + ["--cordon-failed", "--uncordon-recovered", "--cordon-max", "3", "--cordon-dry-run"],
    P + ["--drain-failed", "--no-drain-dry-run", "--slice-floor-pct", "90",
         "--disruption-budget", "2/10m", "--disruption-lease", "http://agg"],
    P + ["--cordon-degraded", "--history", "h", "--repair-webhook", "http://r",
         "--no-repair-dry-run"],
    ["--probe", "--probe-level", "mesh", "--cordon-degraded", "--cordon-failed"],
    ["--trend", "t", "--json"], ["--trend-nodes", "t"],
])
def test_parses_as_jax(capsys, argv):
    assert outcome_vs_jax(argv, capsys).cordon_max >= 1
