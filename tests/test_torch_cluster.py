"""The port's Kubernetes client, held against the JAX checker's over a live
fake API server.

One threaded ``http.server`` per module (an ephemeral port, shared by the
tests of this file) plays the apiserver: ``/api/v1/nodes`` with
``limit``/``continue`` paging and ``labelSelector``, ``/api/v1/events``
with ``fieldSelector=involvedObject.name=…``, and a scripted fault in front
of any request (``FaultSchedule``: 429/503 with ``Retry-After``, a
connection reset).  The same argv goes through the JAX CLI's ``main`` and
the port's; the exit codes, the text stdout and the stderr notes must be
equal, and the ``--json`` payloads equal once ``trace_id`` and
``timings_ms`` (a random id and wall times) are dropped.  Nothing else is
dropped: the transport's counters (``api_transport``) are compared too.

Covered here: every ``tests/fixtures.py`` NodeList served in small pages
(one at the real page limit, 2,500 nodes); the 410 restart on an expired
continue token; 429/503 with ``Retry-After`` and a connection reset, with
``--retry-budget 0`` and the default; a server that is not there;
kubeconfig auth by token, basic auth, inline client certificate and an exec
plugin, ``--context``, ``$KUBECONFIG`` as a path list, the in-cluster
service account, TLS with ``certificate-authority-data``, and the
``cluster`` key from the context.  No test really sleeps: both packages'
retry ``_sleep`` seams record the delays instead.

The port is reached through ``importlib.import_module``:
tests/test_dependency_surface.py rejects any other ``import`` in tests/.
"""

import base64
import importlib
import json
import os
import socket
import stat
import sys
import threading
from urllib.parse import parse_qs, urlparse

import pytest

from tests import fixtures as fx
from tpu_node_checker import checker as jax_checker
from tpu_node_checker import cli as jax_cli
from tpu_node_checker import cluster as jax_cluster
from tpu_node_checker.sim.fixtures import serve_scripted_fault
from tpu_node_checker.utils import retry as jax_retry

port_cli = importlib.import_module("tpu_node_checker_torch.cli")
port_checker = importlib.import_module("tpu_node_checker_torch.checker")
port_cluster = importlib.import_module("tpu_node_checker_torch.cluster")
port_retry = importlib.import_module("tpu_node_checker_torch.utils.retry")

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


class ApiServer:
    """What a test sets the fake apiserver to serve, and what it was asked.

    ``nodes`` are served in pages of ``limit`` (the continue token is the
    offset), filtered by ``labelSelector`` (``key``, ``key=value``,
    ``key!=value``, comma-joined); ``events[name]`` answers the events walk
    of node ``name``.  ``faults`` is the ``FaultSchedule`` in front of every
    request; ``expire_continue`` answers the next request that carries a
    continue token with 410 Gone; ``events_status`` answers every events
    request with that status; ``endless_events`` never ends an events walk;
    ``events_barrier`` holds the first N events requests of a round until N
    are in flight at once, so a fan-out's connection count is fixed.
    """

    def __init__(self):
        self.lock = threading.Lock()
        self.reset()

    def reset(self, nodes=(), events=None):
        with self.lock:
            self.nodes = list(nodes)
            self.events = dict(events or {})
            self.faults = fx.FaultSchedule()
            self.expire_continue = False
            self.events_status = None
            self.endless_events = False
            self.events_barrier = None
            self.seen = []

    def arm_barrier(self, parties):
        with self.lock:
            self.events_barrier = (threading.Barrier(parties), [parties])

    def handler(self):
        api = self
        from http.server import BaseHTTPRequestHandler

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _send(self, status, doc, extra=None):
                body = json.dumps(doc).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 — the handler protocol's name
                url = urlparse(self.path)
                q = {k: v[0] for k, v in parse_qs(url.query).items()}
                with api.lock:
                    api.seen.append({"path": url.path, "query": q,
                                     "auth": self.headers.get("Authorization")})
                if serve_scripted_fault(self, api.faults, lambda: b"{}"):
                    return
                if url.path == "/api/v1/nodes":
                    self._nodes(q)
                elif url.path == "/api/v1/events":
                    self._events(q)
                else:
                    self._send(404, {"kind": "Status", "message": "not found"})

            def _nodes(self, q):
                if q.get("continue") and api.expire_continue:
                    api.expire_continue = False
                    self._send(410, {"kind": "Status", "reason": "Expired",
                                     "message": "too old resource version"})
                    return
                items = [n for n in api.nodes if _selected(n, q.get("labelSelector"))]
                start = int(q.get("continue") or 0)
                limit = int(q.get("limit") or len(items) or 1)
                meta = {"resourceVersion": "4242"}
                if start + limit < len(items):
                    meta["continue"] = str(start + limit)
                self._send(200, {"kind": "NodeList", "apiVersion": "v1", "metadata": meta,
                                 "items": items[start:start + limit]})

            def _events(self, q):
                sel = q.get("fieldSelector", "")
                name = sel.split("involvedObject.name=")[1].split(",")[0]
                armed = api.events_barrier
                if armed is not None:
                    barrier, left = armed
                    with api.lock:
                        wait = left[0] > 0
                        left[0] -= 1
                    if wait:
                        barrier.wait(timeout=30)
                if api.events_status:
                    self._send(api.events_status, {"kind": "Status", "reason": "Forbidden",
                                                   "message": f"events is forbidden for {name}"})
                    return
                meta = {"continue": "more"} if api.endless_events else {}
                self._send(200, {"kind": "EventList", "metadata": meta,
                                 "items": api.events.get(name, [])})

            def log_message(self, *args):
                pass

        return Handler


def _selected(node, selector):
    """A node label selector of equality terms, as the apiserver reads it."""
    labels = node.get("metadata", {}).get("labels") or {}
    for term in filter(None, (selector or "").split(",")):
        if "!=" in term:
            k, v = term.split("!=", 1)
            if labels.get(k) == v:
                return False
        elif "=" in term:
            k, v = term.split("=", 1)
            if labels.get(k) != v.lstrip("="):
                return False
        elif term.startswith("!"):
            if term[1:] in labels:
                return False
        elif term not in labels:
            return False
    return True


@pytest.fixture(scope="module")
def api():
    state = ApiServer()
    server = fx.serve_http(state.handler())
    state.url = f"http://127.0.0.1:{server.server_address[1]}"
    yield state
    server.shutdown()
    server.server_close()


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """No outside TNC_*/Slack/KUBECONFIG settings, fresh client caches and
    history trackers on both sides, and retry sleeps recorded, not slept."""
    for k in [k for k in os.environ
              if k.startswith(("TNC_", "KUBERNETES_SERVICE_")) or k in (
                  "SLACK_WEBHOOK_URL", "KUBECONFIG", "NODE_NAME")]:
        monkeypatch.delenv(k)
    for checker in (jax_checker, port_checker):
        monkeypatch.setitem(checker._HISTORY_CACHE, "key", None)
        checker.reset_client_cache()
    slept = {"jax": [], "port": []}
    monkeypatch.setattr(jax_retry, "_sleep", slept["jax"].append)
    monkeypatch.setattr(port_retry, "_sleep", slept["port"].append)
    yield slept
    for checker in (jax_checker, port_checker):
        checker.reset_client_cache()


def small_pages(monkeypatch, n):
    """Node LIST pages of ``n`` on both sides (the page limit the projected
    LIST takes by default, bound when the method was defined)."""
    for mod in (jax_cluster, port_cluster):
        fn = mod.KubeClient.list_nodes_projected
        monkeypatch.setattr(fn, "__defaults__", fn.__defaults__[:-1] + (n,))
        monkeypatch.setattr(mod.KubeClient, "LIST_PAGE_LIMIT", n)


def kubeconfig(path, server, user="    token: tok\n", cluster="", contexts=None,
               current="c"):
    """A kubeconfig at ``path`` pointing context ``c`` at ``server``."""
    contexts = contexts or {"c": ("cl", "u")}
    text = f"apiVersion: v1\nkind: Config\ncurrent-context: {current}\ncontexts:\n"
    for name, (cl, u) in contexts.items():
        text += f"- name: {name}\n  context:\n    cluster: {cl}\n    user: {u}\n"
    text += f"clusters:\n- name: cl\n  cluster:\n    server: {server}\n{cluster}"
    text += f"- name: other\n  cluster:\n    server: http://127.0.0.1:1\n"
    text += f"users:\n- name: u\n  user:\n{user}"
    path.write_text(text)
    return str(path)


def outcome_vs_jax(argv, capsys):
    """The port's and JAX's outcome for one argv: both the same usage error
    (exit 2, the same words), or both parsed to the same values."""
    got = []
    for parse in (port_cli.parse_args, jax_cli.parse_args):
        try:
            args = parse(argv)
        except SystemExit as exc:
            err = capsys.readouterr().err.strip().splitlines()[-1]
            got.append(("usage", exc.code, err.split("error: ", 1)[-1]))
        else:
            got.append(("parsed", args))
    (port_kind, *port), (jax_kind, *jax) = got
    assert port_kind == jax_kind, (port, jax)
    if port_kind == "usage":
        assert port == jax and port[0] == 2
        return port[1]
    for dest, value in vars(port[0]).items():
        if hasattr(jax[0], dest):
            assert value == getattr(jax[0], dest), dest
    return port[0]


def run(main, argv, capsys):
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


def both(argv, capsys, before=None):
    """((rc, stdout, stderr) of JAX, of the port) for the same argv, each
    side after ``before()``."""
    got = []
    for main in (jax_cli.main, port_cli.main):
        if before is not None:
            before()
        got.append(run(main, argv, capsys))
    return tuple(got)


def payload(out):
    doc = json.loads(out)
    for k in VOLATILE:
        doc.pop(k, None)
    return doc


def assert_equal(jax, port, json_mode=True):
    assert port[0] == jax[0]
    if json_mode:
        assert payload(port[1]) == payload(jax[1])
    else:
        assert port[1] == jax[1]
    assert port[2] == jax[2]


class TestPagedList:
    @pytest.mark.parametrize("json_mode", [False, True], ids=["text", "json"])
    @pytest.mark.parametrize("name", list(NODE_LISTS))
    def test_node_list_served_paged_equals_jax(self, api, tmp_path, capsys, monkeypatch,
                                               name, json_mode):
        small_pages(monkeypatch, 7)
        api.reset(NODE_LISTS[name]())
        argv = ["--kubeconfig", kubeconfig(tmp_path / "kc", api.url)]
        argv += ["--json"] if json_mode else []
        jax, port = both(argv, capsys)
        assert_equal(jax, port, json_mode)
        want = {"cpu_only_cluster": 2, "gpu_pool not ready": 3}.get(name, 0)
        assert port[0] == want
        pages = -(-len(api.nodes) // 7) or 1
        assert [s["query"].get("continue") for s in api.seen[:pages]] == \
            [None] + [str(7 * i) for i in range(1, pages)]
        assert len(api.seen) == 2 * pages
        if json_mode:
            assert payload(port[1])["api_transport"] == {
                "connections_opened": 1, "requests_sent": pages,
                "requests_reused": pages - 1, "retries": 0}

    def test_real_page_limit_2500_nodes(self, api, tmp_path, capsys):
        # This host's kind of fleet at the size users run: 1,000 GPU nodes
        # and 1,500 CPU nodes, three pages at the real LIST_PAGE_LIMIT.
        assert port_cluster.KubeClient.LIST_PAGE_LIMIT == 1000
        api.reset(fx.gpu_pool(1000) + fx.cpu_only_cluster(1500))
        argv = ["--kubeconfig", kubeconfig(tmp_path / "kc", api.url), "--json"]
        jax, port = both(argv, capsys)
        assert_equal(jax, port)
        doc = payload(port[1])
        assert port[0] == 0 and doc["total_nodes"] == 1000
        assert doc["api_transport"]["requests_sent"] == 3
        assert [s["query"]["limit"] for s in api.seen] == ["1000"] * 6

    @pytest.mark.parametrize("selector,want", [
        ("cloud.google.com/gke-tpu-accelerator", 0),
        ("cloud.google.com/gke-nodepool=gpu-pool", 0),
        ("cloud.google.com/gke-nodepool=nope", 2),
        ("!cloud.google.com/gke-tpu-accelerator", 0),
    ])
    def test_label_selector_filters_on_the_server(self, api, tmp_path, capsys, monkeypatch,
                                                  selector, want):
        small_pages(monkeypatch, 3)
        api.reset(fx.mixed_cluster_one_notready() + fx.gpu_pool(2))
        for json_mode in (False, True):
            argv = ["--kubeconfig", kubeconfig(tmp_path / "kc", api.url),
                    "--label-selector", selector] + (["--json"] if json_mode else [])
            jax, port = both(argv, capsys)
            assert_equal(jax, port, json_mode)
            assert port[0] == want
        assert {s["query"].get("labelSelector") for s in api.seen} == {selector}

    def test_expired_continue_token_restarts_the_walk_once(self, api, tmp_path, capsys,
                                                           monkeypatch):
        small_pages(monkeypatch, 5)
        api.reset(fx.tpu_v5p_64_slice(not_ready=1))

        def expire():
            api.expire_continue = True

        argv = ["--kubeconfig", kubeconfig(tmp_path / "kc", api.url), "--json",
                "--strict-slices"]
        jax, port = both(argv, capsys, before=expire)
        assert_equal(jax, port)
        assert port[0] == 3 and payload(port[1])["total_nodes"] == 16
        # Each side: page 0, the 410 on page 1, then 4 pages from the start.
        assert payload(port[1])["api_transport"]["requests_sent"] == 6
        assert len(api.seen) == 12


RETRY_CASES = {
    "429 with Retry-After, default budget": (["429:1"], [], 0),
    "503 with Retry-After, default budget": (["503:2"], [], 0),
    "connection reset, default budget": (["reset"], [], 0),
    "reset, 500, 429 in a row": (["reset", "500", "429:1"], [], 0),
    "429, --retry-budget 0": (["429:1"], ["--retry-budget", "0"], 1),
    "reset, --retry-budget 0": (["reset"], ["--retry-budget", "0"], 1),
    "Retry-After past --retry-budget 0.5": (["429:3"], ["--retry-budget", "0.5"], 1),
    "persistent 503, attempt cap": (["503"] * 4, [], 1),
}


class TestRetries:
    @pytest.mark.parametrize("json_mode", [False, True], ids=["text", "json"])
    @pytest.mark.parametrize("case", list(RETRY_CASES))
    def test_fault_then_round_equals_jax(self, api, tmp_path, capsys, monkeypatch, _isolated,
                                         case, json_mode):
        faults, flags, want = RETRY_CASES[case]
        small_pages(monkeypatch, 2)
        api.reset(fx.gpu_pool(3))

        def script():
            api.faults.reload(list(faults))

        argv = ["--kubeconfig", kubeconfig(tmp_path / "kc", api.url), *flags]
        argv += ["--json"] if json_mode else []
        jax, port = both(argv, capsys, before=script)
        assert port[0] == jax[0] == want
        if want == 0:
            assert_equal(jax, port, json_mode)
        elif json_mode:
            assert port[1] == jax[1] and set(json.loads(port[1])) == {"error"}
        else:
            # The message, then a traceback through each package's files.
            assert port[2].splitlines()[0] == jax[2].splitlines()[0]
        # The same delays were asked for on both sides (the jitter is random,
        # the Retry-After floor is not), and none was slept.
        assert len(_isolated["port"]) == len(_isolated["jax"])
        floors = [float(f.split(":")[1]) for f in faults if ":" in f]
        if want == 0 and floors:
            assert sorted(_isolated["port"])[-len(floors):] == floors
        if json_mode and want == 0:
            stats = payload(port[1])["api_transport"]
            assert stats["retries"] == len(faults)
            assert sum(stats["retries_by_reason"].values()) == len(faults)

    def test_retries_by_reason_named_as_jax(self, api, tmp_path, capsys, monkeypatch):
        small_pages(monkeypatch, 2)
        api.reset(fx.gpu_pool(3))
        argv = ["--kubeconfig", kubeconfig(tmp_path / "kc", api.url), "--json"]
        jax, port = both(argv, capsys,
                         before=lambda: api.faults.reload(["429:1", "reset", "ok", "503"]))
        assert_equal(jax, port)
        # The reset lands on the socket the 429 kept alive: a reused socket
        # that dies is redialled once as stale, which is not a retry.
        assert payload(port[1])["api_transport"]["retries_by_reason"] == {
            "http_429": 1, "http_503": 1}

    @pytest.mark.parametrize("flags", [[], ["--retry-budget", "2"], ["--retry-budget", "0"]],
                             ids=["default", "budget 2", "budget 0"])
    def test_a_server_that_is_not_there(self, tmp_path, capsys, _isolated, flags):
        # A closed port: connect refused on every attempt.
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            dead = f"http://127.0.0.1:{s.getsockname()[1]}"
        argv = ["--kubeconfig", kubeconfig(tmp_path / "kc", dead), "--json", *flags]
        jax, port = both(argv, capsys)
        assert port[0] == jax[0] == 1
        assert port[1] == jax[1]
        assert "Connection refused" in json.loads(port[1])["error"]
        assert len(_isolated["port"]) == len(_isolated["jax"]) == (0 if "0" in flags else 3)


def _pem(text):
    return base64.b64encode(text.encode()).decode()


class TestConfig:
    def test_bearer_token_is_sent(self, api, tmp_path, capsys):
        api.reset(fx.gpu_pool(1))
        argv = ["--kubeconfig", kubeconfig(tmp_path / "kc", api.url, user="    token: s3cret\n"),
                "--json"]
        jax, port = both(argv, capsys)
        assert_equal(jax, port)
        assert {s["auth"] for s in api.seen} == {"Bearer s3cret"}

    def test_token_file(self, api, tmp_path, capsys):
        api.reset(fx.gpu_pool(1))
        (tmp_path / "tok").write_text("from-file\n")
        argv = ["--kubeconfig", kubeconfig(tmp_path / "kc", api.url,
                                           user=f"    tokenFile: {tmp_path / 'tok'}\n"), "--json"]
        jax, port = both(argv, capsys)
        assert_equal(jax, port)
        assert {s["auth"] for s in api.seen} == {"Bearer from-file"}

    def test_basic_auth(self, api, tmp_path, capsys):
        api.reset(fx.gpu_pool(1))
        argv = ["--kubeconfig", kubeconfig(tmp_path / "kc", api.url,
                                           user="    username: ops\n    password: pw\n"),
                "--json"]
        jax, port = both(argv, capsys)
        assert_equal(jax, port)
        assert {s["auth"] for s in api.seen} == {"Basic " + base64.b64encode(b"ops:pw").decode()}

    def test_exec_plugin_token(self, api, tmp_path, capsys):
        api.reset(fx.gpu_pool(1))
        plugin = tmp_path / "auth-plugin"
        plugin.write_text(
            f"#!{sys.executable}\n"
            "import json, os\n"
            "print(json.dumps({'apiVersion': 'client.authentication.k8s.io/v1beta1',\n"
            "                  'kind': 'ExecCredential',\n"
            "                  'status': {'token': 'exec-' + os.environ['TNC_TEST_AUDIENCE']}}))\n")
        plugin.chmod(plugin.stat().st_mode | stat.S_IXUSR)
        user = ("    exec:\n      apiVersion: client.authentication.k8s.io/v1beta1\n"
                f"      command: {plugin}\n      args: []\n"
                "      env:\n      - name: TNC_TEST_AUDIENCE\n        value: fleet\n")
        argv = ["--kubeconfig", kubeconfig(tmp_path / "kc", api.url, user=user), "--json"]
        jax, port = both(argv, capsys)
        assert_equal(jax, port)
        assert {s["auth"] for s in api.seen} == {"Bearer exec-fleet"}

    def test_exec_plugin_missing_is_an_error(self, tmp_path, capsys):
        user = ("    exec:\n      apiVersion: client.authentication.k8s.io/v1beta1\n"
                f"      command: {tmp_path / 'no-such-plugin'}\n")
        argv = ["--kubeconfig", kubeconfig(tmp_path / "kc", "http://127.0.0.1:1", user=user),
                "--json"]
        jax, port = both(argv, capsys)
        assert port[0] == jax[0] == 1 and port[1] == jax[1]
        assert "exec auth plugin not found" in port[1]

    def test_inline_client_certificate_is_materialized(self, api, tmp_path, capsys):
        # Over plain HTTP the certificate is loaded but never presented: the
        # round equals JAX's and each side wrote the same files' contents.
        api.reset(fx.gpu_pool(1))
        user = (f"    client-certificate-data: {_pem('CERT')}\n"
                f"    client-key-data: {_pem('KEY')}\n")
        path = kubeconfig(tmp_path / "kc", api.url, user=user)
        jax, port = both(["--kubeconfig", path, "--json"], capsys)
        assert_equal(jax, port)
        cfgs = [mod.load_kubeconfig(path) for mod in (jax_cluster, port_cluster)]
        for cfg in cfgs:
            cert, key = cfg.client_cert
            assert open(cert).read() == "CERT" and open(key).read() == "KEY"
            assert cfg.token is None

    def test_context_flag_picks_the_context(self, api, tmp_path, capsys):
        api.reset(fx.gpu_pool(1))
        path = kubeconfig(tmp_path / "kc", api.url, current="broken",
                          contexts={"broken": ("other", "u"), "c": ("cl", "u")})
        jax, port = both(["--kubeconfig", path, "--context", "c", "--json"], capsys)
        assert_equal(jax, port)
        assert port[0] == 0 and payload(port[1])["cluster"] == "c"
        assert payload(port[1])["cluster_source"] == "context"
        jax, port = both(["--kubeconfig", path, "--context", "nope", "--json"], capsys)
        assert port[0] == jax[0] == 1 and port[1] == jax[1]

    @pytest.mark.parametrize("flags,source", [
        ([], "context"), (["--cluster-name", "prod"], "flag")])
    def test_cluster_key_from_the_context(self, api, tmp_path, capsys, flags, source):
        api.reset(fx.gpu_pool(1))
        argv = ["--kubeconfig", kubeconfig(tmp_path / "kc", api.url), "--json", *flags]
        jax, port = both(argv, capsys)
        assert_equal(jax, port)
        assert payload(port[1])["cluster_source"] == source

    def test_kubeconfig_env_path_list(self, api, tmp_path, capsys, monkeypatch):
        # $KUBECONFIG as a list: the first path that exists is used.
        api.reset(fx.gpu_pool(2))
        good = kubeconfig(tmp_path / "kc", api.url)
        monkeypatch.setenv("KUBECONFIG", os.pathsep.join([str(tmp_path / "missing"), good]))
        jax, port = both(["--json"], capsys)
        assert_equal(jax, port)
        assert port[0] == 0 and payload(port[1])["total_nodes"] == 2

    def test_in_cluster_service_account(self, api, tmp_path, capsys, monkeypatch):
        # The CronJob's pod: the service account's token, and the apiserver
        # from KUBERNETES_SERVICE_HOST/PORT (here over HTTP: the port's
        # scheme comes from the server URL, patched on both modules).
        api.reset(fx.gpu_pool(2))
        sa = tmp_path / "sa"
        sa.mkdir()
        (sa / "token").write_text("sa-token\n")
        host, port_no = urlparse(api.url).hostname, urlparse(api.url).port
        monkeypatch.setenv("KUBERNETES_SERVICE_HOST", host)
        monkeypatch.setenv("KUBERNETES_SERVICE_PORT", str(port_no))
        monkeypatch.setenv("HOME", str(tmp_path / "home"))
        for mod in (jax_cluster, port_cluster):
            monkeypatch.setattr(mod, "SERVICE_ACCOUNT_DIR", str(sa))
            monkeypatch.setattr(mod, "DEFAULT_KUBECONFIG", str(tmp_path / "none"))
            real = mod.load_incluster_config

            def over_http(sa_dir=None, real=real):
                cfg = real(sa_dir)
                cfg.server = cfg.server.replace("https://", "http://")
                return cfg

            monkeypatch.setattr(mod, "load_incluster_config", over_http)
        argv = ["--strict-slices", "--slack-only-on-error", "--json"]  # deploy/cronjob.yaml
        jax, port = both(argv, capsys)
        assert_equal(jax, port)
        assert port[0] == 0 and {s["auth"] for s in api.seen} == {"Bearer sa-token"}
        assert payload(port[1])["cluster_source"] == "hostname"

    def test_no_config_anywhere_is_an_error(self, tmp_path, capsys, monkeypatch):
        monkeypatch.setenv("HOME", str(tmp_path))
        for mod in (jax_cluster, port_cluster):
            monkeypatch.setattr(mod, "SERVICE_ACCOUNT_DIR", str(tmp_path / "sa"))
            monkeypatch.setattr(mod, "DEFAULT_KUBECONFIG", str(tmp_path / "none"))
        jax, port = both(["--json"], capsys)
        assert port[0] == jax[0] == 1 and port[1] == jax[1]
        assert "not running in a cluster" in port[1]
        jax, port = both([], capsys)
        assert port[0] == jax[0] == 1
        assert port[2].splitlines()[0] == jax[2].splitlines()[0]


@pytest.fixture(scope="module")
def tls_api(tmp_path_factory):
    cert = fx.self_signed_cert(str(tmp_path_factory.mktemp("tls")))
    if cert is None:
        pytest.skip("openssl CLI unavailable")
    state = ApiServer()
    server = fx.serve_http(state.handler(), tls_cert=cert)
    state.url = f"https://127.0.0.1:{server.server_address[1]}"
    state.cert = cert
    yield state
    server.shutdown()
    server.server_close()


class TestTls:
    def test_certificate_authority_data(self, tls_api, tmp_path, capsys, monkeypatch):
        small_pages(monkeypatch, 2)
        tls_api.reset(fx.tpu_v5p_64_slice(not_ready=1))
        ca = base64.b64encode(open(tls_api.cert[0], "rb").read()).decode()
        path = kubeconfig(tmp_path / "kc", tls_api.url,
                          cluster=f"    certificate-authority-data: {ca}\n")
        for json_mode in (False, True):
            argv = ["--kubeconfig", path, "--strict-slices"] + (["--json"] if json_mode else [])
            jax, port = both(argv, capsys)
            assert_equal(jax, port, json_mode)
            assert port[0] == 3
        # Two rounds on one cached client (its counters live as long as it).
        assert payload(port[1])["api_transport"]["requests_sent"] == 16

    def test_unknown_authority_is_refused(self, tls_api, tmp_path, capsys):
        tls_api.reset(fx.gpu_pool(1))
        jax, port = both(["--kubeconfig", kubeconfig(tmp_path / "kc", tls_api.url), "--json"],
                         capsys)
        assert port[0] == jax[0] == 1 and port[1] == jax[1]
        assert "CERTIFICATE_VERIFY_FAILED" in port[1]
        assert tls_api.seen == []

    def test_insecure_skip_tls_verify(self, tls_api, tmp_path, capsys):
        tls_api.reset(fx.gpu_pool(2))
        path = kubeconfig(tmp_path / "kc", tls_api.url,
                          cluster="    insecure-skip-tls-verify: true\n")
        jax, port = both(["--kubeconfig", path, "--json"], capsys)
        assert_equal(jax, port)
        assert port[0] == 0

    def test_in_cluster_over_tls(self, tls_api, tmp_path, capsys, monkeypatch):
        # The pod's own path end to end: https://$KUBERNETES_SERVICE_HOST,
        # the service account's token, its ca.crt as the trust root.
        tls_api.reset(fx.gpu_pool(1) + fx.cpu_only_cluster(2))
        sa = tmp_path / "sa"
        sa.mkdir()
        (sa / "token").write_text("pod-token\n")
        (sa / "ca.crt").write_bytes(open(tls_api.cert[0], "rb").read())
        monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "127.0.0.1")
        monkeypatch.setenv("KUBERNETES_SERVICE_PORT", str(urlparse(tls_api.url).port))
        for mod in (jax_cluster, port_cluster):
            monkeypatch.setattr(mod, "SERVICE_ACCOUNT_DIR", str(sa))
            monkeypatch.setattr(mod, "DEFAULT_KUBECONFIG", str(tmp_path / "none"))
        jax, port = both(["--strict-slices", "--slack-only-on-error", "--json"], capsys)
        assert_equal(jax, port)
        assert port[0] == 0 and {s["auth"] for s in tls_api.seen} == {"Bearer pod-token"}
