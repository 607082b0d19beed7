"""The port's copies of the JAX package's fleet-side modules, held equal.

The port imports nothing of the JAX package, not even its stdlib-only
modules, so it keeps copies: ``utils/quantity.py``, ``resources.py``,
``detect.py``, ``report.py``, ``utils/env.py``, ``notify.py``,
``history/``, and the live LIST's ``cluster.py``, ``utils/fanout.py``,
``utils/retry.py``, ``utils/miniyaml.py``, ``fastpath/``, the watch
loop's ``obs/``, the quarantine's ``remediation/``, the history tier's
``analytics/``, the fleet state API's ``server/``, the federation tier's
``federation/``, the ``--watch-stream`` engine's ``watchstream.py`` and
the ``simulate`` subcommand's ``sim/`` and tnc-lint's ``analysis/``
verbatim (only the package name and the module docstring differ; the
lint's ``analysis/__init__.py`` also imports ``analysis.rules``, which
breaks the reference's circular import).  Here
each copy's code is held equal to its original (the syntax trees,
docstrings dropped, the package name substituted where it names a module,
never inside a metric name); the modules copied in part are held equal
function by function (``metrics.py`` with its ``MetricsServer`` class,
and ``checker.py``'s watch-loop helpers, remediation helpers, sweeps,
trend readers, analytics helpers and serving pieces, and its ``watch``
whole, the stream engine's branch included); the budget engine is driven through the same
decisions on both sides; and the constants the fleet grades, lists and
loops by are compared one by one, in the manner of
``tests/test_torch_probe.py::test_floor_tables_equal_jax``.

Also here: a fresh interpreter runs the port's one-shot round over a
NodeList file and over a live fake API server, then two rounds of its
``--watch`` loop, a ``--cordon-failed`` round, ``--trend-nodes``, two
rounds of a ``--watch --serve --analytics`` loop whose fleet API it reads,
two ticks of a ``--watch --watch-stream`` loop over a node watch, and one
``--federate`` round over an upstream fleet API whose global view it reads,
and finds neither ``jax`` nor the JAX package among its modules.

The port is reached through ``importlib.import_module``:
tests/test_dependency_surface.py rejects any other ``import`` in tests/.
"""

import ast
import importlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

from tests import fixtures as fx
from tpu_node_checker import checker as jax_checker
from tpu_node_checker import cluster as jax_cluster
from tpu_node_checker import detect as jax_detect
from tpu_node_checker import notify as jax_notify
from tpu_node_checker import resources as jax_resources
from tpu_node_checker.history import fsm as jax_fsm
from tpu_node_checker.history import store as jax_store
from tpu_node_checker.utils import fanout as jax_fanout
from tpu_node_checker.utils import retry as jax_retry

REPO = Path(__file__).resolve().parent.parent
VERBATIM = ["utils/quantity.py", "resources.py", "detect.py", "report.py", "utils/env.py",
            "notify.py", "history/__init__.py", "history/fsm.py", "history/store.py",
            "utils/fanout.py", "utils/retry.py", "utils/miniyaml.py", "fastpath/__init__.py",
            "fastpath/projection.py", "cluster.py", "obs/__init__.py", "obs/events.py",
            "obs/hist.py", "obs/trace.py", "remediation/__init__.py",
            "remediation/budget.py", "remediation/actuate.py", "remediation/lease.py",
            "remediation/drain.py", "remediation/repair.py", "federation/__init__.py",
            "federation/endpoints.py", "analytics/__init__.py", "analytics/sketch.py",
            "analytics/changepoint.py", "analytics/segments.py", "analytics/queries.py",
            "server/__init__.py", "server/router.py", "server/snapshot.py", "server/auth.py",
            "server/ratelimit.py", "server/feed.py", "server/workers.py", "server/app.py",
            "federation/merge.py", "federation/aggregator.py", "watchstream.py",
            "sim/clock.py", "sim/fixtures.py", "sim/__init__.py", "sim/fleet.py",
            "sim/invariants.py", "sim/engine.py", "sim/scenarios.py", "sim/compose.py",
            "sim/fuzz.py", "sim/cli.py", "sim/analytics_smoke.py",
            "analysis/engine.py", "analysis/rules/base.py", "analysis/rules/locks.py",
            "analysis/rules/contracts.py", "analysis/rules/invariants.py",
            "analysis/flow/graph.py", "analysis/flow/entries.py", "analysis/flow/rules.py",
            "analysis/flow/typestate.py", "analysis/flow/__init__.py",
            "analysis/rules/__init__.py", "analysis/cache.py", "analysis/sarif.py",
            "analysis/__main__.py"]


def _code(path: Path, package: str) -> str:
    """The module's syntax tree without docstrings, the package renamed."""
    return ast.dump(_tree(path, package))


def _tree(path: Path, package: str) -> ast.Module:
    # The package's name as a module, not the metric prefix it starts.
    tree = ast.parse(re.sub(rf"\b{package}\b", "PKG", path.read_text()))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return tree


@pytest.mark.parametrize("module", VERBATIM)
def test_verbatim_copy_equals_jax(module):
    port = _code(REPO / "tpu_node_checker_torch" / module, "tpu_node_checker_torch")
    ref = _code(REPO / "tpu_node_checker" / module, "tpu_node_checker")
    assert port == ref


def test_lint_package_init_differs_only_by_the_rules_import():
    # Importing ``analysis.flow.rules`` first fails on the JAX side on its
    # import cycle; the port's package loads ``analysis.rules`` whole first.
    port = _tree(REPO / "tpu_node_checker_torch" / "analysis" / "__init__.py",
                 "tpu_node_checker_torch")
    ref = _tree(REPO / "tpu_node_checker" / "analysis" / "__init__.py", "tpu_node_checker")
    extra = [n for n in port.body if isinstance(n, ast.Import)]
    assert [ast.dump(n) for n in extra] == \
        [ast.dump(ast.parse("import PKG.analysis.rules").body[0])]
    port.body = [n for n in port.body if n not in extra]
    assert ast.dump(port) == ast.dump(ref)


def _functions(module: str, package: str) -> dict:
    root = REPO / package
    tree = _tree(root / module, package)
    return {n.name: ast.dump(n) for n in tree.body if isinstance(n, ast.FunctionDef)}


def test_grading_view_equals_jax():
    # The content address's preimage, which the relist fast path and the
    # stream's node cache share: equal in code, and on a node.
    port = _functions("watchstream.py", "tpu_node_checker_torch")
    ref = _functions("watchstream.py", "tpu_node_checker")
    assert port["grading_view"] == ref["grading_view"]
    node = fx.make_node("gpu-0", allocatable={"nvidia.com/gpu": "8"})
    assert _port("watchstream").grading_view(node) == \
        importlib.import_module("tpu_node_checker.watchstream").grading_view(node)


def _port(name):
    return importlib.import_module(f"tpu_node_checker_torch.{name}")


def _classes(module: str, package: str) -> dict:
    tree = _tree(REPO / package / module, package)
    return {n.name: ast.dump(n) for n in tree.body if isinstance(n, ast.ClassDef)}


def test_metrics_equals_jax_function_by_function():
    # Every function of the module and the MetricsServer class; only the
    # imports differ (the port's also names the CheckResult it renders).
    port = _functions("metrics.py", "tpu_node_checker_torch")
    ref = _functions("metrics.py", "tpu_node_checker")
    assert list(port) == list(ref) == ["_escape", "_line", "_breaker_lines", "render_metrics"]
    assert port == ref
    assert _classes("metrics.py", "tpu_node_checker_torch") == \
        _classes("metrics.py", "tpu_node_checker")
    assert _port("metrics").METRICS_CONTENT_TYPE == \
        importlib.import_module("tpu_node_checker.metrics").METRICS_CONTENT_TYPE


def test_metric_families_of_the_port_equal_jax():
    # The family names the two renderers can emit (57 in all).
    def families(package):
        text = (REPO / package / "metrics.py").read_text()
        return sorted(set(re.findall(r'"(tpu_node_checker_[a-z_]+)"', text)))

    port, ref = families("tpu_node_checker_torch"), families("tpu_node_checker")
    assert port == ref and len(ref) == 57


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _Lease:
    """A lease client that grants its first ``grants`` requests."""

    def __init__(self, grants):
        self.left, self.asked = grants, []

    def acquire(self, count, action="", node="", trace_id=None):
        self.asked.append((count, action, node, trace_id))
        if self.left >= count:
            self.left -= count
            return True, "lease-granted"
        return False, "lease-denied"

    def as_dict(self):
        return {"left": self.left}


def _engine_run(package, budget_module):
    """One scripted life of a budget engine over a v5p-64 slice, a second
    slice and two GPU nodes: every decision, commit, denial, event and
    payload block, in order."""
    detect = importlib.import_module(f"{package}.detect")
    resources = importlib.import_module(f"{package}.resources")
    nodes = fx.tpu_v5p_64_slice() + fx.gpu_pool(2)
    nodes[3]["spec"]["unschedulable"] = True
    accel, _ = detect.select_accelerator_nodes(nodes, resources.default_registry())
    emitted, clock, lease = [], _Clock(), _Lease(grants=3)

    class Events:
        def emit(self, kind, **fields):
            emitted.append((kind, fields))

    log = []
    for kw in ({"cordon_max": 2, "enabled": False},
               {"slice_floor_pct": 90.0, "cordon_max": 8},
               {"slice_floor_pct": 50.0, "budget": 3, "window_s": 600.0, "cordon_max": 40,
                "lease": lease}):
        engine = budget_module.BudgetEngine(clock=clock, events=Events(), **kw)
        for rnd in range(3):
            clock.t += 300.0
            engine.begin_round(accel, trace_id=f"t{rnd}",
                               degraded={accel[0].name: ["pool/t1/2"]} if rnd else None)
            for action, n in [("uncordon", accel[3]), ("cordon", accel[0]),
                              ("cordon", accel[1]), ("drain", accel[2]),
                              ("cordon", accel[-1]), ("repair", accel[4]),
                              ("clear-annotation", accel[5]), ("cordon", accel[6])]:
                d = engine.decide(action, n, dry_run=(rnd == 2 and action == "drain"))
                log.append(("decide", vars(d).copy()))
                if d.allowed:
                    engine.commit(d)
            log.append(("domain", engine.domain_of(accel[0]), engine.domain_of(accel[-1])))
            log.append(("block", engine.payload_block(), engine.ever_denied))
    fleet = budget_module.FleetLeaseBudget(2, window_s=60.0, clock=clock, events=Events())
    for body in ({"count": 1, "cluster": "a"}, {"count": 2}, {"count": 0}, {"count": True},
                 {"count": 1}):
        log.append(("lease", fleet.grant(body), fleet.remaining()))
    clock.t += 61.0
    fleet.reset_round()
    log.append(("lease", fleet.grant({"count": 2, "action": "cordon", "node": "x"})))
    return log, emitted, lease.asked


def test_denial_fingerprint_equals_jax():
    # The refusal identity, and with it the whole engine it belongs to (the
    # ledger, the decision ladder, the payload block, the fleet lease
    # budget), driven through the same script on both sides.
    from tpu_node_checker.remediation import budget as jax_budget

    port_budget = _port("remediation.budget")
    assert _engine_run("tpu_node_checker_torch", port_budget) == \
        _engine_run("tpu_node_checker", jax_budget)
    for raw in ("4", "4/30s", "2/10m", "1/1d", "3/45"):
        assert port_budget.parse_disruption_budget(raw) == \
            jax_budget.parse_disruption_budget(raw)
    for raw in ("", "0", "4/", "4/0", "4/10y", "-1"):
        with pytest.raises(ValueError) as port_err:
            port_budget.parse_disruption_budget(raw)
        with pytest.raises(ValueError) as jax_err:
            jax_budget.parse_disruption_budget(raw)
        assert str(port_err.value) == str(jax_err.value)
    denials = [{"domain": "pool/2x4", "reason": "slice-floor", "node": "a"},
               {"domain": "pool/2x4", "reason": "slice-floor", "node": "b"},
               {"node": "c", "reason": "cordon-max"}]
    assert port_budget.denial_fingerprint(denials) == \
        jax_budget.denial_fingerprint(denials)
    assert port_budget.DEFAULT_SLICE_FLOOR_PCT == jax_budget.DEFAULT_SLICE_FLOOR_PCT


LOOP_HELPERS = ["_install_stop_signal", "_restore_stop_signal", "_wait_for_next_round",
                "_round_denials_fp", "_round_sick_set", "_recover_last_code",
                "_write_trace_file", "_emit_link_spans", "_mesh_link_samples",
                "_node_mesh_links", "_node_link_domain"]


@pytest.mark.parametrize("name", LOOP_HELPERS)
def test_loop_helper_equals_jax(name):
    port = _functions("checker.py", "tpu_node_checker_torch")
    ref = _functions("checker.py", "tpu_node_checker")
    assert port[name] == ref[name]


# The quarantine's helpers, sweeps and the trend readers of checker.py.
QUARANTINE_HELPERS = ["_remediation_enabled", "_round_events", "_build_remediation",
                      "_degraded_link_evidence", "_uncordon_recovered_nodes", "_ensure_engine",
                      "_failed_candidates", "_drain_failed_nodes", "_cordon_failed_nodes",
                      "_degraded_candidates", "_cordon_degraded_nodes", "_cause_class",
                      "compute_trend_summary", "trend_summary", "trend_nodes"]


@pytest.mark.parametrize("name", QUARANTINE_HELPERS)
def test_quarantine_helper_equals_jax(name):
    port = _functions("checker.py", "tpu_node_checker_torch")
    ref = _functions("checker.py", "tpu_node_checker")
    assert port[name] == ref[name]
    assert _port("checker")._REMEDIATION_CACHE.keys() == jax_checker._REMEDIATION_CACHE.keys()


# The analytics tier's and the fleet API's pieces of checker.py.
ANALYTICS_AND_SERVE_HELPERS = ["_build_analytics", "_node_group_labels", "_fold_round_samples",
                               "_observe_link_drift", "_update_history", "_api_write_decision",
                               "_make_serve_control", "_serve_pool_kwargs", "serve_store"]


@pytest.mark.parametrize("name", ANALYTICS_AND_SERVE_HELPERS)
def test_analytics_and_serve_helper_equals_jax(name):
    port = _functions("checker.py", "tpu_node_checker_torch")
    ref = _functions("checker.py", "tpu_node_checker")
    assert port[name] == ref[name]
    assert _port("checker")._ANALYTICS_CACHE.keys() == jax_checker._ANALYTICS_CACHE.keys()


def test_check_result_and_round_equal_jax():
    # The round (run_check, with its analytics block) and the result it
    # returns (analytics_docs included) are JAX's, statement for statement.
    port = _functions("checker.py", "tpu_node_checker_torch")
    ref = _functions("checker.py", "tpu_node_checker")
    assert port["run_check"] == ref["run_check"]
    assert _classes("checker.py", "tpu_node_checker_torch")["CheckResult"] == \
        _classes("checker.py", "tpu_node_checker")["CheckResult"]


def test_watch_equals_jax():
    # The whole loop, its --serve and --watch-stream branches included.
    def watch(package):
        fn = next(n for n in _tree(REPO / package / "checker.py", package).body
                  if isinstance(n, ast.FunctionDef) and n.name == "watch")
        return ast.dump(fn)

    port = watch("tpu_node_checker_torch")
    assert "fleet_server" in port and "StreamRoundEngine" in port
    assert port == watch("tpu_node_checker")


def test_watch_breaker_equals_jax():
    port = _classes("checker.py", "tpu_node_checker_torch")
    ref = _classes("checker.py", "tpu_node_checker")
    assert port["WatchBreaker"] == ref["WatchBreaker"]


@pytest.mark.parametrize("module,name", [
    ("detect", "QUARANTINE_ANNOTATION"),
    ("detect", "HARD_PLANNED_DISRUPTIONS"),
    ("detect", "PLANNED_DISRUPTION_TAINTS"),
    ("history.fsm", "DEFAULT_CORDON_AFTER"),
    ("history.fsm", "DEFAULT_UNCORDON_AFTER"),
    ("history.fsm", "DEFAULT_FLAP_THRESHOLD"),
    ("history.fsm", "DEFAULT_FLAP_WINDOW"),
    ("history.store", "DEFAULT_MAX_ROUNDS"),
    ("history.store", "HISTORY_SCHEMA_VERSION"),
    ("notify", "DEFAULT_USERNAME"),
    ("notify", "DEFAULT_ICON"),
    ("notify", "DEFAULT_TIMEOUT_S"),
    ("notify", "DEFAULT_MAX_RETRIES"),
    ("notify", "DEFAULT_RETRY_DELAY_S"),
    ("cluster", "DEFAULT_TIMEOUT_S"),
    ("cluster", "SERVICE_ACCOUNT_DIR"),
    ("cluster", "KubeClient.LIST_PAGE_LIMIT"),
    ("cluster", "KubeClient.EVENTS_PAGE_LIMIT"),
    ("cluster", "KubeClient.EVENTS_MAX_PAGES"),
    ("utils.retry", "DEFAULT_BUDGET_S"),
    ("utils.retry", "DEFAULT_MAX_ATTEMPTS"),
    ("utils.retry", "RETRIABLE_STATUS"),
    ("utils.fanout", "DEFAULT_API_CONCURRENCY"),
    ("checker", "BREAKER_THRESHOLD"),
    ("checker", "BREAKER_MAX_SCALE"),
    ("obs", "DEFAULT_RING_SIZE"),
    ("obs", "DEFAULT_LATENCY_BUCKETS_MS"),
    ("obs", "MESH_LINK_BUCKETS_US"),
])
def test_constant_equals_jax(module, name):
    ref = {"detect": jax_detect, "history.fsm": jax_fsm, "history.store": jax_store,
           "notify": jax_notify, "cluster": jax_cluster, "utils.retry": jax_retry,
           "utils.fanout": jax_fanout, "checker": jax_checker,
           "obs": importlib.import_module("tpu_node_checker.obs")}[module]
    port = _port(module)
    for part in name.split("."):
        port, ref = getattr(port, part), getattr(ref, part)
    assert port == ref


def test_default_matchers_equal_jax():
    port = _port("resources").DEFAULT_MATCHERS
    ref = jax_resources.DEFAULT_MATCHERS
    assert [(m.pattern, m.family, m.vendor) for m in port] == \
        [(m.pattern, m.family, m.vendor) for m in ref]
    assert port[0].pattern == "nvidia.com/gpu"


def test_round_constants_equal_jax():
    port = _port("checker")
    for name in ("EXIT_OK", "EXIT_ERROR", "EXIT_NO_ACCEL_NODES", "EXIT_NONE_READY",
                 "CLOCK_SKEW_ALLOWANCE_S", "REPORT_SCHEMA_VERSION", "_CAUSES_CAP",
                 "_EVENTS_NODE_CAP", "_EVENTS_PER_NODE", "_CLIENT_CACHE_MAX"):
        assert getattr(port, name) == getattr(jax_checker, name), name


def test_slack_defaults_of_the_cli_equal_jax():
    from tpu_node_checker import cli as jax_cli

    port, ref = _port("cli").build_parser(), jax_cli.build_parser()
    for dest in ("slack_username", "slack_retry_count", "slack_retry_delay",
                 "probe_results_max_age", "history_max_rounds", "cordon_after",
                 "uncordon_after", "flap_threshold", "flap_window", "kubeconfig", "context",
                 "label_selector", "api_concurrency", "retry_budget", "node_events",
                 "slack_on_change", "event_log", "watch", "metrics_port"):
        assert port.get_default(dest) == ref.get_default(dest), dest


@pytest.mark.parametrize("flag", ["--kubeconfig", "--context", "--label-selector",
                                  "--api-concurrency", "--retry-budget", "--node-events",
                                  "--slack-on-change", "--event-log"])
def test_live_list_flag_help_equals_jax(flag):
    # The flag's words, as JAX gives them (--api-concurrency names only the
    # fan-out the port has).
    from tpu_node_checker import cli as jax_cli

    def action(parser):
        return next(a for a in parser._actions if flag in a.option_strings)

    port, ref = action(_port("cli").build_parser()), action(jax_cli.build_parser())
    assert (port.type, port.metavar, port.nargs, port.const) == \
        (ref.type, ref.metavar, ref.nargs, ref.const)
    if flag != "--api-concurrency":
        assert port.help == ref.help


def test_the_round_loads_nothing_of_jax(tmp_path):
    # In one fresh interpreter: a round over a NodeList file, one over a
    # live fake API server (paged LIST and --node-events), two rounds of
    # the --watch loop over that server (its wait ends after the second),
    # a --cordon-failed round that PATCHes one node, --trend-nodes, two
    # rounds of a --watch --serve --analytics loop whose fleet API each
    # wait reads, two ticks of a --watch-stream loop over a second server
    # that speaks the node watch, and one --federate round over an upstream
    # fleet API whose global summary the wait reads.
    items = fx.mixed_cluster_one_notready()
    reports = tmp_path / "reports"
    reports.mkdir()
    (reports / "gke-gpu-pool-1.json").write_text(json.dumps(
        {"ok": False, "level": "compute", "hostname": "gke-gpu-pool-1",
         "written_at": time.time(), "error": "matmul numerics failed"}))
    patches = []
    nodes = tmp_path / "nodes.json"
    nodes.write_text(json.dumps(fx.node_list(items)))
    server = fx.serve_http(_nodes_and_events_handler(items, patches))
    script_feed = fx.WatchScript([{"live": True}])
    stream_server = fx.serve_http(fx.watch_nodelist_handler(items, script_feed))
    kubeconfig, stream_kubeconfig = tmp_path / "kubeconfig", tmp_path / "stream-kubeconfig"
    for path, srv in ((kubeconfig, server), (stream_kubeconfig, stream_server)):
        path.write_text(
            "apiVersion: v1\ncurrent-context: c\n"
            "contexts:\n- name: c\n  context:\n    cluster: cl\n    user: u\n"
            "clusters:\n- name: cl\n  cluster:\n"
            f"    server: http://127.0.0.1:{srv.server_address[1]}\n"
            "users:\n- name: u\n  user:\n    token: tok\n")
    endpoints = tmp_path / "endpoints.json"
    script = (
        "import json, sys\n"
        "from tpu_node_checker_torch import cli\n"
        f"rc = cli.main(['--nodes-json', {str(nodes)!r}, '--json', '--history', "
        f"{str(tmp_path / 'h.jsonl')!r}])\n"
        "from tpu_node_checker_torch.cluster import KubeClient\n"
        "f = KubeClient.list_nodes_projected\n"
        "f.__defaults__ = f.__defaults__[:-1] + (2,)  # pages of 2 nodes\n"
        f"live = cli.main(['--kubeconfig', {str(kubeconfig)!r}, '--node-events', '--json'])\n"
        "loaded = sorted(m for m in sys.modules\n"
        "                if m.split('.')[0] in ('jax', 'jaxlib', 'tpu_node_checker'))\n"
        "from tpu_node_checker_torch import checker\n"
        "waits = []\n"
        "checker._wait_for_next_round = lambda stop, s: waits.append(s) or len(waits) == 2\n"
        f"loop = cli.main(['--kubeconfig', {str(kubeconfig)!r}, '--watch', '1', "
        f"'--slack-on-change', '--metrics-port', '0', '--history', "
        f"{str(tmp_path / 'w.jsonl')!r}, '--log-jsonl', {str(tmp_path / 'l.jsonl')!r}, "
        f"'--event-log', {str(tmp_path / 'e.jsonl')!r}, '--json'])\n"
        f"cordon = cli.main(['--kubeconfig', {str(kubeconfig)!r}, '--probe-results', "
        f"{str(reports)!r}, '--cordon-failed', '--history', {str(tmp_path / 'c.jsonl')!r}, "
        "'--json'])\n"
        f"trend = cli.main(['--trend-nodes', {str(tmp_path / 'c.jsonl')!r}, '--json'])\n"
        "import urllib.request\n"
        "from tpu_node_checker_torch.server import app\n"
        "servers, served, init = [], [], app.FleetStateServer.__init__\n"
        "app.FleetStateServer.__init__ = lambda s, *a, **k: (init(s, *a, **k), servers.append(s))[0]\n"
        "def read(stop, s):\n"
        "    for path in ('/readyz', '/api/v1/summary', '/api/v1/analytics/slo'):\n"
        "        url = f'http://127.0.0.1:{servers[0].port}{path}'\n"
        "        with urllib.request.urlopen(url, timeout=10) as resp:\n"
        "            served.append(resp.status)\n"
        "    return len(served) == 6\n"
        "checker._wait_for_next_round = read\n"
        f"served_loop = cli.main(['--kubeconfig', {str(kubeconfig)!r}, '--watch', '1', "
        f"'--serve', '0', '--serve-workers', '2', '--history', {str(tmp_path / 's.jsonl')!r}, "
        f"'--analytics', {str(tmp_path / 'analytics')!r}, '--json'])\n"
        "loaded = sorted(m for m in sys.modules\n"
        "                if m.split('.')[0] in ('jax', 'jaxlib', 'tpu_node_checker'))\n"
        "ticks = []\n"
        "checker._wait_for_next_round = lambda stop, s: ticks.append(s) or len(ticks) == 2\n"
        f"stream = cli.main(['--kubeconfig', {str(stream_kubeconfig)!r}, '--watch', '1', "
        "'--watch-stream', '--json'])\n"
        "upstream = app.FleetStateServer(0, host='127.0.0.1')\n"
        f"upstream.publish(checker.run_check(cli.parse_args(['--nodes-json', {str(nodes)!r}, "
        "'--cluster-name', 'up'])))\n"
        f"open({str(endpoints)!r}, 'w').write(json.dumps({{'clusters': [{{'name': 'up', "
        "'url': f'http://127.0.0.1:{upstream.port}'}]}))\n"
        "summary = []\n"
        "def read_global(stop, s):\n"
        "    url = f'http://127.0.0.1:{servers[-1].port}/api/v1/global/summary'\n"
        "    with urllib.request.urlopen(url, timeout=10) as resp:\n"
        "        summary.append(json.loads(resp.read()))\n"
        "    return True\n"
        "checker._wait_for_next_round = read_global\n"
        f"fed = cli.main(['--federate', {str(endpoints)!r}, '--serve', '0', "
        "'--retry-budget', '0'])\n"
        "upstream.close()\n"
        "loaded = sorted(m for m in sys.modules\n"
        "                if m.split('.')[0] in ('jax', 'jaxlib', 'tpu_node_checker'))\n"
        "print(stream, len(ticks), fed, summary[0]['total_nodes'], summary[0]['healthy'], "
        "file=sys.stderr)\n"
        "print(served_loop, served, file=sys.stderr)\n"
        "print(rc, live, loop, len(waits), cordon, trend, loaded, file=sys.stderr)\n"
    )
    try:
        proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                              cwd=REPO, timeout=120)
    finally:
        server.shutdown()
        script_feed.close()
        stream_server.shutdown()
    assert proc.returncode == 0, proc.stderr
    (first, live, *rounds, cordon, trend, served1, served2,
     tick1, tick2) = _json_docs(proc.stdout)
    assert proc.stderr.strip().splitlines()[-3:] == [f"143 2 143 {first['total_nodes']} True",
                                                      "143 [200, 200, 200, 200, 200, 200]",
                                                      "0 0 143 2 0 0 []"]
    assert tick2["nodes"] == tick1["nodes"]
    assert [n["name"] for n in tick1["nodes"]] == [n["name"] for n in first["nodes"]]
    assert tick2["watch_stream"]["relists_total"] == {"seed": 1}
    assert [r["analytics"]["predictions"] for r in (served1, served2)] == [[], []]
    assert [r["exit_code"] for r in rounds] == [0, 0]
    assert cordon["cordon"]["cordoned"] == ["gke-gpu-pool-1"]
    assert [p["path"] for p in patches] == ["/api/v1/nodes/gke-gpu-pool-1"]
    assert trend["worst_offenders"][0] == "gke-gpu-pool-1"
    assert (tmp_path / "l.jsonl").read_text().count("\n") == 2
    assert first["exit_code"] == live["exit_code"] == 0
    sick = [n for n in live["nodes"] if not n["ready"]]
    assert [e["reason"] for n in sick for e in n["events"]] == ["NodeNotReady"]
    pages = -(-len(items) // 2)
    assert live["cluster"] == "c"
    assert live["api_transport"]["requests_sent"] == pages + len(sick)


def _json_docs(text):
    """The JSON documents printed one after another."""
    docs, decoder, i = [], json.JSONDecoder(), 0
    while text[i:].strip():
        i += len(text[i:]) - len(text[i:].lstrip())
        doc, i = decoder.raw_decode(text, i)
        docs.append(doc)
    return docs


def _nodes_and_events_handler(items, patches):
    """Paged ``/api/v1/nodes``, one Warning event per node name, and each
    PATCH's path recorded in ``patches``."""
    from http.server import BaseHTTPRequestHandler
    from urllib.parse import parse_qs, urlparse

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_GET(self):  # noqa: N802 — the handler protocol's name
            url = urlparse(self.path)
            if url.path == "/api/v1/events":
                sel = parse_qs(url.query)["fieldSelector"][0]
                name = sel.split("involvedObject.name=")[1].split(",")[0]
                body = json.dumps({"items": [{"type": "Warning", "reason": "NodeNotReady",
                                              "message": f"{name} stopped posting"}]}).encode()
            else:
                body = fx.paged_nodelist_body(items, self.path, None)
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_PATCH(self):  # noqa: N802 — the handler protocol's name
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            patches.append({"path": self.path})
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"{}")

        def log_message(self, *args):
            pass

    return Handler
