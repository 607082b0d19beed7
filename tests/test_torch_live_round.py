"""The port's one-shot round over a live fake API server, held against the
JAX checker's: ``--node-events``, ``--api-concurrency``, ``--probe``,
``--history``, the relist fast path's reuse across rounds, and the usage
rules of the live LIST's flags.

The fake apiserver is ``tests/test_torch_cluster.py``'s (one per module,
on an ephemeral port).  The same argv goes through the JAX CLI's ``main``
and the port's; exit codes, text stdout and stderr notes must be equal, and
the ``--json`` payloads equal once ``trace_id`` and ``timings_ms`` are
dropped.  Where the events fan-out runs more than one worker, the server
holds the first requests until as many are in flight as there are workers,
so each side opens the same number of connections.

The port is reached through ``importlib.import_module``:
tests/test_dependency_surface.py rejects any other ``import`` in tests/.
"""

import importlib
import json

import pytest

from tests import fixtures as fx
from tests.test_torch_cluster import (
    ApiServer,
    _isolated,  # noqa: F401 — the autouse fixture, for this module too
    both,
    kubeconfig,
    payload,
    run,
    small_pages,
)
from tests.test_torch_cluster import assert_equal as equal
from tests.test_torch_cluster import outcome_vs_jax
from tpu_node_checker import cli as jax_cli
from tpu_node_checker import probe as jax_probe

port_cli = importlib.import_module("tpu_node_checker_torch.cli")
port_checker = importlib.import_module("tpu_node_checker_torch.checker")
port_liveness = importlib.import_module("tpu_node_checker_torch.probe.liveness")
port_build = importlib.import_module("tpu_node_checker_torch.ops._build")


@pytest.fixture(scope="module")
def api():
    state = ApiServer()
    server = fx.serve_http(state.handler())
    state.url = f"http://127.0.0.1:{server.server_address[1]}"
    yield state
    server.shutdown()
    server.server_close()


def event(reason, message, typ="Warning", last="2026-10-01T10:00:00Z", count=1):
    return {"type": typ, "reason": reason, "message": message, "count": count,
            "lastTimestamp": last, "involvedObject": {"kind": "Node"}}


def sick_fleet(sick, healthy=3):
    """``healthy`` Ready GPU nodes, then ``sick`` NotReady ones, each sick
    node with four events (a Normal, two Warnings and an older Warning)."""
    nodes = fx.gpu_pool(healthy)
    down = fx.gpu_pool(sick, ready=False)
    for i, n in enumerate(down):
        n["metadata"]["name"] = f"gke-gpu-down-{i}"
    events = {
        n["metadata"]["name"]: [
            event("Starting", "kubelet starting", typ="Normal", last="2026-10-01T10:05:00Z"),
            event("NodeNotReady", f"{n['metadata']['name']} stopped posting status",
                  last="2026-10-01T10:04:00Z"),
            event("SystemOOM", "  oom-kill:\n  constraint=CONSTRAINT_NONE  ",
                  last="2026-10-01T10:03:00Z", count=4),
            event("Rebooted", "rebooted", last="2026-09-30T10:00:00Z"),
        ]
        for n in down
    }
    return nodes + down, events


def arm(api, workers, sick):
    """Before each side: hold the fan-out's first requests together."""
    n = min(workers, sick)
    return (lambda: api.arm_barrier(n)) if n > 1 else None


class TestNodeEvents:
    @pytest.mark.parametrize("json_mode", [False, True], ids=["text", "json"])
    @pytest.mark.parametrize("concurrency", [None, 1, 4], ids=["default", "1", "4"])
    @pytest.mark.parametrize("sick", [1, 5, 10])
    def test_events_of_sick_nodes_equal_jax(self, api, tmp_path, capsys, monkeypatch, sick,
                                            concurrency, json_mode):
        small_pages(monkeypatch, 4)
        api.reset(*sick_fleet(sick))
        argv = ["--kubeconfig", kubeconfig(tmp_path / "kc", api.url), "--node-events"]
        argv += ["--api-concurrency", str(concurrency)] if concurrency else []
        argv += ["--json"] if json_mode else []
        jax, port = both(argv, capsys, before=arm(api, concurrency or 4, sick))
        equal(jax, port, json_mode)
        assert port[0] == 0
        fetched = min(sick, 8)
        events_seen = [s for s in api.seen if s["path"] == "/api/v1/events"]
        assert len(events_seen) == 2 * fetched
        if sick > 8:
            assert port[2] == f"--node-events: {sick - 8} more sick node(s) beyond the " \
                              "8-node fetch cap\n"
        else:
            assert port[2] == ""
        if json_mode:
            doc = payload(port[1])
            with_events = [n for n in doc["nodes"] if "events" in n]
            assert [n["name"] for n in with_events] == \
                [f"gke-gpu-down-{i}" for i in range(fetched)]
            assert [e["reason"] for e in with_events[0]["events"]] == \
                ["NodeNotReady", "SystemOOM", "Rebooted"]
            assert with_events[0]["events"][1]["message"] == \
                "oom-kill: constraint=CONSTRAINT_NONE"
            pages = -(-(3 + sick) // 4)
            stats = doc["api_transport"]
            assert stats["requests_sent"] == pages + fetched
            workers = min(concurrency or 4, fetched)
            assert stats["connections_opened"] == workers
            assert "degraded" not in doc

    def test_forbidden_events_degrade_the_round(self, api, tmp_path, capsys, monkeypatch):
        # No 'events: list' RBAC: every fetch is a 403, the round keeps its
        # grade and says which nodes' triage is missing.
        api.reset(*sick_fleet(2))
        api.events_status = 403
        for json_mode in (False, True):
            argv = ["--kubeconfig", kubeconfig(tmp_path / "kc", api.url), "--node-events",
                    "--api-concurrency", "1"] + (["--json"] if json_mode else [])
            jax, port = both(argv, capsys)
            equal(jax, port, json_mode)
            assert port[0] == 0
        doc = payload(port[1])
        assert doc["degraded"] is True
        assert [e.split(":")[0] for e in doc["degradation"]["events"]] == \
            ["gke-gpu-down-0", "gke-gpu-down-1"]
        assert "HTTP 403" in doc["degradation"]["events"][0]
        assert port[2].count("Cannot fetch events for") == 2

    def test_a_truncated_events_walk_is_named(self, api, tmp_path, capsys, monkeypatch):
        api.reset(*sick_fleet(1))
        api.endless_events = True
        argv = ["--kubeconfig", kubeconfig(tmp_path / "kc", api.url), "--node-events", "--json"]
        jax, port = both(argv, capsys)
        equal(jax, port)
        doc = payload(port[1])
        assert doc["degradation"] == {"events_truncated": ["gke-gpu-down-0"]}
        assert doc["api_transport"]["list_truncated"] == {"events": 1}
        assert doc["api_transport"]["requests_sent"] == 1 + 10
        assert "event list exceeded 10 pages" in port[2]

    def test_no_sick_node_fetches_nothing(self, api, tmp_path, capsys):
        api.reset(fx.gpu_pool(3))
        argv = ["--kubeconfig", kubeconfig(tmp_path / "kc", api.url), "--node-events", "--json"]
        jax, port = both(argv, capsys)
        equal(jax, port)
        assert [s["path"] for s in api.seen] == ["/api/v1/nodes"] * 2

    def test_the_slack_bullet_carries_the_top_event(self, api, tmp_path, capsys, monkeypatch):
        # A failing round posts before stdout (to a stand-in for the
        # delivery); the message is built by each package's report module
        # from the events attached.
        api.reset(*sick_fleet(2, healthy=0))
        posts = {}
        for side, mod in (("jax", "tpu_node_checker.report"),
                          ("port", "tpu_node_checker_torch.report")):
            report = importlib.import_module(mod)
            real = report.format_slack_message
            monkeypatch.setattr(report, "format_slack_message",
                                lambda *a, real=real, side=side, **k:
                                posts.setdefault(side, real(*a, **k)))
        for side in ("jax", "port"):
            notify = importlib.import_module(
                "tpu_node_checker.notify" if side == "jax" else "tpu_node_checker_torch.notify")
            monkeypatch.setattr(notify, "send_slack_message", lambda *a, **k: True)
        argv = ["--kubeconfig", kubeconfig(tmp_path / "kc", api.url), "--node-events",
                "--slack-webhook", "http://127.0.0.1:1/hook", "--slack-only-on-error",
                "--strict-slices"]
        jax, port = both(argv, capsys)
        equal(jax, port, json_mode=False)
        assert posts["port"] == posts["jax"]
        assert "NodeNotReady" in posts["port"] and port[0] == 3


class _Probed:
    def __init__(self, ok=True):
        self.doc = {"ok": ok, "level": "compute", "device_count": 1, "platform": "stub",
                    "hostname": "stub", "error": None if ok else "stub failure"}

    def to_dict(self):
        return dict(self.doc)


class TestProbe:
    @pytest.mark.parametrize("ok", [True, False], ids=["passing", "failing"])
    def test_probe_arguments_and_grade_equal_jax(self, api, tmp_path, capsys, monkeypatch,
                                                 ok):
        # Stubbed on both sides: what the round over a live LIST hands the
        # probe, and how it grades the verdict.
        api.reset(*sick_fleet(1, healthy=2))
        monkeypatch.setenv("NODE_NAME", "gke-gpu-pool-1")
        calls = {"jax": [], "port": []}

        def stub(side):
            def run_probe(**kw):
                calls[side].append(kw)
                return _Probed(ok)
            return run_probe

        monkeypatch.setattr(jax_probe, "run_local_probe", stub("jax"))
        monkeypatch.setattr(port_liveness, "run_local_probe", stub("port"))
        argv = ["--kubeconfig", kubeconfig(tmp_path / "kc", api.url), "--probe",
                "--probe-level", "compute", "--node-events", "--json"]
        jax, port = both(argv, capsys)
        equal(jax, port)
        (j,), (p,) = calls["jax"], calls["port"]
        assert p.pop("device") == "cuda:0" and p == j and p["expected_devices"] == 1
        entry = next(n for n in payload(port[1])["nodes"] if n["name"] == "gke-gpu-pool-1")
        assert entry["probe"]["ok"] is ok
        sick = [n["name"] for n in payload(port[1])["nodes"] if "events" in n]
        assert sick == ([] if ok else ["gke-gpu-pool-1"]) + ["gke-gpu-down-0"]

    def test_cpu_probe_over_a_live_list(self, api, tmp_path, capsys, monkeypatch):
        # The port's own probe, end to end in a child on the CPU (the plain
        # kernel versions), attached to NODE_NAME's node of the live LIST.
        api.reset(fx.gpu_pool(2) + fx.cpu_only_cluster(2))
        monkeypatch.setenv("NODE_NAME", "gke-gpu-pool-1")
        monkeypatch.setenv("OMP_NUM_THREADS", "2")
        argv = ["--kubeconfig", kubeconfig(tmp_path / "kc", api.url), "--probe", "--device",
                "cpu", "--probe-level", "compute", "--strict-slices", "--json"]
        rc, out, err = run(port_cli.main, argv, capsys)
        assert rc == 0, err
        doc = json.loads(out)
        node = next(n for n in doc["nodes"] if n["name"] == "gke-gpu-pool-1")
        assert node["probe"] == doc["local_probe"]
        assert node["probe"]["ok"] is True and node["probe"]["platform"] == "cpu"
        assert node["probe"]["kernel_launches"] == dict.fromkeys(port_build.KERNELS, 0)
        assert {"config", "list", "detect", "probe", "render"} <= set(doc["timings_ms"])
        assert doc["api_transport"]["requests_sent"] == 1


class TestRounds:
    def test_history_over_two_live_rounds(self, api, tmp_path, capsys, monkeypatch):
        # One store each; the node goes down between the rounds.
        path = kubeconfig(tmp_path / "kc", api.url)
        states = {}
        for i, ready in enumerate((True, False)):
            api.reset(fx.gpu_pool(2, ready=ready))
            got = []
            for side, main in (("jax", jax_cli.main), ("port", port_cli.main)):
                got.append(run(main, ["--kubeconfig", path, "--history",
                                       str(tmp_path / f"{side}.jsonl"), "--cordon-after", "2",
                                       "--json"], capsys))
            equal(*got)
            states[i] = [n["health"]["state"] for n in payload(got[1][1])["nodes"]]
        assert states == {0: ["HEALTHY", "HEALTHY"], 1: ["SUSPECT", "SUSPECT"]}
        assert (tmp_path / "port.jsonl").read_text().count("\n") == \
            (tmp_path / "jax.jsonl").read_text().count("\n") == 4

    def test_reuse_across_rounds_on_the_cached_client(self, api, tmp_path, capsys,
                                                      monkeypatch):
        # No per-round attachment: the second round reuses the first's
        # NodeInfo by content digest; one node changes in between.
        small_pages(monkeypatch, 3)
        path = kubeconfig(tmp_path / "kc", api.url)
        api.reset(fx.tpu_v5p_64_slice())
        for nodes in (api.nodes, fx.tpu_v5p_64_slice(not_ready=1)):
            api.nodes = nodes
            for json_mode in (False, True):
                argv = ["--kubeconfig", path, "--strict-slices"] + (
                    ["--json"] if json_mode else [])
                equal(*both(argv, capsys), json_mode)
        client = next(iter(port_checker._CLIENT_CACHE.values()))
        assert client.projector_stats is not None

    def test_the_cronjob_argv_in_text_and_json(self, api, tmp_path, capsys):
        # deploy/cronjob.yaml's command, over a kubeconfig.
        api.reset(fx.tpu_v5p_64_slice(not_ready=1) + fx.gpu_pool(2))
        base = ["--kubeconfig", kubeconfig(tmp_path / "kc", api.url), "--strict-slices",
                "--slack-only-on-error"]
        for json_mode in (False, True):
            jax, port = both(base + (["--json"] if json_mode else []), capsys)
            equal(jax, port, json_mode)
            assert port[0] == 3

    def test_debug_prints_the_same_phases(self, api, tmp_path, capsys):
        api.reset(*sick_fleet(1))
        argv = ["--kubeconfig", kubeconfig(tmp_path / "kc", api.url), "--node-events", "--debug"]
        jax, port = both(argv, capsys)
        phases = [json.loads(out.rsplit("Timings (ms): ", 1)[1]).keys() for _, out, _ in (jax, port)]
        assert list(phases[0]) == list(phases[1]) == \
            ["config", "list", "detect", "events", "render", "total"]


def _usage(parse, argv, capsys):
    with pytest.raises(SystemExit) as exc:
        parse(argv)
    return exc.value.code, capsys.readouterr().err.strip().splitlines()[-1]


USAGE_EQUAL_JAX = [
    (["--nodes-json", "n.json", "--node-events"],
     "--node-events requires a live cluster (not --nodes-json)"),
    (["--emit-probe", "-", "--node-events"], "--node-events cannot be combined with --emit-probe"),
    (["--api-concurrency", "0"], "--api-concurrency must be at least 1 (1 = serial)"),
    (["--retry-budget", "-1"], "--retry-budget must be >= 0 (0 disables retries)"),
    (["--api-concurrency", "two"], "argument --api-concurrency: invalid int value: 'two'"),
    (["--retry-budget", "x"], "argument --retry-budget: invalid float value: 'x'"),
    (["--selftest", "--node-events"], "--selftest runs alone"),
    (["--selftest", "--label-selector", "a=b"], "--selftest runs alone"),
    (["--calibrate", "2", "--probe-level", "compute", "--node-events"],
     "--calibrate runs alone"),
    (["--calibrate", "2", "--probe-level", "compute", "--label-selector", "a"],
     "--calibrate runs alone"),
    (["--probe-report-schema", "--kubeconfig", "k"], "--probe-report-schema runs alone"),
    (["--probe-report-schema", "--retry-budget", "0"], "--probe-report-schema runs alone"),
]


class TestUsage:
    @pytest.mark.parametrize("argv,message", USAGE_EQUAL_JAX)
    def test_jax_rule_with_jax_words(self, capsys, argv, message):
        port_code, port_err = _usage(port_cli.parse_args, argv, capsys)
        jax_code, jax_err = _usage(jax_cli.parse_args, argv, capsys)
        assert port_code == jax_code == 2
        assert port_err.split(": error: ")[1] == jax_err.split(": error: ")[1]
        assert port_err.split(": error: ")[1].startswith(message)

    @pytest.mark.parametrize("flag", [["--kubeconfig", "k"], ["--context", "c"],
                                      ["--label-selector", "a"], ["--api-concurrency", "2"],
                                      ["--retry-budget", "5"]])
    @pytest.mark.parametrize("mode", [["--emit-probe", "-"], ["--selftest"],
                                      ["--calibrate", "2", "--probe-level", "compute"]])
    def test_a_list_flag_beside_a_node_side_mode(self, capsys, flag, mode):
        # The port's rule: a flag of the round beside another mode would do
        # nothing, so it is refused (JAX's own rule speaks first where it has one).
        code, err = _usage(port_cli.parse_args, mode + flag, capsys)
        if "--calibrate" in mode and flag[0] == "--label-selector":
            assert err.endswith("error: --calibrate runs alone (only --probe-level/"
                                "--probe-timeout/--probe-soak/--probe-topology and "
                                "--calibrate-margin/--calibrate-out may accompany it)")
        elif "--selftest" in mode and flag[0] == "--label-selector":
            assert "error: --selftest runs alone" in err
        else:
            assert code == 2 and err.endswith(
                f"error: {flag[0]} belongs to the one-shot round: it cannot be combined "
                f"with {mode[0]}")

    @pytest.mark.parametrize("argv", [
        [], ["--kubeconfig", "k", "--context", "c", "--label-selector", "a=b,c!=d",
             "--api-concurrency", "2", "--retry-budget", "0", "--node-events"],
        ["--kubeconfig", "k", "--strict-slices", "--slack-only-on-error", "--json"],
        ["--retry-budget", "2.5", "--probe", "--probe-level", "workload"],
    ])
    def test_parses_as_jax_parses_it(self, argv):
        port, jax = port_cli.parse_args(argv), jax_cli.parse_args(argv)
        for dest, value in vars(port).items():
            if hasattr(jax, dest):
                assert value == getattr(jax, dest), dest

    @pytest.mark.parametrize("flag", [
        ["--federate-workers", "2"], ["--watch-stream"], ["--no-watch-stream"],
        ["--federate-feed"], ["--federate-interval", "5"],
        ["--watch-stream", "--no-watch-stream"], ["--federate", "e"], ["--federate=e"],
        ["--fleet-disruption-budget", "2"],
    ])
    def test_queue_4_flags_still_refused(self, capsys, flag):
        # The watch stream and federation, the last of Queue 4, are ported:
        # beside a one-shot live round each is still refused (never accepted
        # and ignored), now with JAX's usage error, or parsed as JAX parses
        # it (--no-watch-stream, the default, last on the line).
        got = outcome_vs_jax(["--kubeconfig", "k", *flag], capsys)
        if flag[-1] == "--no-watch-stream":
            assert got.watch_stream is False
        else:
            assert flag[0].split("=")[0] in got

    @pytest.mark.parametrize("flag,expected", [
        (["--cordon-failed"], "--cordon-failed requires --probe or --probe-results DIR"),
        (["--cordon-max", "2"], "--cordon-max requires --cordon-failed, --drain-failed or --serve"),
        (["--cordon-dry-run"], "--cordon-dry-run requires --cordon-failed or --uncordon-recovered"),
        (["--uncordon-recovered"], "--uncordon-recovered requires --probe or --probe-results DIR"),
        (["--cordon-degraded"], "--cordon-degraded requires --probe or --probe-results DIR"),
        (["--drain-failed"], "--drain-failed requires --probe or --probe-results DIR"),
        (["--repair-cmd", "r"], "--repair-cmd/--repair-webhook require --history FILE (repair "
         "state rides the store so a restart never double-fires)"),
        (["--disruption-budget", "2"], "--disruption-budget requires --cordon-failed or "
         "--drain-failed (a budget with no actuator gates nothing)"),
        (["--slice-floor-pct", "50"], "--slice-floor-pct requires --cordon-failed or "
         "--drain-failed (a budget with no actuator gates nothing)"),
        (["--trend", "t"], ("trend", "t")),
        (["--trend-nodes", "t"], ("trend_nodes", "t")),
        (["--repair-webhook", "u"], "--repair-cmd/--repair-webhook require --history FILE "
         "(repair state rides the store so a restart never double-fires)"),
    ])
    def test_quarantine_flags_beside_a_live_round_as_jax(self, capsys, flag, expected):
        # Once unknown arguments; ported with JAX's usage errors, or parsed
        # to JAX's values (the readers, which JAX lets accompany a live
        # round's flags).
        got = outcome_vs_jax(["--kubeconfig", "k", *flag], capsys)
        if isinstance(expected, tuple):
            assert getattr(got, expected[0]) == expected[1]
        else:
            assert got == expected
