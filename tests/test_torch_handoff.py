"""The port's reports handed to the unchanged JAX fleet checker, and the
port's probe parent held against the JAX parent.

A port report reaches the fleet one way only: the DaemonSet's emitter writes
``$NODE_NAME.json`` on a shared volume and the aggregator, the JAX checker,
grades it through ``--probe-results DIR``.  Here the port's
``emit_probe_once(..., device="cpu")`` writes the reports, and the JAX CLI
runs as a subprocess over ``tests/fixtures.py`` GPU nodes, as the aggregator
runs it: a healthy report keeps the node ready (exit 0), a failing one fails
it (exit 3, the host named), and a stale or schema-broken one is skipped.

The parent's side of ``--probe-soak``, ``--probe-topology`` and
``--perf-floor`` (the child's kill-timer and environment) must equal the JAX
parent's for the same arguments, and a timed-out child must leave no process
of its session behind: the port's child spawns one rank per extra card.

torch and the port are reached through ``importlib.import_module``:
tests/test_dependency_surface.py rejects any other ``import`` in tests/.
"""

import importlib
import json
import os
import select
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from tests import fixtures as fx
from tpu_node_checker.probe import liveness as jax_liveness
from tpu_node_checker.probe import schema as jax_schema

port_emit = importlib.import_module("tpu_node_checker_torch.emit")
port_liveness = importlib.import_module("tpu_node_checker_torch.probe.liveness")

REPO = Path(__file__).resolve().parent.parent
NODE = "gke-gpu-pool-0"
WALL_CLOCK_BUDGET_S = 60.0


@pytest.fixture(scope="module")
def port_reports(tmp_path_factory):
    """Reports the port's emitter wrote on the CPU for ``NODE``: a healthy
    enumerate report, a healthy compute report, and a failing collective
    report (``TNC_CHAOS_RING_LINK=0``: the ring's one link faulted)."""
    out = tmp_path_factory.mktemp("port-reports")
    docs = {}
    with pytest.MonkeyPatch.context() as mp:
        for k in [k for k in os.environ if k.startswith("TNC_")]:
            mp.delenv(k)
        mp.setenv("NODE_NAME", NODE)
        mp.setenv("TNC_SCHEMA_STRICT", "1")  # an off-contract report raises
        mp.setenv("OMP_NUM_THREADS", "2")
        for name, level, env in (
            ("enumerate", "enumerate", {}),
            ("compute", "compute", {}),
            ("failing", "collective", {"TNC_CHAOS_RING_LINK": "0"}),
        ):
            for k, v in env.items():
                mp.setenv(k, v)
            path = out / f"{name}.json"
            rc, doc = port_emit.emit_probe_once(str(path), level=level, timeout_s=300,
                                                device="cpu")
            for k in env:
                mp.delenv(k)
            docs[name] = (rc, json.loads(path.read_text()))
    return docs


def _nodes_file(tmp_path, n):
    path = tmp_path / f"gpu_pool_{n}.json"
    path.write_text(json.dumps(fx.node_list(fx.gpu_pool(n))))
    return path


def _aggregate(tmp_path, doc, n_nodes=1):
    """The aggregator's run: the unchanged JAX CLI over a ``gpu_pool(n)``
    NodeList and a reports directory holding ``doc`` as ``NODE.json``."""
    reports = tmp_path / "reports"
    reports.mkdir()
    (reports / f"{NODE}.json").write_text(json.dumps(doc))
    env = {k: v for k, v in os.environ.items() if not k.startswith("TNC_")}
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_node_checker", "--nodes-json",
         str(_nodes_file(tmp_path, n_nodes)), "--probe-results", str(reports), "--json"],
        capture_output=True, text=True, cwd=REPO, timeout=120, env=env,
    )
    return proc.returncode, json.loads(proc.stdout), proc.stderr


def _node(payload, name=NODE):
    return next(n for n in payload["nodes"] if n["name"] == name)


class TestHandOff:
    @pytest.mark.parametrize("name", ["enumerate", "compute"])
    def test_healthy_report_keeps_the_node_ready(self, tmp_path, port_reports, name):
        rc_emit, doc = port_reports[name]
        assert rc_emit == 0 and doc["ok"] is True, doc.get("error")
        assert doc["hostname"] == NODE and doc["level"] == name
        # The compute keys too pass the JAX package's contract.
        assert jax_schema.validate_report(doc) == []
        rc, payload, err = _aggregate(tmp_path, doc)
        assert rc == 0, err
        probe = _node(payload)["probe"]
        assert probe["ok"] is True and probe["level"] == name
        assert probe["written_at"] == doc["written_at"]
        assert payload["probe_summary"] == {
            "hosts_reported": 1, "hosts_ok": 1, "hosts_failed": [], "hosts_missing": [],
        }
        assert payload["ready_nodes"] == 1

    def test_failing_report_fails_the_node_naming_it(self, tmp_path, port_reports):
        rc_emit, doc = port_reports["failing"]
        assert rc_emit == 3 and doc["ok"] is False
        assert doc["ring_bad_links"] == ["0->0"] and "matmul_ok" in doc
        assert jax_schema.validate_report(doc) == []
        rc, payload, err = _aggregate(tmp_path, doc)
        assert rc == 3, err
        assert payload["probe_summary"]["hosts_failed"] == [NODE]
        assert payload["probe_summary"]["hosts_ok"] == 0
        assert _node(payload)["probe"] == doc  # the port's report, attached whole
        assert payload["ready_nodes"] == 0

    def test_failing_report_with_another_node_ready_exits_0(self, tmp_path, port_reports):
        _, doc = port_reports["failing"]
        rc, payload, err = _aggregate(tmp_path, doc, n_nodes=2)
        assert rc == 0, err
        assert payload["probe_summary"]["hosts_failed"] == [NODE]
        assert payload["ready_nodes"] == 1
        assert _node(payload, "gke-gpu-pool-1")["ready"] is True

    @pytest.mark.parametrize("name", ["enumerate", "compute", "failing"])
    def test_stale_report_is_skipped(self, tmp_path, port_reports, name):
        # Older than the default --probe-results-max-age (900 s): skipped, so
        # a failing report no longer fails the node.
        _, doc = port_reports[name]
        rc, payload, err = _aggregate(tmp_path, {**doc, "written_at": time.time() - 1000})
        assert rc == 0, err
        assert "Skipping stale probe report" in err
        assert payload["probe_summary"]["hosts_reported"] == 0
        assert payload["probe_summary"]["reports_skipped"] == {"stale": 1}
        assert _node(payload).get("probe") is None

    @pytest.mark.parametrize("name,field,value", [
        ("enumerate", "device_count", "one"),
        ("compute", "matmul_tflops", "fast"),
        ("failing", "ring_ok", "no"),
    ])
    def test_schema_broken_report_is_refused(self, tmp_path, port_reports, name, field, value):
        _, doc = port_reports[name]
        assert field in doc
        rc, payload, err = _aggregate(tmp_path, {**doc, field: value})
        assert rc == 0, err
        assert "schema violation" in err and field in err
        assert payload["probe_summary"]["reports_skipped"] == {"schema": 1}
        assert _node(payload).get("probe") is None


def _clean_env(monkeypatch):
    for k in [k for k in os.environ if k.startswith("TNC_")]:
        monkeypatch.delenv(k)


class TestParentParity:
    """``run_local_probe``'s parent side against the JAX parent's, with the
    child faked on both sides: the JAX parent's ``subprocess.run`` and the
    port parent's ``_run_child`` (which takes ``subprocess.run``'s place, in
    a session of its own)."""

    ARGS = [
        ("compute", None, 0.0, None),
        ("compute", None, 20.0, 0.4),
        ("collective", "2x2", 30.0, 0.5),
        ("mesh", "1x1", 0.0, 0.0),
        ("workload", "2x4", 5.5, None),
    ]

    @staticmethod
    def _fake_child(calls, raise_timeout=False):
        def fake(argv, **kw):
            calls.append(kw)
            if raise_timeout:
                raise subprocess.TimeoutExpired(argv, kw["timeout"])
            report = {"ok": True, "level": argv[3], "device_count": 1}
            return subprocess.CompletedProcess(argv, 0, json.dumps(report) + "\n", "")
        return fake

    @pytest.mark.parametrize("level,topology,soak_s,perf_floor", ARGS)
    def test_kill_timer_and_child_env_equal_jax(self, monkeypatch, level, topology, soak_s,
                                                perf_floor):
        _clean_env(monkeypatch)
        port_calls, jax_calls = [], []
        monkeypatch.setattr(port_liveness, "_run_child", self._fake_child(port_calls))
        monkeypatch.setattr(jax_liveness.subprocess, "run", self._fake_child(jax_calls))
        kw = dict(level=level, topology=topology, soak_s=soak_s, perf_floor=perf_floor)
        port = port_liveness.run_local_probe(device="cpu", **kw)
        ref = jax_liveness.run_local_probe(**kw)
        assert port.ok and ref.ok
        (p,), (j,) = port_calls, jax_calls
        assert p["timeout"] == j["timeout"]
        assert p["timeout"] == jax_liveness.LEVEL_TIMEOUTS_S[level] + soak_s
        for var in ("TNC_TOPOLOGY", "TNC_SOAK_S", "TNC_PERF_FLOOR"):
            assert p["env"].get(var) == j["env"].get(var), var
        assert ("TNC_SOAK_S" in p["env"]) == (soak_s > 0)

    def test_timed_out_child_reads_as_jax(self, monkeypatch):
        _clean_env(monkeypatch)
        monkeypatch.setattr(port_liveness, "_run_child", self._fake_child([], True))
        monkeypatch.setattr(jax_liveness.subprocess, "run", self._fake_child([], True))
        kw = dict(level="compute", timeout_s=7.0, soak_s=3.0)
        port = port_liveness.run_local_probe(device="cpu", **kw)
        ref = jax_liveness.run_local_probe(**kw)
        assert not port.ok and not ref.ok
        # The same text up to the hint, which names each platform's suspect.
        assert ref.error == "probe timed out after 10.0s (libtpu hang?)"
        assert port.error == "probe timed out after 10.0s (CUDA init or kernel hang?)"
        assert port.error.split(" (")[0] == ref.error.split(" (")[0]


# A child that starts a grandchild in its session, prints its pid and
# blocks: as the probe child with a rank it spawned.
_CHILD_WITH_GRANDCHILD = (
    "import signal, subprocess, sys\n"
    "g = subprocess.Popen([sys.executable, '-c', 'import signal; signal.pause()'])\n"
    "print(g.pid, flush=True)\n"
    "signal.pause()\n"
)


def _gone(pid: int, within_s: float) -> bool:
    """True once ``pid`` has exited (a zombie holds nothing), waiting up to
    ``within_s`` for it through a pidfd, not a sleep."""
    try:
        fd = os.pidfd_open(pid)
    except ProcessLookupError:
        return True
    try:
        readable, _, _ = select.select([fd], [], [], within_s)
    finally:
        os.close(fd)
    return bool(readable)


class TestSessionKill:
    @pytest.fixture(autouse=True)
    def _wall_clock_guard(self):
        t0 = time.perf_counter()
        yield
        elapsed = time.perf_counter() - t0
        assert elapsed < WALL_CLOCK_BUDGET_S, f"test burned {elapsed:.1f}s of wall-clock"

    def test_timeout_kills_the_grandchild(self):
        with pytest.raises(subprocess.TimeoutExpired) as exc:
            port_liveness._run_child([sys.executable, "-c", _CHILD_WITH_GRANDCHILD],
                                     timeout=8.0, env=os.environ)
        out = exc.value.output
        assert out, "the child printed no grandchild pid before its timeout"
        assert _gone(int(out.split()[0]), within_s=10.0)

    def test_child_in_a_session_of_its_own(self):
        code = "import os; print(os.getsid(0) == os.getpid(), os.getpgid(0) == os.getpid())"
        proc = port_liveness._run_child([sys.executable, "-c", code], timeout=30.0,
                                        env=os.environ)
        assert proc.returncode == 0 and proc.stdout.split() == ["True", "True"]

    def test_kill_timer_message_unchanged(self):
        r = port_liveness.run_local_probe(level="enumerate", device="cpu", timeout_s=0.5)
        assert not r.ok
        assert r.error == "probe timed out after 0.5s (CUDA init or kernel hang?)"

    def test_interrupted_wait_kills_the_session(self, monkeypatch):
        # Any exception out of the wait (KeyboardInterrupt, say) kills the
        # child's group before it propagates.
        killed = []
        real = port_liveness._kill_session
        monkeypatch.setattr(port_liveness, "_kill_session",
                            lambda proc: killed.append(proc.pid) or real(proc))

        def interrupted(self, input=None, timeout=None):
            raise KeyboardInterrupt

        monkeypatch.setattr(subprocess.Popen, "communicate", interrupted)
        with pytest.raises(KeyboardInterrupt):
            port_liveness._run_child([sys.executable, "-c", "import signal; signal.pause()"],
                                     timeout=30.0, env=os.environ)
        assert len(killed) == 1
        assert _gone(killed[0], within_s=10.0)
