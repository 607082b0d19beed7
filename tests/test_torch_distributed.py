"""The port's distributed probe, held against the JAX package's.

``--probe-distributed``: one probe process per host joins one rendezvous,
and its rank group then holds every host's cards.  Here the hosts are
processes on this machine, each with one gloo rank on the CPU
(``run_local_probe(device="cpu", distributed=True, ...)`` from a thread
each, as ``tests/test_probe_distributed.py`` drives the JAX child), meeting
on ``127.0.0.1`` at an ephemeral port.  The JAX children run with one CPU
device each, so both sides probe 2 processes × 1 device from identical
inputs: the verdicts must be equal and the cross-process psum exact.

Beyond parity: each process of a group with equal card counts is one
slice, so the DCN fault domain lies on the process boundary (graded
healthy, a fault on it named by every process, unequal counts forming no
slices, ``TNC_CHAOS_SLICES`` overriding the processes' slices), a ``2x2``
label over four one-card processes, a ring link faulted at a receiver in another process, the
workload level over the processes with equal losses, the failure modes of
the rendezvous (nothing listening, a peer that never comes, a peer that
skips a global block, a second round on the same port), the parent's
plumbing and the CLI's usage rules against JAX's, the fleet checker
grading the reports, and a rank group of 2 processes × 2 ranks giving the
verdicts of one host's 4 ranks.

torch and the port are reached through ``importlib.import_module``:
tests/test_dependency_surface.py rejects any other ``import`` in tests/.
"""

import importlib
import json
import os
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

from tests import fixtures as fx
from tpu_node_checker import cli as jax_cli
from tpu_node_checker.probe import liveness as jax_liveness
from tpu_node_checker.probe import schema as jax_schema

torch = importlib.import_module("torch")
port_calibrate = importlib.import_module("tpu_node_checker_torch.calibrate")
port_cli = importlib.import_module("tpu_node_checker_torch.cli")
port_liveness = importlib.import_module("tpu_node_checker_torch.probe.liveness")
port_mesh = importlib.import_module("tpu_node_checker_torch.parallel.mesh")
port_schema = importlib.import_module("tpu_node_checker_torch.probe.schema")

REPO = Path(__file__).resolve().parent.parent
# Healthy processes meet within seconds; the bound is wide because the suite
# runs files in parallel and every process pays its interpreter's start.
RDV_TIMEOUT_S = 60.0
# The keys a distributed report shares with the JAX child's at the
# enumerate and collective levels.
PARITY_KEYS = ("distributed", "device_count", "local_device_count", "process_index",
               "process_count", "distributed_psum", "distributed_psum_ok", "ok")
COLLECTIVE_PARITY_KEYS = PARITY_KEYS + ("collective_ok", "ring_ok")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def probe_env():
    """No TNC_* from outside, one thread a child (the suite runs files in
    parallel, and timing-graded tests elsewhere read contention as a slow
    link), one CPU device a JAX child."""
    with pytest.MonkeyPatch.context() as mp:
        for k in [k for k in os.environ if k.startswith("TNC_")]:
            mp.delenv(k)
        mp.setenv("OMP_NUM_THREADS", "1")
        mp.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=1 "
                  "--xla_cpu_multi_thread_eigen=false")
        yield mp


def _run_set(probe, n, level, port=None, **kw):
    """``probe(level=..., process_id=i, ...)`` for processes 0..n-1 at
    once, all meeting at one coordinator: the results in process order."""
    coord = f"127.0.0.1:{port or _free_port()}"

    def one(pid):
        return probe(level=level, distributed=True, coordinator=coord, num_processes=n,
                     process_id=pid, dist_init_timeout_s=RDV_TIMEOUT_S, **kw)

    with ThreadPoolExecutor(max_workers=n) as pool:
        return list(pool.map(one, range(n)))


def _port_probe(**kw):
    return port_liveness.run_local_probe(device="cpu", **kw)


def _emit(coord, n, pid, level, extra_env=None):
    """The port's CLI as one host's emitter runs it: (exit code, report)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("TNC_")}
    env.update(NODE_NAME=f"gke-gpu-pool-{pid}", TNC_SCHEMA_STRICT="1", **(extra_env or {}))
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_node_checker_torch", "--emit-probe", "-",
         "--probe-level", level, "--device", "cpu", "--probe-distributed",
         "--probe-coordinator", coord, "--probe-num-processes", str(n),
         "--probe-process-id", str(pid), "--probe-rendezvous-timeout", str(RDV_TIMEOUT_S)],
        capture_output=True, text=True, cwd=REPO, timeout=600, env=env,
    )
    assert proc.stdout, proc.stderr[-2000:]
    return proc.returncode, json.loads(proc.stdout)


@pytest.fixture(scope="module")
def pair(probe_env):
    """Two port emitters (the CLI, as two hosts run it) at the collective
    level, then a second round at the enumerate level on the same port;
    beside them the JAX child's two processes at both levels."""
    coord = f"127.0.0.1:{_free_port()}"
    out = {}
    for level in ("collective", "enumerate"):
        with ThreadPoolExecutor(max_workers=3) as pool:
            ref = pool.submit(_run_set, jax_liveness.run_local_probe, 2, level, timeout_s=600)
            port = [pool.submit(_emit, coord, 2, pid, level) for pid in range(2)]
            out[f"port_{level}"] = [f.result() for f in port]
            out[f"jax_{level}"] = ref.result()
    return out


class TestParityWithJax:
    @pytest.mark.parametrize("level,keys", [("enumerate", PARITY_KEYS),
                                            ("collective", COLLECTIVE_PARITY_KEYS)])
    def test_verdicts_equal_and_psum_exact(self, pair, level, keys):
        for pid, ((rc, port), ref) in enumerate(zip(pair[f"port_{level}"],
                                                    pair[f"jax_{level}"])):
            assert ref.ok, ref.error
            assert rc == 0 and port["ok"] is True, port.get("error")
            ref = ref.to_dict()
            assert {k: port.get(k) for k in keys} == {k: ref.get(k) for k in keys}
            assert port["distributed_psum"] == ref["distributed_psum"] == 3.0
            assert port["device_count"] == 2 and port["local_device_count"] == 1
            assert port["process_index"] == pid and port["process_count"] == 2
            assert port["rendezvous_ms"] >= 0 and port["hostname"] == f"gke-gpu-pool-{pid}"

    def test_second_round_on_the_same_port_is_healthy(self, pair):
        # Each --watch round is a fresh child: process 0 binds the
        # coordinator's port again right after the last round closed it.
        assert [rc for rc, _ in pair["port_enumerate"]] == [0, 0]
        assert all(doc["distributed_psum_ok"] for _, doc in pair["port_enumerate"])

    def test_reports_valid_and_graded_by_the_fleet_checker(self, pair, tmp_path):
        reports = tmp_path / "reports"
        reports.mkdir()
        for _, doc in pair["port_collective"]:
            assert port_schema.validate_report(doc) == []
            assert jax_schema.validate_report(doc) == []
            (reports / f"{doc['hostname']}.json").write_text(json.dumps(doc))
        nodes = tmp_path / "nodes.json"
        nodes.write_text(json.dumps(fx.node_list(fx.gpu_pool(2))))
        env = {k: v for k, v in os.environ.items() if not k.startswith("TNC_")}
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_node_checker", "--nodes-json", str(nodes),
             "--probe-results", str(reports), "--json"],
            capture_output=True, text=True, cwd=REPO, timeout=120, env=env,
        )
        assert proc.returncode == 0, proc.stderr
        summary = json.loads(proc.stdout)["probe_summary"]
        assert summary == {"hosts_reported": 2, "hosts_ok": 2, "hosts_failed": [],
                           "hosts_missing": []}


@pytest.fixture(scope="module")
def quad_topology(probe_env):
    """Four processes at the collective level under a 2x2 label: rank r is
    process r.  Each process is one slice (equal card counts), so the slice
    boundary is the DCN axis, every line of which mixes processes."""
    return _run_set(_port_probe, 4, "collective", topology="2x2", timeout_s=600)


class TestAcrossFourProcesses:
    def test_topology_axes_mixing_processes(self, quad_topology):
        for pid, r in enumerate(quad_topology):
            assert r.ok, (pid, r.error)
            d = r.details
            assert r.device_count == 4 and d["process_index"] == pid
            assert d["distributed_psum"] == 1.0 + 2.0 + 3.0 + 4.0
            # The label describes one slice, and a slice here is one card:
            # as in the JAX child of a multislice job, the block runs over
            # dcn x the slice's flat axis, and no per-axis block over the label.
            assert d["num_slices"] == 4 and d["slice_indices"] == [0, 1, 2, 3]
            assert d["fault_domain_topology"] == "4x1"
            assert d["fault_domain_ok"] == {"dcn": True, "d": True}
            assert "ici_topology" not in d and "ici_axis_ok" not in d
            assert d["collective_ok"] is True and d["ring_ok"] is True

    def test_dcn_on_the_process_boundary(self, probe_env):
        # Two rehearsal slices of a 1x2 torus: the dcn axis splits ranks
        # {0, 1} from {2, 3}, processes from processes.  TNC_CHAOS_SLICES
        # overrides the four slices the group stamps, as in the JAX child.
        probe_env.setenv("TNC_CHAOS_SLICES", "2")
        reports = _run_set(_port_probe, 4, "collective", topology="1x2", timeout_s=600)
        probe_env.delenv("TNC_CHAOS_SLICES")
        for pid, r in enumerate(reports):
            assert r.ok, (pid, r.error)
            assert r.details["num_slices"] == 4
            assert r.details["fault_domain_ok"] == {"dcn": True, "t0": True, "t1": True}
            assert r.details["fault_domain_topology"] == "2x1x2"
            assert r.details["dcn_busbw_gbps"] > 0
        verdicts = [{k: r.details[k] for k in ("fault_domain_ok", "collective_ok", "ring_ok")}
                    for r in reports]
        assert all(v == verdicts[0] for v in verdicts)

    def test_dcn_fault_and_remote_link_named_by_every_process(self, probe_env):
        # The slice boundary faulted, and ring link 1->2, whose receiver is
        # process 2's rank: every process names both, the same way.
        probe_env.setenv("TNC_CHAOS_SLICES", "2")
        probe_env.setenv("TNC_CHAOS_AXIS", "dcn")
        probe_env.setenv("TNC_CHAOS_RING_LINK", "1")
        reports = _run_set(_port_probe, 4, "collective", topology="1x2", timeout_s=600)
        for var in ("TNC_CHAOS_SLICES", "TNC_CHAOS_AXIS", "TNC_CHAOS_RING_LINK"):
            probe_env.delenv(var)
        for pid, r in enumerate(reports):
            assert not r.ok, pid
            assert "DCN slice boundary" in r.error, r.error
            assert r.details["fault_domain_ok"] == {"dcn": False, "t0": True, "t1": True}
            assert r.details["ring_bad_links"] == ["1->2"]
            assert r.details["distributed_psum_ok"] is True


@pytest.fixture(scope="module")
def two_slices(probe_env):
    """Two processes of one card each at the collective level, healthy and
    with the slice boundary faulted (``TNC_CHAOS_AXIS=dcn``)."""
    out = {"healthy": _run_set(_port_probe, 2, "collective", timeout_s=600)}
    probe_env.setenv("TNC_CHAOS_AXIS", "dcn")
    try:
        out["dcn_fault"] = _run_set(_port_probe, 2, "collective", timeout_s=600)
    finally:
        probe_env.delenv("TNC_CHAOS_AXIS")
    return out


class TestEachProcessIsASlice:
    """A group of processes with equal card counts: each process is one
    slice, and the host boundary is the fault-domain block's DCN axis (the
    JAX child stamps ``num_slices`` from PJRT's slice index instead)."""

    def test_two_processes_stamp_two_slices_and_grade_the_dcn_domain(self, two_slices):
        for pid, r in enumerate(two_slices["healthy"]):
            assert r.ok, (pid, r.error)
            d = r.details
            assert d["num_slices"] == 2 and d["slice_indices"] == [0, 1]
            assert d["fault_domain_topology"] == "2x1"
            assert d["fault_domain_ok"] == {"dcn": True, "d": True}
            assert d["dcn_busbw_gbps"] > 0
            assert d["fault_domain_busbw_gbps"]["dcn"] == d["dcn_busbw_gbps"]
            assert port_schema.validate_report(r.to_dict()) == []

    def test_a_dcn_fault_fails_that_leg_alone(self, two_slices):
        for pid, r in enumerate(two_slices["dcn_fault"]):
            assert not r.ok, pid
            assert "DCN slice boundary" in r.error, r.error
            d = r.details
            assert d["fault_domain_ok"] == {"dcn": False, "d": True}
            assert d["collective_ok"] is True and d["ring_ok"] is True
            assert d["distributed_psum_ok"] is True

    @pytest.mark.parametrize("counts,slices", [
        ((1, 1), [0, 1]), ((2, 2, 2), [0, 1, 2]), ((2, 1), None), ((1, 2, 1), None), ((3,), None),
    ])
    def test_unequal_card_counts_stamp_no_slices(self, counts, slices):
        # The real meeting, one thread a process, each with its card count.
        coord = f"127.0.0.1:{_free_port()}"

        def meet(pid):
            m = port_mesh.Meeting(port_mesh.Rendezvous(coord, len(counts), pid, RDV_TIMEOUT_S),
                                  counts[pid])
            try:
                return list(m.counts), m.slice_indices
            finally:
                m.close()

        with ThreadPoolExecutor(max_workers=len(counts)) as pool:
            got = list(pool.map(meet, range(len(counts))))
        assert got == [(list(counts), slices)] * len(counts)


class TestWorkloadAcrossProcesses:
    def test_every_block_healthy_with_equal_losses(self, probe_env):
        r0, r1 = _run_set(_port_probe, 2, "workload", timeout_s=900)
        for r in (r0, r1):
            assert r.ok, r.error
            for key in ("workload_ok", "ring_attention_ok", "pipeline_ok", "moe_ok"):
                assert r.details[key] is True, key
            assert r.details["workload_devices"] == 2
        assert r0.details["workload_losses"] == r1.details["workload_losses"]

    @pytest.mark.parametrize("skipper", [1, 0])
    def test_a_peer_that_skips_a_block_is_a_named_failure_inside_the_kill_timer(
            self, skipped_block, skipper):
        # One process's floors fail (a throttled card), so, as in the JAX
        # child, it skips the workload block and closes; the other waits in
        # that block's first collective, bounded by the group, never until
        # its kill-timer (the JAX child waits for that).  Process 0, which
        # hosts the store, skipping is the case where its farewell waits
        # for a peer still inside a collective.
        reports, seconds = skipped_block[skipper]
        (rc_s, d_s), (rc_w, d_w) = reports[skipper], reports[1 - skipper]
        assert rc_s == 3 and "perf_floor" in d_s["error"] and "workload_ok" not in d_s
        assert rc_w == 3 and d_w["ok"] is False and d_w["workload_ok"] is False
        assert d_w["error"].startswith("workload: "), d_w["error"]
        kill_timer = (port_liveness.LEVEL_TIMEOUTS_S["workload"]
                      + port_liveness.DISTRIBUTED_EXTRA_TIMEOUT_S + RDV_TIMEOUT_S)
        assert seconds < kill_timer / 2


@pytest.fixture(scope="module")
def skipped_block():
    """Both directions of a peer skipping the workload block, at once: for
    each skipping process id, the two emitters' (exit code, report) in
    process order and the seconds until both had exited."""
    throttled = {"TNC_CHAOS_THROTTLE": "matmul_tflops",
                 "TNC_PERF_EXPECT": json.dumps({"matmul_tflops": 1e9}),
                 "OMP_NUM_THREADS": "1"}

    def pair(skipper):
        coord = f"127.0.0.1:{_free_port()}"
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=2) as pool:
            reports = list(pool.map(
                lambda pid: _emit(coord, 2, pid, "workload",
                                  throttled if pid == skipper else {"OMP_NUM_THREADS": "1"}),
                range(2)))
        return reports, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=2) as pool:
        return dict(zip((0, 1), pool.map(pair, (0, 1))))


class TestRendezvousFailures:
    def test_no_coordinator_and_no_peer_fail_named_and_fast(self, probe_env):
        # Process 1 with nothing listening at the coordinator, and process 0
        # of 2 alone: each a report naming the coordinator and the bound,
        # far inside the kill-timer, never a probe of one host.
        dead, lonely = f"127.0.0.1:{_free_port()}", f"127.0.0.1:{_free_port()}"
        runs = [(dead, 1), (lonely, 0)]
        with ThreadPoolExecutor(max_workers=2) as pool:
            results = list(pool.map(lambda a: _port_probe(
                level="enumerate", distributed=True, coordinator=a[0], num_processes=2,
                process_id=a[1], dist_init_timeout_s=3), runs))
        kill_timer_ms = (port_liveness.LEVEL_TIMEOUTS_S["enumerate"]
                         + port_liveness.DISTRIBUTED_EXTRA_TIMEOUT_S + 3) * 1e3
        for (coord, pid), r in zip(runs, results):
            assert not r.ok
            assert f"rendezvous at coordinator {coord} failed" in r.error, r.error
            assert f"(rendezvous timeout 3 s, process {pid} of 2" in r.error, r.error
            assert "distributed" not in r.details and r.device_count == 0
            assert r.elapsed_ms < kill_timer_ms / 3
        assert "no coordinator answered" in results[0].error
        assert "not every process joined" in results[1].error
        assert "missing: [1]" in results[1].error

    @pytest.mark.parametrize("rdv_timeout_s,deadline_s", [(2.0, None), (60.0, 2.0)])
    def test_farewell_waits_no_longer_than_its_bounds(self, capfd, rdv_timeout_s, deadline_s):
        # Process 1 meets and never says farewell (it died, or hangs in a
        # collective): process 0, which hosts the store, stops waiting at
        # the rendezvous timeout, or sooner at the caller's deadline (the
        # probe child's kill-timer), and says why.
        coord = f"127.0.0.1:{_free_port()}"
        with ThreadPoolExecutor(max_workers=2) as pool:
            host, peer = pool.map(lambda pid: port_mesh.Meeting(
                port_mesh.Rendezvous(coord, 2, pid, rdv_timeout_s), 1 + pid), range(2))
        assert host.counts == peer.counts == (1, 2)
        assert (host.rank_offset, peer.rank_offset, host.world_size) == (0, 1, 3)
        t0 = time.monotonic()
        host.close(None if deadline_s is None else t0 + deadline_s)
        waited = time.monotonic() - t0
        assert 1.5 < waited < 10.0, waited
        assert "rendezvous farewell" in capfd.readouterr().err
        peer.close()  # the host's store may be gone: printed, never raised
        host.close()  # a second close is a no-op

    def test_rendezvous_variables_are_required_and_rounded_as_jax(self):
        env = {"TNC_COORDINATOR": "10.0.0.1:8476", "TNC_NUM_PROCESSES": "16",
               "TNC_PROCESS_ID": "3"}
        rdv = port_liveness.rendezvous_from_env(env)
        assert (rdv.coordinator, rdv.num_processes, rdv.process_id) == ("10.0.0.1:8476", 16, 3)
        assert rdv.timeout_s == port_liveness.DEFAULT_RENDEZVOUS_TIMEOUT_S
        assert rdv.address == ("10.0.0.1", 8476)
        for given, want in (("0.2", 1.0), ("0", 1.0), ("2.5", 3.0), ("45", 45.0)):
            got = port_liveness.rendezvous_from_env({**env, "TNC_DIST_INIT_TIMEOUT_S": given})
            assert got.timeout_s == want, given
        # The JAX child's rounding, which the port's copies.
        assert '1, math.ceil(float(os.environ["TNC_DIST_INIT_TIMEOUT_S"]))' \
            in jax_liveness._CHILD_SCRIPT
        with pytest.raises(ValueError, match="needs TNC_COORDINATOR, TNC_PROCESS_ID"):
            port_liveness.rendezvous_from_env({"TNC_NUM_PROCESSES": "2"})
        for bad, words in ((dict(coordinator="nohost"), "not host:port"),
                           (dict(coordinator="h:99999"), "not host:port"),
                           (dict(num_processes=0), "num_processes must be >= 1"),
                           (dict(process_id=2), "process_id 2 out of range for 2"),
                           (dict(timeout_s=0.0), "must be > 0 s")):
            kw = dict(coordinator="h:1", num_processes=2, process_id=0, timeout_s=1.0)
            with pytest.raises(ValueError, match=words):
                port_mesh.Rendezvous(**{**kw, **bad})


def _clean_env(monkeypatch):
    for k in [k for k in os.environ if k.startswith("TNC_")]:
        monkeypatch.delenv(k)


def _fake_child(calls):
    def fake(argv, **kw):
        calls.append(kw)
        report = {"ok": True, "level": argv[3], "device_count": 1}
        return subprocess.CompletedProcess(argv, 0, json.dumps(report) + "\n", "")
    return fake


RDV_VARS = ("TNC_PROBE_DISTRIBUTED", "TNC_COORDINATOR", "TNC_NUM_PROCESSES", "TNC_PROCESS_ID",
            "TNC_DIST_INIT_TIMEOUT_S")


class TestPlumbing:
    """The parent's side and the CLI against JAX's, with the child faked on
    both sides (the JAX parent's ``subprocess.run``, the port's
    ``_run_child``)."""

    @pytest.mark.parametrize("level,init_timeout", [("enumerate", 45.0), ("collective", None),
                                                     ("workload", 0.5)])
    def test_child_env_and_kill_timer_equal_jax(self, monkeypatch, level, init_timeout):
        _clean_env(monkeypatch)
        port_calls, jax_calls = [], []
        monkeypatch.setattr(port_liveness, "_run_child", _fake_child(port_calls))
        monkeypatch.setattr(jax_liveness.subprocess, "run", _fake_child(jax_calls))
        kw = dict(level=level, distributed=True, coordinator="10.0.0.1:8476",
                  num_processes=16, process_id=3, dist_init_timeout_s=init_timeout)
        assert port_liveness.run_local_probe(device="cpu", **kw).ok
        assert jax_liveness.run_local_probe(**kw).ok
        (p,), (j,) = port_calls, jax_calls
        assert port_liveness.DISTRIBUTED_EXTRA_TIMEOUT_S == jax_liveness.DISTRIBUTED_EXTRA_TIMEOUT_S
        assert p["timeout"] == j["timeout"] == (
            port_liveness.LEVEL_TIMEOUTS_S[level] + 90.0 + (init_timeout or 0.0))
        assert {v: p["env"].get(v) for v in RDV_VARS} == {v: j["env"].get(v) for v in RDV_VARS}
        assert p["env"]["TNC_COORDINATOR"] == "10.0.0.1:8476"
        assert p["env"]["TNC_PROCESS_ID"] == "3" and p["env"]["TNC_NUM_PROCESSES"] == "16"
        assert ("TNC_DIST_INIT_TIMEOUT_S" in p["env"]) == (init_timeout is not None)

    def test_no_rendezvous_env_without_distributed(self, monkeypatch):
        _clean_env(monkeypatch)
        calls = []
        monkeypatch.setattr(port_liveness, "_run_child", _fake_child(calls))
        port_liveness.run_local_probe(level="collective", device="cpu", coordinator="h:1",
                                      num_processes=2, process_id=1, dist_init_timeout_s=5)
        (p,) = calls
        assert not any(v in p["env"] for v in RDV_VARS)
        assert p["timeout"] == port_liveness.LEVEL_TIMEOUTS_S["collective"]

    @pytest.mark.parametrize("argv", [
        ["--probe-distributed"],
        ["--emit-probe", "-", "--probe-coordinator", "h:1"],
        ["--emit-probe", "-", "--probe-num-processes", "2"],
        ["--emit-probe", "-", "--probe-process-id", "0"],
        ["--emit-probe", "-", "--probe-rendezvous-timeout", "5"],
    ])
    def test_usage_errors_are_jax_words(self, capsys, argv):
        errs = []
        for parse in (port_cli.parse_args, jax_cli.parse_args):
            with pytest.raises(SystemExit) as exc:
                parse(argv)
            assert exc.value.code == 2
            errs.append(capsys.readouterr().err.strip().splitlines()[-1])
        assert errs[0].split("error: ", 1)[1] == errs[1].split("error: ", 1)[1]
        assert "--probe-distributed" in errs[0]

    @pytest.mark.parametrize("dest", ["probe_distributed", "probe_coordinator",
                                      "probe_num_processes", "probe_process_id",
                                      "probe_rendezvous_timeout"])
    def test_flag_defaults_equal_jax(self, dest):
        assert port_cli.build_parser().get_default(dest) == \
            jax_cli.build_parser().get_default(dest)

    def test_flags_reach_the_probe(self, monkeypatch, tmp_path):
        calls = []

        def fake_probe(**kw):
            calls.append(kw)
            return port_liveness.ProbeResult(ok=True, level="enumerate", hostname="h",
                                             elapsed_ms=1.0, device_count=2)

        port_emit = importlib.import_module("tpu_node_checker_torch.emit")
        monkeypatch.setattr(port_emit, "run_local_probe", fake_probe)
        rc = port_cli.main(["--emit-probe", str(tmp_path / "r.json"), "--probe-distributed",
                            "--probe-coordinator", "10.0.0.1:8476", "--probe-num-processes",
                            "2", "--probe-process-id", "1", "--probe-rendezvous-timeout", "30"])
        assert rc == 0
        (kw,) = calls
        assert {k: kw[k] for k in ("distributed", "coordinator", "num_processes", "process_id",
                                   "dist_init_timeout_s")} == dict(
            distributed=True, coordinator="10.0.0.1:8476", num_processes=2, process_id=1,
            dist_init_timeout_s=30.0)

    def test_calibrate_passes_no_rendezvous(self, monkeypatch, capsys):
        # As JAX's calibrate: its reps probe this host alone.
        calls = []

        def fake_probe(**kw):
            calls.append(kw)
            return port_liveness.ProbeResult(
                ok=True, level="compute", hostname="h", elapsed_ms=1.0, device_count=1,
                details={"matmul_tflops": 1.0, "int8_tops": 1.0, "hbm_gbps": 1.0})

        monkeypatch.setattr(port_calibrate, "run_local_probe", fake_probe)
        assert port_calibrate.calibrate(1, level="compute", device="cpu") == 0
        (kw,) = calls
        assert not {"distributed", "coordinator", "num_processes", "process_id",
                    "dist_init_timeout_s"} & set(kw)


_GROUP_SCRIPT = r"""
import json, sys
from tpu_node_checker_torch.parallel import (
    Meeting, RankGroup, Rendezvous, collective_probe, fold, ring_probe,
)

if __name__ == "__main__":
    coord, pid = sys.argv[1], int(sys.argv[2])
    meeting = None if pid < 0 else Meeting(Rendezvous(coord, 2, pid, 60.0), 2)
    out = {}
    with RankGroup(4 if meeting is None else 2, "cpu", timeout_s=60, meeting=meeting) as g:
        out["layout"] = [g.world_size, g.rank_offset,
                         [4] if meeting is None else list(meeting.counts)]
        for name, fn, kw in (
            ("collective", collective_probe, {"payload": 64, "timed_iters": 1}),
            ("collective_leg", collective_probe,
             {"payload": 64, "timed_iters": 1, "inject_fault_leg": "all_gather"}),
            ("ring", ring_probe, {"payload": 64}),
            ("ring_link", ring_probe, {"payload": 64, "inject_fault_link": 1}),
        ):
            r = fold(g.run(fn, **kw))
            d = r.details or {}
            out[name] = {"ok": r.ok, "bad_links": d.get("bad_links"),
                         "legs": {k: d.get(k) for k in
                                  ("psum_ok", "all_gather_ok", "reduce_scatter_ok")}}
    if meeting is not None:
        meeting.close()
    print("TNCRESULT" + json.dumps(out))
"""


def test_two_hosts_of_two_ranks_read_as_one_host_of_four(probe_env):
    """The rank group without the child: 2 processes × 2 gloo ranks give the
    collective and ring verdicts (and the fault names) of 4 ranks on one
    host; rank 2 binds its process's first local rank."""
    coord = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "PYTHONPATH": f"{REPO}{os.pathsep}{os.environ.get('PYTHONPATH', '')}"}

    def run(pid):
        proc = subprocess.run([sys.executable, "-c", _GROUP_SCRIPT, coord, str(pid)],
                              capture_output=True, text=True, timeout=300, env=env)
        lines = [x for x in proc.stdout.splitlines() if x.startswith("TNCRESULT")]
        assert lines, proc.stderr[-2000:]
        return json.loads(lines[-1][len("TNCRESULT"):])

    with ThreadPoolExecutor(max_workers=3) as pool:
        one_host, host0, host1 = pool.map(run, [-1, 0, 1])
    assert one_host["layout"] == [4, 0, [4]]
    assert host0["layout"] == [4, 0, [2, 2]] and host1["layout"] == [4, 2, [2, 2]]
    for name in ("collective", "collective_leg", "ring", "ring_link"):
        assert host0[name] == host1[name] == one_host[name], name
    assert one_host["ring"]["ok"] and one_host["collective"]["ok"]
    assert one_host["ring_link"]["bad_links"] == ["1->2"]
    assert one_host["collective_leg"]["legs"] == {
        "psum_ok": True, "all_gather_ok": False, "reduce_scatter_ok": True}
