"""The port's post-incident readers, ``--trend`` (the ``--log-jsonl`` trend
log) and ``--trend-nodes`` (the ``--history`` store), held against the JAX
checker's.

The files are the port's own: once per module its aggregator loop runs
eight ``--watch`` rounds over a NodeList file and per-host reports (one
node failing for good and cordoned, one flapping into CHRONIC, one
NotReady for a stretch, one round that cannot read its nodes), writing the
trend log and the history store; three one-shot rounds write a second pair.
Each reader then runs through both CLIs' ``main``, text and ``--json``, on
those files, on a copy with a torn last line and a garbage line, on empty
files and on a path that does not exist.  The exit codes and stdout must be
equal.

The port is reached through ``importlib.import_module``:
tests/test_dependency_surface.py rejects any other ``import`` in tests/.
"""

import contextlib
import importlib
import io
import json
import shutil
import time

import pytest

from tests import fixtures as fx
from tests.test_torch_cluster import outcome_vs_jax
from tpu_node_checker import cli as jax_cli

port_checker = importlib.import_module("tpu_node_checker_torch.checker")
port_cli = importlib.import_module("tpu_node_checker_torch.cli")

NODES = ["gke-gpu-pool-0", "gke-gpu-pool-1", "gke-gpu-pool-2", "gke-gpu-pool-3"]
# Per round: each node's probe verdict, the NotReady nodes, or None for a
# round whose NodeList cannot be read.
ROUNDS = [
    ({"gke-gpu-pool-1": False}, set()),
    ({"gke-gpu-pool-1": False, "gke-gpu-pool-2": False}, set()),
    ({"gke-gpu-pool-1": False}, {"gke-gpu-pool-3"}),
    ({"gke-gpu-pool-1": False, "gke-gpu-pool-2": False}, {"gke-gpu-pool-3"}),
    None,
    ({"gke-gpu-pool-1": False}, set()),
    ({"gke-gpu-pool-1": False, "gke-gpu-pool-2": False}, set()),
    ({"gke-gpu-pool-1": False}, set()),
]


def _serve(step, nodes_json, reports, written_at):
    if step is None:
        nodes_json.write_text("{not json")
        return
    failing, not_ready = step
    nodes = fx.gpu_pool(len(NODES))
    for n in nodes:
        if n["metadata"]["name"] in not_ready:
            n["status"]["conditions"] = [{"type": "Ready", "status": "False",
                                          "reason": "KubeletNotReady",
                                          "message": "container runtime is down"}]
    nodes_json.write_text(json.dumps(fx.node_list(nodes)))
    for host in NODES:
        ok = failing.get(host, True)
        (reports / f"{host}.json").write_text(json.dumps({
            "ok": ok, "level": "compute", "hostname": host, "written_at": written_at,
            "error": None if ok else "matmul numerics failed"}))


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """The port's trend logs and history stores, by name."""
    root = tmp_path_factory.mktemp("trend")
    reports = root / "reports"
    reports.mkdir()
    nodes_json = root / "nodes.json"
    flags = ["--nodes-json", str(nodes_json), "--probe-results", str(reports),
             "--cordon-failed", "--cordon-dry-run", "--cordon-after", "2",
             "--flap-threshold", "2", "--flap-window", "4", "--json"]
    waits = []

    def wait(stop, seconds):
        waits.append(seconds)
        if len(waits) < len(ROUNDS):
            _serve(ROUNDS[len(waits)], nodes_json, reports, time.time())
            return False
        return True

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        mp.setitem(port_checker._HISTORY_CACHE, "key", None)
        mp.setitem(port_checker._REMEDIATION_CACHE, "key", None)
        mp.setattr(port_checker, "_wait_for_next_round", wait)
        _serve(ROUNDS[0], nodes_json, reports, time.time())
        loop = port_cli.main(["--watch", "10", "--log-jsonl", str(root / "loop.jsonl"),
                              "--history", str(root / "loop-history.jsonl"), *flags])
        shots = []
        for step in ROUNDS[:3]:
            mp.setitem(port_checker._HISTORY_CACHE, "key", None)
            _serve(step, nodes_json, reports, time.time())
            shots.append(port_cli.main(["--log-jsonl", str(root / "shot.jsonl"), "--history",
                                        str(root / "shot-history.jsonl"), *flags]))
    assert loop == 143 and shots == [0, 0, 0]
    files = {"loop": (root / "loop.jsonl", root / "loop-history.jsonl"),
             "one-shot": (root / "shot.jsonl", root / "shot-history.jsonl")}
    torn = []
    for name in ("loop.jsonl", "loop-history.jsonl"):
        shutil.copy(root / name, root / f"torn-{name}")
        with open(root / f"torn-{name}", "a") as f:
            f.write("not json at all\n{\"ts\": 1, \"exit_code\"")
        torn.append(root / f"torn-{name}")
    files["torn"] = tuple(torn)
    (root / "empty.jsonl").write_text("")
    files["empty"] = (root / "empty.jsonl", root / "empty.jsonl")
    files["missing"] = (root / "absent.jsonl", root / "absent.jsonl")
    return files


def _run(main, argv, capsys):
    rc = main(argv)
    out, _err = capsys.readouterr()
    return rc, out


@pytest.mark.parametrize("json_mode", [False, True])
@pytest.mark.parametrize("reader", ["--trend", "--trend-nodes"])
@pytest.mark.parametrize("source", ["loop", "one-shot", "torn", "empty", "missing"])
def test_reader_equals_jax(written, capsys, source, reader, json_mode):
    log, store = written[source]
    argv = [reader, str(log if reader == "--trend" else store)] + (["--json"] if json_mode
                                                                     else [])
    port = _run(port_cli.main, argv, capsys)
    jax = _run(jax_cli.main, argv, capsys)
    assert port == jax
    if source in ("loop", "one-shot"):
        assert port[0] == 0 and port[1]
    if json_mode:
        json.loads(port[1])


def test_the_readers_see_the_loop(written, capsys):
    # What the port's loop wrote: eight rounds (one failed), the failing
    # node worst, the flappers CHRONIC.
    log, store = written["loop"]
    rc, out = _run(port_cli.main, ["--trend", str(log), "--json"], capsys)
    summary = json.loads(out)
    assert rc == 0 and summary["rounds"] == len(ROUNDS)
    rc, out = _run(port_cli.main, ["--trend-nodes", str(store), "--json"], capsys)
    nodes = json.loads(out)
    assert rc == 0
    assert nodes["worst_offenders"][0] == "gke-gpu-pool-1"
    assert "gke-gpu-pool-2" in nodes["chronic"]
    assert nodes["nodes"]["gke-gpu-pool-1"]["state"] == "FAILED"


@pytest.mark.parametrize("argv,message", [
    (["--trend", "t", "--probe-results", "d"], "--trend runs alone (only --json may accompany it)"),
    (["--trend-nodes", "t", "--history", "h"],
     "--trend-nodes runs alone (only --json may accompany it)"),
    (["--trend", "t", "--trend-nodes", "h"], "--trend runs alone (only --json may accompany it)"),
    (["--trend-nodes", "t", "--watch", "5"],
     "--trend-nodes runs alone (only --json may accompany it)"),
    (["--selftest", "--trend", "t"],
     "--selftest runs alone (only --json and --probe-timeout may accompany it)"),
    (["--calibrate", "2", "--probe-level", "compute", "--trend-nodes", "t"],
     "--calibrate runs alone (only --probe-level/--probe-timeout/--probe-soak/"
     "--probe-topology and --calibrate-margin/--calibrate-out may accompany it)"),
])
def test_reader_usage_errors_equal_jax(capsys, argv, message):
    assert outcome_vs_jax(argv, capsys) == message
