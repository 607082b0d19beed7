"""The port's analytics tier (``--analytics DIR``), held against the JAX
package's.

The same inputs, made from a seed with numpy, go through both packages'
pieces and must give the same results:

* the segment store: a verdict stream over a few nodes and many rounds
  (every resolution's buckets close, shards compact as they grow), fed to both
  ``SegmentStore``\\ s; the closed buckets, the running per-node folds, the
  segment files byte for byte, the counters, and the store reloaded from
  its files;
* the detectors: flip streams through both ``CusumFlapDetector``\\ s and
  link timings through both ``LinkDriftDetector``\\ s, round by round;
* the sketches: samples added, merged, serialized and read back;
* the query documents (``build_analytics_docs``) over those stores;
* the round: ``run_check`` of both CLIs over the same NodeList and probe
  reports with ``--history --analytics``, where one host flaps and three
  hosts' reports carry ``collective_legs_ok.links`` whose p50 drifts
  toward its budget, so both the flip channel and the link channel fire
  on the CPU.  The payload's ``analytics`` block, the query documents,
  the event lines and the segment files must be equal, with the clock
  pinned on both sides; only the round's own duration (the ``round_ms``
  sketch, ``timings_ms``) and ``trace_id`` are masked.

The port is reached through ``importlib.import_module``:
tests/test_dependency_surface.py rejects any other ``import`` in tests/.
"""

import importlib
import json
import time

import numpy as np
import pytest

from tests import fixtures as fx
from tests.test_torch_cluster import _isolated  # noqa: F401 — the autouse fixture
from tpu_node_checker import checker as jax_checker
from tpu_node_checker import cli as jax_cli
from tpu_node_checker.analytics import changepoint as jax_changepoint
from tpu_node_checker.analytics import queries as jax_queries
from tpu_node_checker.analytics import segments as jax_segments
from tpu_node_checker.analytics import sketch as jax_sketch

port_checker = importlib.import_module("tpu_node_checker_torch.checker")
port_cli = importlib.import_module("tpu_node_checker_torch.cli")
port_changepoint = importlib.import_module("tpu_node_checker_torch.analytics.changepoint")
port_queries = importlib.import_module("tpu_node_checker_torch.analytics.queries")
port_segments = importlib.import_module("tpu_node_checker_torch.analytics.segments")
port_sketch = importlib.import_module("tpu_node_checker_torch.analytics.sketch")

SIDES = {
    "jax": (jax_cli, jax_checker, jax_segments, jax_changepoint, jax_queries, jax_sketch),
    "port": (port_cli, port_checker, port_segments, port_changepoint, port_queries,
             port_sketch),
}
# A minute boundary: the pinned clocks start just after it.
BASE = 1_700_000_040.0
STATES = ("HEALTHY", "SUSPECT", "FAILED", "RECOVERING", "CHRONIC")
# What a round's own wall time reaches: its trace id, its timings, and the
# round_ms sketch (a sketch is a dict; its sample count stays compared).
WALL_TIMES = ("trace_id", "timings_ms")
WALL_SKETCHES = ("round_ms",)


def masked(obj):
    """``obj`` with every wall-time value replaced, at any depth."""
    if isinstance(obj, dict):
        return {k: "<masked>" if k in WALL_TIMES or (k in WALL_SKETCHES and isinstance(v, dict))
                else masked(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [masked(v) for v in obj]
    return obj


def verdict_stream(seed, nodes=6, rounds=300, step=90.0):
    """Per round, per node: (ts, ok, state, group) from a seeded generator.
    Each node fails with its own rate; the state follows a short streak."""
    rng = np.random.default_rng(seed)
    fail_rate = rng.uniform(0.05, 0.5, size=nodes)
    names = [f"node-{i}" for i in range(nodes)]
    streak = dict.fromkeys(names, 0)
    out = []
    for r in range(rounds):
        ts = BASE + r * step + float(rng.uniform(0.0, 1.0))
        row = []
        for i, name in enumerate(names):
            ok = bool(rng.random() >= fail_rate[i])
            streak[name] = 0 if ok else streak[name] + 1
            state = STATES[min(streak[name], 2)] if ok or streak[name] < 4 else "CHRONIC"
            group = {"cluster": "us-a", "slice": f"pool-{i % 2}/v5e/4x4", "topology": "4x4"}
            row.append((name, round(ts, 3), ok, state, group))
        out.append((round(ts, 3), row, [float(x) for x in rng.lognormal(3.0, 0.5, size=3)]))
    return out


def feed_store(side, directory, stream, detector=None):
    """One side's SegmentStore fed ``stream`` (and its detector the flips);
    returns the store."""
    segments = SIDES[side][2]
    store = segments.SegmentStore(str(directory))
    store.load()
    for r, (ts, row, round_ms) in enumerate(stream, start=1):
        for name, vts, ok, state, group in row:
            flipped = detector.flip(name, ok) if detector is not None else False
            if detector is not None:
                detector.observe(name, flipped, r)
            store.observe(name, vts, ok, state, flipped, group=group)
        store.observe_samples(segments.FLEET_STREAM, ts, {"round_ms": round_ms})
        store.flush(ts)
    return store


def store_view(store):
    return {
        "buckets": {repr(k): v for k, v in sorted(store.buckets.items())},
        "node_stats": {n: {k: ({m: sk.to_doc() for m, sk in v.items()} if k == "sketches"
                               else v) for k, v in s.items()}
                       for n, s in sorted(store.node_stats.items())},
        "node_groups": store.node_groups,
        "bucket_counts": store.bucket_counts(),
        "counters": (store.rollup_lines_total, store.compactions_total,
                     store.skipped_lines, store.refused_lines),
        "sketch_samples_total": store.sketch_samples_total,
    }


def segment_files(directory):
    return {p.name: p.read_bytes() for p in sorted(directory.glob("*.seg.jsonl"))}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_store_equals_jax(tmp_path, seed):
    stream = verdict_stream(seed)
    stores, views = {}, {}
    for side in SIDES:
        detector = SIDES[side][3].CusumFlapDetector()
        stores[side] = feed_store(side, tmp_path / side, stream, detector)
        stores[side].detector = detector
        views[side] = store_view(stores[side])
    assert views["port"] == views["jax"]
    # Every resolution closed buckets over 300 rounds of 90 s (7.5 h).
    assert all(n > 0 for n in views["port"]["bucket_counts"].values())
    assert segment_files(tmp_path / "port") == segment_files(tmp_path / "jax")
    # Compaction of every shard, then a restart from the files.
    before = stores["port"].compactions_total
    assert before == stores["jax"].compactions_total and before > 0
    for side, store in stores.items():
        for shard in range(store.shards):
            store.compact_shard(shard)
    assert stores["port"].compactions_total == stores["jax"].compactions_total == before + 8
    assert segment_files(tmp_path / "port") == segment_files(tmp_path / "jax")
    reloaded = {}
    for side in SIDES:
        store = SIDES[side][2].SegmentStore(str(tmp_path / side))
        store.load()
        reloaded[side] = store_view(store)
    assert reloaded["port"] == reloaded["jax"]
    docs = {side: SIDES[side][4].build_analytics_docs(
        stores[side], detector=stores[side].detector, predictions=[{"node": "node-0"}])
        for side in SIDES}
    assert docs["port"] == docs["jax"]
    assert set(docs["port"]) == {"slo", "offenders", "flaps"}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_detectors_equal_jax(seed):
    rng = np.random.default_rng(seed)
    flips = rng.random((200, 5)) < rng.uniform(0.1, 0.7, size=5)
    p50 = rng.uniform(10.0, 95.0, size=(200, 4))
    budget = rng.choice([0.0, 100.0, 120.0], size=(200, 4))
    got = {}
    for side in SIDES:
        cp = SIDES[side][3]
        flap, link = cp.CusumFlapDetector(), cp.LinkDriftDetector()
        trace = []
        for r in range(200):
            for i in range(5):
                trace.append(flap.observe(f"n{i}", bool(flips[r, i]), r))
                trace.append(flap.flip(f"n{i}", bool(flips[r, i])))
            for j in range(4):
                trace.append(link.observe(f"s/t{j}/0->1", float(p50[r, j]),
                                          float(budget[r, j]), r))
            if r % 50 == 49:
                flap.prune({"n0", "n1", "n2"})
                link.prune({"s/t0/0->1", "s/t1/0->1"})
            trace.append((dict(flap.active), dict(link.active), flap.snapshot(),
                           link.snapshot(), flap.active_count(), link.active_count()))
        got[side] = (trace, flap.detections_total, link.detections_total)
    assert got["port"] == got["jax"]
    assert got["port"][1] > 0 and got["port"][2] > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_sketch_equals_jax(seed):
    rng = np.random.default_rng(seed)
    a = [float(x) for x in rng.lognormal(2.0, 1.0, size=500)]
    b = [float(x) for x in rng.exponential(30.0, size=300)] + [0.0, 1e-12, 5e12]
    got = {}
    for side in SIDES:
        sk = SIDES[side][5]
        x, y = sk.Sketch(), sk.Sketch(alpha=0.02)
        x.extend(a)
        for v in b:
            y.add(v)
        z = sk.sketch_of(a + b)
        merged = sk.merge_docs([x.to_doc(), z.to_doc(), None])
        state = sk.sketch_state(z)
        got[side] = (
            x.to_doc(), y.to_doc(), [x.quantile(q) for q in (0.0, 0.5, 0.9, 0.99, 1.0)],
            y.percentiles(), merged.to_doc(), sk.Sketch.from_doc(x.to_doc()).to_doc(),
            state, sk.sketch_from_state(state).to_doc(),
            sk.merge_state_docs([state, sk.sketch_state(x)]),
        )
    assert got["port"] == got["jax"]


# --------------------------------------------------------------------------
# The round: run_check with --history --analytics on both sides
# --------------------------------------------------------------------------

HOSTS = [f"gke-tpu-v5p-{i}" for i in range(4)]
# Host 0 flaps (its flips at rounds 2, 3 and 4 fire the flip channel at 4);
# hosts 1-3 report one ICI link each whose p50 climbs past half its budget
# from round 2 (the link channel fires at round 4, promoting the slice).
FLAPS = [True, False, True, False, True, True]
LINK_P50 = [30.0, 60.0, 70.0, 80.0, 90.0, 40.0]
STEP = 30.0


class Clock:
    def __init__(self):
        self.t = BASE + 1.0

    def __call__(self):
        return self.t


def write_round_reports(directory, r, written_at):
    directory.mkdir(parents=True, exist_ok=True)
    for i, host in enumerate(HOSTS):
        ok = FLAPS[r] if i == 0 else True
        doc = {"ok": ok, "level": "mesh", "hostname": host, "written_at": written_at,
               "error": None if ok else "matmul numerics failed"}
        if i:
            doc["collective_legs_ok"] = {"links": {f"t{i % 3}/0->1": {
                "p50_us": LINK_P50[r] + i, "verdict": "OK", "budget_us": 100.0}}}
        (directory / f"{host}.json").write_text(json.dumps(doc))


def run_rounds(side, tmp_path, monkeypatch, capsys):
    cli, checker = SIDES[side][:2]
    for cache in (checker._ANALYTICS_CACHE, checker._HISTORY_CACHE,
                  checker._REMEDIATION_CACHE):
        monkeypatch.setitem(cache, "key", None)
    clock = Clock()
    monkeypatch.setattr(time, "time", clock)
    work = tmp_path / side
    nodes = work / "nodes.json"
    work.mkdir()
    nodes.write_text(json.dumps(fx.node_list(fx.tpu_v5p_64_slice() + fx.gpu_pool(2))))
    argv = ["--nodes-json", str(nodes), "--probe-results", str(work / "reports"),
            "--history", str(work / "history.jsonl"), "--analytics", str(work / "analytics"),
            "--cluster-name", "us-a", "--json"]
    rounds = []
    for r in range(len(FLAPS)):
        write_round_reports(work / "reports", r, clock.t)
        result = checker.run_check(cli.parse_args(argv), tracer=None, events=None)
        err = capsys.readouterr().err
        events = [{k: v for k, v in json.loads(line).items() if k not in ("ts", "trace_id")}
                  for line in err.splitlines() if line.startswith("{")]
        rounds.append({"exit_code": result.exit_code,
                       "payload": masked(result.payload),
                       "docs": masked(result.analytics_docs),
                       "events": events})
        clock.t += STEP
    monkeypatch.undo()
    files = {}
    for path in sorted((work / "analytics").glob("*.seg.jsonl")):
        files[path.name] = [masked(json.loads(line)) for line in path.read_text().splitlines()]
    return rounds, files


@pytest.fixture
def both_rounds(tmp_path, monkeypatch, capsys):
    return {side: run_rounds(side, tmp_path, monkeypatch, capsys) for side in SIDES}


def test_round_analytics_block_equals_jax(both_rounds):
    jax_rounds, port_rounds = both_rounds["jax"][0], both_rounds["port"][0]
    assert [r["payload"] for r in port_rounds] == [r["payload"] for r in jax_rounds]
    blocks = [r["payload"]["analytics"] for r in port_rounds]
    # The flip channel fires once, at round 4, for host 0.
    assert [[p.get("node") for p in b["predictions"] if "node" in p] for b in blocks] == \
        [[], [], [], [HOSTS[0]], [], []]
    assert blocks[3]["predictions_total"] == 1 and HOSTS[0] in blocks[3]["suspects"]
    # The link channel fires at round 4 for each drifting link, naming the slice.
    links = [p for p in blocks[3]["predictions"] if "link" in p]
    assert sorted(p["link"] for p in links) and all(
        p["link"].startswith("v5p-pool") and p["nodes"] == sorted(
            n["metadata"]["name"] for n in fx.tpu_v5p_64_slice()) for p in links)
    assert blocks[-1]["sketch_samples"]["link_us"] > 0
    # A round's own duration folds in after its block is written.
    assert blocks[-1]["sketch_samples"]["round_ms"] == len(FLAPS) - 1


def test_round_query_documents_equal_jax(both_rounds):
    jax_rounds, port_rounds = both_rounds["jax"][0], both_rounds["port"][0]
    assert [r["docs"] for r in port_rounds] == [r["docs"] for r in jax_rounds]
    last = port_rounds[-1]["docs"]
    assert "link_us" in last["slo"]["streams"] and "round_ms" in last["slo"]["streams"]
    flaps = {n["node"]: n for n in last["flaps"]["nodes"]}
    assert flaps[HOSTS[0]]["flips_total"] == 4 and flaps[HOSTS[0]]["predicted"]


def test_round_events_and_segments_equal_jax(both_rounds):
    (jax_rounds, jax_files), (port_rounds, port_files) = both_rounds["jax"], both_rounds["port"]
    assert [r["events"] for r in port_rounds] == [r["events"] for r in jax_rounds]
    kinds = [e["event"] for r in port_rounds for e in r["events"]]
    assert kinds.count("analytics-prediction") == 1 and "analytics-link-drift" in kinds
    assert [r["exit_code"] for r in port_rounds] == [r["exit_code"] for r in jax_rounds]
    assert port_files == jax_files and port_files
