"""The probe round's spans and counters (``probe/spans.py``), on the CPU.

One compute-level emitter round through the CLI (``--emit-probe F --trace
T --device cpu``) gives the report, with its ``spans`` block, and the
round's Chrome trace: every span and counter the CPU path runs is there,
the parent and the child share one ``trace_id``, the child's spans lie
inside the parent's ``probe.child``, and the parent's spans add up to the
round.  In process: the summary's arithmetic, the null span without a
round, and the bridge into a ``torch.profiler`` trace, on the trace's own
clock.

torch and the port are reached through ``importlib.import_module``:
tests/test_dependency_surface.py rejects any other ``import`` in tests/.
"""

import importlib
import json
import os

import pytest

torch = importlib.import_module("torch")
port_cli = importlib.import_module("tpu_node_checker_torch.cli")
spans = importlib.import_module("tpu_node_checker_torch.probe.spans")

PARENT_SPANS = {"probe.spawn", "probe.child", "probe.child_exit", "emit.parse", "emit.schema"}
CHILD_SPANS = {"child.import_torch", "child.import_port", "child.cuda_init", "child.enumerate",
               "child.dispatch_check", "child.report"}
PROBE_SPANS = {f"probe.{name}" for name in (
    "matmul_burn", "hbm_bandwidth_probe", "pallas_matmul_probe", "int8_matmul_probe",
    "flash_attention_probe", "dma_stream_probe", "hbm_pattern_probe")} | {"hbm.alloc"}
# Spans of work that runs on a card alone: the kernels' build and load, the
# CUDA graphs (the CPU runs the plain versions, eagerly).
CARD_ONLY_PREFIXES = ("child.kernel_build", "kernel.load.", "graph.")
# Spans that close after the report is written: the trace file has them.
AFTER_THE_REPORT = {"emit.write", "emit.round"}


@pytest.fixture(scope="module")
def cpu_round(tmp_path_factory):
    """(report, Chrome trace, exit code) of one compute-level round on the CPU."""
    tmp = tmp_path_factory.mktemp("spans")
    report, trace = tmp / "r.json", tmp / "t.json"
    with pytest.MonkeyPatch.context() as mp:
        for k in [k for k in os.environ if k.startswith("TNC_")]:
            mp.delenv(k)
        mp.setenv("OMP_NUM_THREADS", "2")
        mp.setenv("TNC_SCHEMA_STRICT", "1")
        rc = port_cli.main(["--emit-probe", str(report), "--trace", str(trace),
                            "--probe-level", "compute", "--device", "cpu"])
    return json.loads(report.read_text()), json.loads(trace.read_text()), rc


def _x_events(doc, pid):
    return [e for e in doc["traceEvents"] if e.get("ph") == "X" and e["pid"] == pid
            and e["name"] != "total"]


def test_the_round_is_healthy(cpu_round):
    report, _, rc = cpu_round
    assert rc == 0 and report["ok"] is True, report.get("error")


def test_report_holds_every_span_the_cpu_path_runs(cpu_round):
    ms = cpu_round[0]["spans"]["ms"]
    assert PARENT_SPANS | CHILD_SPANS | PROBE_SPANS <= set(ms)
    assert not set(ms) & AFTER_THE_REPORT
    assert not [n for n in ms if n.startswith(CARD_ONLY_PREFIXES)]
    for name, (n, total, longest) in ms.items():
        assert n >= 1 and 0 <= longest <= total, name
    # The second import_port is the compute stage's ``ops``; each probe once.
    assert ms["child.import_port"][0] == 2
    assert all(ms[name][0] == 1 for name in PROBE_SPANS)


def test_report_holds_every_counter_the_cpu_path_runs(cpu_round):
    counters = cpu_round[0]["spans"]["counters"]
    # The CPU builds no kernel and captures no graph: each reads 0; the
    # caching allocator's counts exist on a card alone.
    assert counters == dict.fromkeys(spans.CHILD_COUNTERS, 0)


def test_report_block_carries_the_trace_id_and_the_child_clock(cpu_round):
    report, trace, _ = cpu_round
    block = report["spans"]
    assert list(block) == ["trace_id", "clock", "ms", "counters"]
    assert block["trace_id"] == trace["otherData"]["trace_id"]
    assert block["clock"] == trace["otherData"]["child_clock"]
    assert set(block["clock"]) == {"unix_ns", "monotonic_ns"}


def test_parent_and_child_share_one_trace_id(cpu_round):
    _, trace, _ = cpu_round
    ids = {e["pid"]: e["args"]["trace_id"] for e in trace["traceEvents"]
           if e.get("ph") == "M" and e["name"] == "trace_id"}
    assert set(ids) == {1, 2} and ids[1] == ids[2] == trace["otherData"]["trace_id"]


def test_child_spans_nest_inside_probe_child(cpu_round):
    _, trace, _ = cpu_round
    (child,) = [e for e in _x_events(trace, 1) if e["name"] == "probe.child"]
    events = _x_events(trace, 2)
    assert CHILD_SPANS | PROBE_SPANS <= {e["name"] for e in events}
    for e in events:
        # Rounded to 0.1 us on each side.
        assert child["ts"] - 0.2 <= e["ts"] and e["ts"] + e["dur"] <= \
            child["ts"] + child["dur"] + 0.2, e


def test_trace_holds_the_spans_after_the_report(cpu_round):
    _, trace, _ = cpu_round
    names = {e["name"] for e in _x_events(trace, 1)}
    assert PARENT_SPANS | AFTER_THE_REPORT <= names


def test_parent_spans_add_up_to_the_round(cpu_round):
    _, trace, _ = cpu_round
    by_name = {e["name"]: e["dur"] for e in _x_events(trace, 1)}
    parts = sum(by_name[n] for n in PARENT_SPANS | {"emit.write"})
    assert 0.98 * by_name["emit.round"] <= parts <= by_name["emit.round"] + 1.0


def test_child_start_up_spans_cover_its_start(cpu_round):
    # From the child's first statement to its first probe.
    _, trace, _ = cpu_round
    events = _x_events(trace, 2)
    (child,) = [e for e in _x_events(trace, 1) if e["name"] == "probe.child"]
    (first,) = [e for e in events if e["name"] == "probe.matmul_burn"]
    covered = sum(e["dur"] for e in events if e["name"] in CHILD_SPANS
                  and e["args"]["depth"] == 0 and e["ts"] < first["ts"])
    assert covered >= 0.95 * (first["ts"] - child["ts"])


def test_summary_counts_totals_and_longest():
    rows = [("a", 0.0, 2.0, 0, 1, None), ("b", 0.0, 1.5, 0, 1, None),
            ("a", 3.0, 5.0, 0, 1, None), ("a", 9.0, 0.25, 1, 1, None)]
    assert spans.summary(rows) == {"a": [3, 7.25, 5.0], "b": [1, 1.5, 1.5]}


def test_without_a_round_a_span_is_null_and_counts_nothing():
    assert spans.current() is None
    with spans.span("probe.x") as s:
        spans.count("graph_replays")
    assert s is spans.NULL


def test_a_round_records_nested_spans_and_counters():
    round_ = spans.Round()
    with spans.active(round_):
        with spans.span("soak.round"):
            with spans.span("soak.burn"):
                spans.count("soak_rounds")
        spans.count("soak_rounds", 2)
    assert spans.current() is None
    assert [(n, d) for n, _, _, d, _, _ in round_.tracer.spans] == \
        [("soak.burn", 1), ("soak.round", 0)]
    assert round_.counters == {"soak_rounds": 3}


def test_a_span_lands_in_a_profiler_trace_on_its_clock(tmp_path):
    profiler = importlib.import_module("torch.profiler")
    round_ = spans.Round()
    with spans.active(round_):
        with spans.span("probe.outside"):
            pass
        with profiler.profile(activities=[profiler.ProfilerActivity.CPU]) as prof:
            with spans.span("probe.inside"):
                torch.ones(4).sum()
    path = tmp_path / "kineto.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    ranges = [e for e in doc["traceEvents"] if e.get("cat") == "user_annotation"
              and str(e.get("name", "")).startswith("tnc:")]
    assert [e["name"] for e in ranges] == ["tnc:probe.inside"]
    (mine,) = [e for e in round_.span_events() if e["name"] == "probe.inside"]
    # The span's start on the Unix clock, through the round's pair of
    # clocks, then on the trace's own (ts x 1000 + baseTimeNanoseconds).
    unix_ns = round_.clock["unix_ns"] + mine["ts"] * 1e3
    ts_us = (unix_ns - doc["baseTimeNanoseconds"]) / 1e3
    assert abs(ts_us - ranges[0]["ts"]) < 1000.0
