"""The readers of the program's own spans and counters (``probebench/spans.py``).

Each reader is fed the rounds of a run on the CPU (the look for a card
skipped) and its value is worked out again from the rounds' reports.  The
CPU builds no kernel, captures no graph and has no caching allocator, so
those three readers read nothing there; they are fed the same rounds with
the card's spans and counters added.  A program without the spans (the
parent commit of the change that added them) gives every reader None.
"""

import copy
import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from probebench import core  # noqa: E402

EMITTER = ["torch_import_s.emitter", "cuda_init_s.emitter", "kernel_build_s.emitter",
           "spawn_s.emitter", "child_exit_s.emitter"]
SOAK = ["stream_share.soak", "graph_launch_ms.soak", "device_allocs.soak"]
EMITTER_SPANS = {"torch_import_s.emitter": "child.import_torch",
                 "cuda_init_s.emitter": "child.cuda_init",
                 "kernel_build_s.emitter": "child.kernel_build",
                 "spawn_s.emitter": "probe.spawn", "child_exit_s.emitter": "probe.child_exit"}


def _run(workload, seconds, tmp_path_factory):
    saved = dict(os.environ)
    try:
        os.environ["TMPDIR"] = str(tmp_path_factory.mktemp(workload))
        out = core.run_cell(workload, 2 ** 31 + 23, seconds, True, device="cpu")
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return out["run"]


@pytest.fixture(scope="module")
def emitter_run(tmp_path_factory):
    return _run("emitter-compute", 0.5, tmp_path_factory)


@pytest.fixture(scope="module")
def soak_run(tmp_path_factory):
    return _run("acceptance-soak", 2.0, tmp_path_factory)


def _ms(r, name):
    return r["report"]["spans"]["ms"][name]


@pytest.mark.parametrize("metric", [m for m in EMITTER if m != "kernel_build_s.emitter"])
def test_an_emitter_reader_is_its_span_a_round(emitter_run, metric):
    name = EMITTER_SPANS[metric]
    values = [_ms(r, name)[1] / 1e3 for r in emitter_run.rounds]
    if metric == "child_exit_s.emitter":
        values = [v - (r["capture"]["write_s"] or 0.0)
                  for v, r in zip(values, emitter_run.rounds)]
    got = core.load_reader(metric)(emitter_run)
    assert got == pytest.approx(sum(values) / len(values))
    assert got >= 0


def test_kernel_build_reads_the_card_span(emitter_run):
    assert core.load_reader("kernel_build_s.emitter")(emitter_run) is None  # no build on the CPU
    run = copy.copy(emitter_run)
    run.rounds = copy.deepcopy(emitter_run.rounds)
    for i, r in enumerate(run.rounds):
        r["report"]["spans"]["ms"]["child.kernel_build"] = [1, 40.0 + i, 40.0 + i]
    n = len(run.rounds)
    assert core.load_reader("kernel_build_s.emitter")(run) == \
        pytest.approx(sum(40.0 + i for i in range(n)) / n / 1e3)


def test_stream_share_is_streams_over_rounds(soak_run):
    r = soak_run.rounds[0]
    cap = r["capture"]
    hook_ms = 1e3 * cap["hook_s"]
    whole = _ms(r, "soak.round")[1] - hook_ms - 1e3 * (cap.get("trace_start_cost_s") or 0.0)
    got = core.load_reader("stream_share.soak")(soak_run)
    assert got == pytest.approx(100.0 * (_ms(r, "soak.stream")[1] - hook_ms) / whole)
    assert 0 < got < 100
    assert _ms(r, "soak.round")[0] == r["report"]["soak"]["rounds"]


def test_graph_launch_and_allocations_read_the_card_spans(soak_run):
    assert core.load_reader("graph_launch_ms.soak")(soak_run) is None
    assert core.load_reader("device_allocs.soak")(soak_run) is None
    run = copy.copy(soak_run)
    run.rounds = copy.deepcopy(soak_run.rounds)
    block = run.rounds[0]["report"]["spans"]
    block["ms"]["graph.launch.burn"] = [40, 190.0, 6.5]
    block["counters"]["num_device_alloc"] = 84
    rounds = block["counters"]["soak_rounds"]
    assert rounds == run.rounds[0]["report"]["soak"]["rounds"]
    assert core.load_reader("graph_launch_ms.soak")(run) == pytest.approx(190.0 / 40)
    assert core.load_reader("device_allocs.soak")(run) == pytest.approx(84 / rounds)


@pytest.mark.parametrize("metric", EMITTER + SOAK)
def test_without_the_programs_spans_a_reader_reads_nothing(emitter_run, soak_run, metric):
    run = copy.copy(soak_run if metric in SOAK else emitter_run)
    run.rounds = copy.deepcopy(run.rounds)
    for r in run.rounds:
        del r["report"]["spans"]
    assert core.load_reader(metric)(run) is None


@pytest.mark.parametrize("metric", EMITTER + SOAK)
def test_a_reader_of_the_other_cell_reads_nothing(emitter_run, soak_run, metric):
    assert core.load_reader(metric)(emitter_run if metric in SOAK else soak_run) is None
