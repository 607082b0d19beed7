"""The benchmark's arithmetic on synthetic runs and traces: the end-to-end
metrics, the roofline's operations and bytes, busy and idle time, and the
chain's kernels by their graph launch."""

import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from probebench import roofline  # noqa: E402
from probebench import trace as tr  # noqa: E402
from probebench.core import Run, load_reader  # noqa: E402
from probebench.reference import probes as ref  # noqa: E402

ROUNDS = {"window": "rounds"}
SOAK = {"window": "soak"}


def make_run(traffic, rounds, window_s=0.0, t0_wall=100.0, start_wall=90.0, trace=False,
             kind="NVIDIA H100 80GB HBM3"):
    driven = {"warm": [], "rounds": rounds, "window_s": window_s, "t0_wall": t0_wall}
    return Run({}, traffic, trace, start_wall, driven, kind)


def round_(wall, capture=None, prefix="r"):
    return {"prefix": prefix, "wall_s": wall, "rc": 0, "report": {"ok": True},
            "capture": capture, "arrays": {}}


def test_round_s_is_the_window_less_the_hooks_own_over_its_rounds():
    hook = {"trace_start_cost_s": 0.5, "hook_s": 0.05, "write_s": 0.2}
    rounds = [round_(9.0, hook), round_(11.0, hook), round_(10.5)]
    run = make_run(ROUNDS, rounds, window_s=30.75)
    assert load_reader("round_s.emitter")(run) == pytest.approx((30.75 - 2 * 0.75) / 3)
    assert load_reader("round_s.emitter")(make_run(SOAK, [round_(5.0)])) is None


def test_setup_s_runs_to_the_window_or_the_soak():
    run = make_run(ROUNDS, [round_(1.0)], t0_wall=112.5, start_wall=100.0)
    assert load_reader("setup_s")(run) == pytest.approx(12.5)
    soak = {"soak": {"rounds": 3, "start_s": 1.0, "end_s": 2.0, "start_wall": 109.0,
                     "n": 2048, "iters": 1024}}
    run = make_run(SOAK, [round_(20.0, soak)], t0_wall=100.5, start_wall=100.0)
    assert load_reader("setup_s")(run) == pytest.approx(9.0)


def soak_capture(rounds, chain_runs, n=2048, iters=1024, start_s=2.0, end_s=12.0):
    """A soak capture: ``chain_runs`` runs of the chain and one invariant a round,
    and a compute stage before it (not the soak's)."""
    chain = [{"n": n, "iters": 64, "soak": False, "round": 0}]
    invariant = [{"n": n, "soak": False, "round": 0}]
    for r in range(1, rounds + 1):
        chain += [{"n": n, "iters": iters, "soak": True, "round": r}] * chain_runs
        invariant.append({"n": n, "soak": True, "round": r})
    return {"soak": {"rounds": rounds, "start_s": start_s, "end_s": end_s, "start_wall": 0.0,
                     "n": n, "iters": iters},
            "chain": chain, "invariant": invariant, "outputs": []}


@pytest.mark.parametrize("chain_runs", [1, 2, 3])
def test_soak_tflops_counts_the_products_that_ran_over_the_soak_seconds(chain_runs):
    run = make_run(SOAK, [round_(30.0, soak_capture(100, chain_runs))])
    want = 100 * (chain_runs * 1024 + 1) * 2 * 2048 ** 3 / 10.0 / 1e12
    assert load_reader("soak_tflops")(run) == pytest.approx(want)
    assert load_reader("soak_tflops")(make_run(SOAK, [round_(3.0, {"soak": None})])) is None


def test_outputs_missing_counts_each_soak_round():
    from probebench.judge import missing_outputs

    traffic = {"judged": {"burn_chain": 1, "burn_invariant": 1},
               "soak_judged": {"burn_chain": 1, "burn_invariant": 1}}
    for runs in (1, 2):
        assert missing_outputs([round_(1.0, soak_capture(5, runs))], traffic) == 0
    cap = soak_capture(5, 1)
    cap["chain"] = [c for c in cap["chain"] if c["round"] != 3]
    assert missing_outputs([round_(1.0, cap)], traffic) == 1
    assert missing_outputs([round_(1.0, soak_capture(5, 0))], traffic) == 5
    assert missing_outputs([round_(1.0, None)], traffic) == 2


def report_round(doc, returned=None, new_file=True, beside=(), start_wall=100.0):
    return {"report": doc if returned is None else returned, "start_wall": start_wall,
            "written": {"doc": doc, "new_file": new_file, "beside": list(beside)}}


GOOD = {"ok": True, "level": "compute", "hostname": "h", "elapsed_ms": 9000.5,
        "schema": 1, "written_at": 109.0, "matmul_ok": True, "matmul_tflops": 400.1,
        "memtest_mismatches": {"0x55": 0}, "soak": {"ok": True, "rounds": 3, "seconds": 10.0}}


@pytest.mark.parametrize("rnd,why", [
    (report_round(GOOD), None),
    (report_round(None, returned=GOOD), "no report file"),
    (report_round(dict(GOOD, written_at=108.0), returned=GOOD), "differs"),
    (report_round(GOOD, new_file=False), "not replaced"),
    (report_round(GOOD, beside=["report.json.tmp"]), "left beside"),
    (report_round(GOOD, start_wall=110.0), "precedes the round"),
    (report_round(dict(GOOD, matmul_tflops="fast")), "matmul_tflops"),
    (report_round(dict(GOOD, soak={"rounds": 2.5})), "soak.rounds"),
    (report_round({k: v for k, v in GOOD.items() if k != "level"}), "level"),
])
def test_report_faults_name_each_broken_guarantee(rnd, why):
    from probebench.judge import report_faults

    faults = report_faults([rnd])
    if why is None:
        assert faults == []
    else:
        assert len(faults) == 1 and why in faults[0]


@pytest.mark.parametrize("doc", [
    GOOD, dict(GOOD, matmul_tflops="fast"), dict(GOOD, ok=1), {"ok": True},
    dict(GOOD, memtest_mismatches={"0x55": 1.5}), dict(GOOD, device_kinds=["H100", 3]),
    dict(GOOD, ici_axis_ok={"x": "yes"}), dict(GOOD, ici_axis_ok=None), dict(GOOD, error=None),
    dict(GOOD, collective_legs_ok={"psum_ok": None, "links": {"a": {"p50_us": "1"}}}),
    [1, 2],
])
def test_the_schema_copy_judges_as_the_program_does(doc):
    from probebench.reference import report_schema
    from tpu_node_checker_torch.probe.schema import validate_report

    assert bool(report_schema.violations(doc)) == bool(validate_report(doc))


def test_parent_and_child_startup_split_the_round():
    cap = {"hook_age_s": 0.05, "first_probe_s": 6.95, "exit_s": 8.9, "write_s": 0.02,
           "hook_s": 0.0}
    run = make_run(ROUNDS, [round_(9.5, cap), round_(9.7, cap)], window_s=19.2)
    assert load_reader("child_import_s.emitter")(run) == pytest.approx(7.0)
    assert load_reader("parent_s.emitter")(run) == pytest.approx((0.53 + 0.73) / 2)


def test_chain_product_work_and_least_time():
    flops, nbytes = roofline.chain_product_work(2048)
    assert flops == 2 * 2048 ** 3
    assert nbytes == 2 * 2 * 2048 ** 2 + 4 * 2048 ** 2
    peak = roofline.peaks("NVIDIA H100 80GB HBM3")
    assert roofline.least_seconds(flops, nbytes, peak) == pytest.approx(flops / 989e12)
    # At a small size the bytes bound it.
    f, b = roofline.chain_product_work(64)
    assert roofline.least_seconds(f, b, peak) == pytest.approx(b / 3.35e12)
    assert roofline.peaks("some other card") is None


def kernel(ts, dur, name="k", corr=None):
    return {"ph": "X", "cat": "kernel", "ts": ts, "dur": dur, "name": name,
            "args": {"correlation": corr}}


def test_busy_and_idle_over_overlapping_kernels():
    events = [kernel(0, 10), kernel(5, 10), kernel(30, 5),
              {"ph": "X", "cat": "gpu_memcpy", "ts": 40, "dur": 10, "name": "copy", "args": {}},
              {"ph": "X", "cat": "cpu_op", "ts": 0, "dur": 100, "name": "aten::mm"}]
    assert tr.busy_us(events) == 15 + 5 + 10
    assert tr.busy_us(events, 10, 45) == 5 + 5 + 5
    assert tr.idle_gaps(events, 0, 60) == [(15, 30), (35, 40), (50, 60)]
    assert tr.op_seconds(events) == pytest.approx({"k": 25e-6, "copy": 10e-6})


def annotation(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "ts": ts, "dur": dur,
            "name": f"probebench:{name}"}


def launch(ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "ts": ts, "dur": 1, "name": "cudaGraphLaunch",
            "args": {"correlation": corr}}


def soak_trace():
    """Two soak rounds: a chain graph (2 kernels) launched twice a round, then
    a stream graph launched in the stream's span."""
    ev = []
    for r, t in enumerate((0, 1000)):
        ev.append(annotation("soak_burn_round", t, 600))
        for j, start in enumerate((t + 10, t + 300)):
            corr = 100 * r + j
            ev.append(launch(start, corr))
            ev += [kernel(start + 5, 100, "gemm", corr), kernel(start + 110, 50, "cast", corr)]
        ev.append(annotation("soak_stream", t + 620, 300))
        ev.append(launch(t + 630, 100 * r + 50))
        ev.append(kernel(t + 640, 200, "add", 100 * r + 50))
    return ev


def test_the_chain_is_what_its_graph_launches_and_the_roofline_follows(tmp_path):
    events = soak_trace()
    launches, kernels = tr.launched_by_graphs(events, tr.annotations(events, "soak_burn_round"))
    assert launches == 4 and sum(k["dur"] for k in kernels) == 4 * 150
    import json

    (tmp_path / "r.trace.json").write_text(json.dumps({"traceEvents": events}))
    soak = {"soak": {"rounds": 2, "start_s": 0.0, "end_s": 1.0, "start_wall": 0.0,
                     "n": 2048, "iters": 8}}
    run = make_run(SOAK, [round_(5.0, soak, prefix=str(tmp_path / "r"))], trace=True)
    least = 4 * 8 * 2 * 2048 ** 3 / 989e12
    assert load_reader("burn_chain_roofline")(run) == pytest.approx(100 * least / 600e-6)
    busy, span = run.device_window()
    assert span == pytest.approx(1920e-6) and busy == pytest.approx((4 * 150 + 2 * 200) * 1e-6)
    assert load_reader("device_idle_share.soak")(run) == pytest.approx(
        100 * (1 - 1000 / 1920))
    br = run.breakdown()
    assert dict(br["device_ops"]) == pytest.approx({"gemm": 400e-6, "add": 400e-6, "cast": 200e-6})
    assert {name for name, _ in br["idle_gaps"]} <= {"soak_burn_round", "soak_stream",
                                                     "child, between probes"}


def test_emitter_idle_share_is_over_the_rounds_wall_less_the_hooks_own(tmp_path):
    import json

    rounds = []
    for i in range(2):
        (tmp_path / f"r{i}.trace.json").write_text(json.dumps(
            {"traceEvents": [kernel(0, 100_000), kernel(50_000, 100_000)]}))
        cap = {"trace_start_cost_s": 0.5, "hook_s": 0.1, "write_s": 0.4, "hook_age_s": 0.0,
               "first_probe_s": 1.0, "exit_s": 9.0}
        rounds.append(round_(11.0, cap, prefix=str(tmp_path / f"r{i}")))
    run = make_run(ROUNDS, rounds, window_s=22.0, trace=True)
    assert run.device_window() == pytest.approx((0.3, 20.0))
    assert load_reader("device_idle_share.emitter")(run) == pytest.approx(100 * (1 - 0.3 / 20))
    assert load_reader("device_idle_share.emitter")(make_run(ROUNDS, rounds, trace=False)) is None


def test_probe_card_ms_is_each_rounds_device_busy_time_and_kernel_ms_its_kernels(tmp_path):
    import json

    def fill(ts, dur):
        return {"ph": "X", "cat": "gpu_memset", "ts": ts, "dur": dur, "name": "fill"}

    traces = [[kernel(0, 10_000), kernel(5_000, 10_000), fill(20_000, 2_000)],
              [kernel(0, 20_000), {"ph": "X", "cat": "cpu_op", "ts": 0, "dur": 90_000}]]
    rounds = []
    for i, events in enumerate(traces):
        (tmp_path / f"r{i}.trace.json").write_text(json.dumps({"traceEvents": events}))
        rounds.append(round_(8.0, {}, prefix=str(tmp_path / f"r{i}")))
    run = make_run(ROUNDS, rounds)
    # Busy: the union, 15 + 2 ms and 20 ms; kernels: each one's own time.
    assert load_reader("probe_card_ms")(run) == pytest.approx((17.0 + 20.0) / 2)
    assert load_reader("kernel_ms.emitter")(run) == pytest.approx((20.0 + 20.0) / 2)
    # A round whose trace is absent or holds no device work reads nothing, never 0.
    (tmp_path / "r1.trace.json").write_text(json.dumps({"traceEvents": traces[1][1:]}))
    run = make_run(ROUNDS, rounds)
    assert load_reader("probe_card_ms")(run) is None
    assert load_reader("kernel_ms.emitter")(run) is None
    untraced = make_run(ROUNDS, [round_(8.0, {}, prefix=str(tmp_path / "none"))])
    assert load_reader("probe_card_ms")(untraced) is None
    assert load_reader("probe_card_ms")(make_run(SOAK, rounds)) is None


def test_reference_answers_in_closed_form():
    assert ref.chain_scale(2048) == pytest.approx(2048 ** -0.5, rel=1e-7)
    assert ref.stream_expected(4) == 4.0
    idx = np.array([0, 1, 7], dtype=np.int64)
    assert list(ref.memtest_expected("0x55", idx).view(np.uint32)) == [0x55555555] * 3
    addr = ref.memtest_expected("addr", idx).view(np.uint32)
    assert int(addr[1]) == (2654435761 & 0xFFFFFFFF) ^ 0x9E3779B9
    # int8: roll(a, i) @ b == roll(a @ b, i), summed over the chain.
    m = k = n = 16
    rng = np.random.default_rng(0)
    a = rng.integers(-8, 8, size=(m, k), dtype=np.int8).astype(np.int64)
    b = rng.integers(-8, 8, size=(k, n), dtype=np.int8).astype(np.int64)
    full = sum(np.roll(a, i, axis=0) @ b for i in range(3))
    flat = np.arange(m * n, dtype=np.int64)
    assert np.array_equal(ref.int8_entries(m, k, n, 3, flat), full.reshape(-1))


def test_the_control_rounds_below_the_configured_precision():
    import torch

    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(1))
    err = (ref.fp8_round(x) - x).abs().max() / x.abs().max()
    assert 1e-3 < float(err) < 2 ** -3
    assert ref.burn_chain(64, 4, "cpu")[1] > 0
    base = ref.burn_chain(64, 8, "cpu")
    low = ref.burn_chain(64, 8, "cpu", "fp8")
    assert abs(low[0] - base[0]) / base[1] > 1e-3
