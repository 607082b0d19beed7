"""The one-card workload cell on the CPU, and what it brought to the harness:
a configuration's own ``emit`` arguments, the step's model FLOPs
(``work/burnin.py``) against what PyTorch's flop counter counts, the readers
of the step's card time and its share of the peak over synthetic traces,
and whole one-process runs, sound and with the step's faults planted."""

import dataclasses
import inspect
import json
import os
import shutil
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from probebench import control, core, driver, roofline  # noqa: E402
from probebench.core import Run, load_reader  # noqa: E402
from probebench.work import burnin as work  # noqa: E402

CELL = "emitter-workload-1card"
BENCH = ROOT / "probebench"
LIMITS = json.loads((BENCH / "cells" / f"{CELL}.json").read_text())["limits"]
H100 = "NVIDIA H100 80GB HBM3"


def load(folder: str, name: str) -> dict:
    return json.loads((BENCH / folder / f"{name}.json").read_text())


def recording_emit(calls: list):
    """A stand-in for ``emit_probe_once``, under its signature, recording
    each call as it was made."""
    from tpu_node_checker_torch.emit import emit_probe_once

    def emit(*args, **kwargs):
        calls.append({"args": args, "kwargs": kwargs})
        return 0, {"ok": True}

    emit.__signature__ = inspect.signature(emit_probe_once)
    return emit


ROUNDS = {"warmup_rounds": 1, "warmup_level": "compute", "window": "rounds", "trace": "rounds"}


# -- a configuration's own emit arguments --------------------------------------

def test_an_emit_entry_reaches_every_round_by_name(tmp_path):
    calls = []
    config = {"name": "c", "probe_level": "workload", "perf_floor": 0.4, "soak_s": 0,
              "emit": {"topology": "2x2", "timeout_s": 900}}
    driven = driver.drive(recording_emit(calls), config, ROUNDS, 0.0, False, None, tmp_path)
    assert len(driven["warm"]) == 1 and len(driven["rounds"]) == 1
    assert [c["kwargs"]["level"] for c in calls] == ["compute", "workload"]
    for c in calls:
        assert c["kwargs"]["topology"] == "2x2" and c["kwargs"]["timeout_s"] == 900


@pytest.mark.parametrize("key", ["no_such_argument", *driver.ROUND_ARGS])
def test_an_unknown_or_round_owned_emit_name_ends_the_run_before_any_round(tmp_path, key):
    calls = []
    config = {"name": "c", "probe_level": "compute", "perf_floor": None, "soak_s": 0,
              "emit": {"topology": "2x2", key: 1}}
    with pytest.raises(SystemExit) as exc:
        driver.drive(recording_emit(calls), config, ROUNDS, 0.0, False, None, tmp_path)
    assert repr(key) in str(exc.value.code) and "'c'" in str(exc.value.code)
    assert calls == [] and list(tmp_path.iterdir()) == []


def test_emit_must_be_an_object(tmp_path):
    config = {"name": "c", "probe_level": "compute", "perf_floor": None, "soak_s": 0,
              "emit": ["--topology", "2x2"]}
    with pytest.raises(SystemExit, match="not an object"):
        driver.drive(recording_emit([]), config, ROUNDS, 0.0, False, None, tmp_path)


@pytest.mark.parametrize("cell", ["emitter-compute", "acceptance-soak",
                                  "acceptance-workload-4card"])
@pytest.mark.parametrize("device", [None, "cpu"])
def test_each_existing_configurations_call_keeps_its_arguments(tmp_path, cell, device):
    entry = load("cells", cell)
    config, traffic = load("configs", entry["config"]), load("traffic", entry["traffic"])
    assert "emit" not in config
    calls = []
    driver.drive(recording_emit(calls), config, traffic, 0.0, False, device, tmp_path)
    soak_s = 0.0 if config["soak_s"] == "window" else float(config["soak_s"])
    levels = [traffic.get("warmup_level", config["probe_level"])] * traffic["warmup_rounds"]
    levels.append(config["probe_level"])
    want = [{"args": (str(tmp_path / "report.json"),),
             "kwargs": {"level": level, "soak_s": soak_s, "perf_floor": config["perf_floor"],
                        **({} if device is None else {"device": device})}}
            for level in levels]
    assert calls == want


def test_a_configuration_naming_what_the_program_lacks_exits_in_seconds(tmp_path):
    dst = tmp_path / "checkout"
    dst.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    for name in ("probebench", "tpu_node_checker_torch"):
        shutil.copytree(ROOT / name, dst / name,
                        ignore=shutil.ignore_patterns("__pycache__", "tests", "build"))
    path = dst / "probebench" / "configs" / "acceptance-job-1card.json"
    config = json.loads(path.read_text())
    config["emit"] = {"expert_shards": 8}
    path.write_text(json.dumps(config))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(TMPDIR=str(tmp_path))
    # The look for a card skipped, as on a machine that has one.
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from probebench import core\n"
            "sys.exit(core.main(['--workload', %r, '--seed', '1', '--seconds', '50',"
            " '--trace', '0'], device='cpu'))\n") % (str(dst), CELL)
    start = time.monotonic()
    out = subprocess.run([sys.executable, "-c", code], cwd=dst, capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode != 0 and time.monotonic() - start < 60
    assert "'expert_shards'" in out.stderr and "emit_probe_once" in out.stderr
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
    # No round began: the harness's scratch folder is gone, no report was written.
    assert "Probe report" not in out.stderr
    assert not [p for p in tmp_path.iterdir() if p.name.startswith("probebench-")]


# -- the step's model FLOPs ----------------------------------------------------

@pytest.mark.parametrize("sizes", [
    dict(vocab=64, d_model=32, n_heads=2, d_ff=64, n_layers=2, seq=16, batch=2),
    dict(vocab=96, d_model=48, n_heads=4, d_ff=80, n_layers=3, seq=24, batch=3),
])
def test_step_flops_is_what_the_flop_counter_counts_over_a_step(sizes):
    from torch.utils.flop_counter import FlopCounterMode

    from tpu_node_checker_torch.models.burnin import BurninConfig, make_train_step

    cfg = BurninConfig(**sizes)
    step, init_fn = make_train_step(cfg, device="cpu")
    model, opt = init_fn(0)
    tokens = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq),
                           generator=torch.Generator().manual_seed(1))
    with FlopCounterMode(display=False) as counter:
        step(model, opt, tokens)  # forward, backward and the update
    counted = counter.get_total_flops()
    ours = work.step_flops(dataclasses.asdict(cfg))
    # The counter, like the convention, leaves the elementwise work out, so
    # the products agree to the last one; what both leave out is under
    # the written allowance.
    assert ours == counted
    assert 0 < work.ELEMENTWISE_ALLOWANCE <= 0.05


def test_the_burnin_step_is_three_gflop():
    assert work.step_flops(burnin_cfg()) == pytest.approx(3.0199e9, rel=1e-4)


# -- the readers, over synthetic traces ----------------------------------------

def kernel(ts, dur, name="k", corr=None):
    return {"ph": "X", "cat": "kernel", "ts": ts, "dur": dur, "name": name,
            "args": {"correlation": corr}}


def launch(ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "ts": ts, "dur": 5, "name": "cudaLaunchKernel",
            "args": {"correlation": corr}}


def step_range(ts, dur):
    return {"ph": "X", "cat": "user_annotation", "ts": ts, "dur": dur,
            "name": "probebench:workload_step"}


def burnin_cfg() -> dict:
    from tpu_node_checker_torch.models.burnin import BurninConfig

    return dataclasses.asdict(BurninConfig())


def one_card_round(tmp_path, i, step_us, steps=3, train=True, model="burnin"):
    """A one-card round: the compute probes' 11 ms, then ``steps`` steps,
    each launching two kernels of ``step_us`` / 2 that overlap by a tenth."""
    prefix = str(tmp_path / f"r{i}")
    events = [kernel(0, 11_000)]
    for j in range(steps):
        t = 1_000_000 * (j + 1)
        half = step_us / 2
        events += [step_range(t, 50_000), launch(t + 10, 10 * j), launch(t + 20, 10 * j + 1),
                   kernel(t + 100, half * 1.1, "gemm", 10 * j),
                   kernel(t + 100 + half, half, "gemm", 10 * j + 1)]
    events.append(kernel(9_000_000, 500))  # after the steps: not the step's
    Path(f"{prefix}.trace.json").write_text(json.dumps({"traceEvents": events}))
    cap = {"train": [{"model": model, "cfg": burnin_cfg(), "steps": steps}]} if train else {}
    return {"prefix": prefix, "capture": cap, "arrays": {}, "wall_s": 12.0, "rc": 0,
            "report": {"ok": True}, "ranks": []}


def make_run(rounds, kind=H100):
    driven = {"warm": [], "rounds": rounds, "window_s": 50.0, "t0_wall": 0.0}
    return Run({"chips": 1}, {"window": "rounds"}, True, 0.0, driven, kind)


def test_train_step_card_ms_is_step_card_ms_workloads_reading(tmp_path):
    run = make_run([one_card_round(tmp_path, 0, 2000), one_card_round(tmp_path, 1, 3000)])
    got = load_reader("train_step_card_ms")(run)
    assert got == pytest.approx((2.0 + 3.0) / 2)
    assert got == load_reader("step_card_ms.workload")(run)
    assert load_reader("train_step_card_ms")(
        make_run([one_card_round(tmp_path, 2, 2000, steps=0)])) is None


def test_train_step_mfu_is_the_model_flops_over_the_step_at_the_peak(tmp_path):
    run = make_run([one_card_round(tmp_path, 0, 2000), one_card_round(tmp_path, 1, 3000)])
    flops = work.step_flops(burnin_cfg())
    want = 100 * flops / (2.5e-3 * roofline.PEAKS[H100]["bf16_flops"])
    assert load_reader("train_step_mfu")(run) == pytest.approx(want)
    assert 0.1 < want < 0.15


@pytest.mark.parametrize("why", ["no_work_file", "no_train_record", "no_peak", "two_models",
                                 "two_processes"])
def test_train_step_mfu_reads_nothing_where_it_has_nothing_to_read(tmp_path, why):
    rounds = [one_card_round(tmp_path, 0, 2000), one_card_round(tmp_path, 1, 2000)]
    kind = H100
    if why == "no_work_file":
        rounds = [one_card_round(tmp_path, i, 2000, model="no_such_model") for i in (0, 1)]
    elif why == "no_train_record":
        rounds[1] = one_card_round(tmp_path, 1, 2000, train=False)
    elif why == "no_peak":
        kind = "cpu"
    elif why == "two_models":
        rounds[1] = one_card_round(tmp_path, 1, 2000, model="other")
    else:
        rank = one_card_round(tmp_path, 9, 2000)
        rounds[1]["ranks"] = [dict(rank, rank=1)]
    assert load_reader("train_step_mfu")(make_run(rounds, kind)) is None


# -- whole one-process runs on the CPU ----------------------------------------

IN_THE_WORKLOAD_CHILD = """
    import sys
    if sys.argv[:2] == ["-c", "workload"]:
        from tpu_node_checker_torch.models import burnin as _burnin
"""
FAULTS = {
    # A step that returns its state unchanged: Adam's update skipped.
    "state_unchanged": """
        _burnin._Adam.step = lambda self: None
    """,
    # Half of the batch left out, the mean taken over the rest.
    "half_batch": """
        _loss = _burnin._loss
        _burnin._loss = lambda model, tokens: _loss(model, tokens[: max(1, tokens.shape[0] // 2)])
    """,
    # An answer altered where it is produced: each step's loss off by 2**-7,
    # inside the probe's own verdict (the loss still falls).
    "loss_altered": """
        import functools
        _make = _burnin.make_train_step
        @functools.wraps(_make)
        def _altered(*args, **kwargs):
            step, init_fn = _make(*args, **kwargs)
            return (lambda model, opt, tokens: step(model, opt, tokens) * (1 + 2 ** -7)), init_fn
        _burnin.make_train_step = _altered
    """,
}


@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_the_one_card_workload_cell_in_one_process(capsys, tmp_path, monkeypatch, fault):
    planted = tmp_path / "planted"
    planted.mkdir()
    if fault:
        (planted / "sitecustomize.py").write_text(
            textwrap.dedent(IN_THE_WORKLOAD_CHILD)
            + textwrap.indent(textwrap.dedent(FAULTS[fault]), "    "))
        monkeypatch.setenv("PYTHONPATH", str(planted))
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    rc = core.main(["--workload", CELL, "--seed", str(2 ** 31 + 53), "--seconds", "0.1",
                    "--trace", "0"], device="cpu")
    out, err = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    checks = line["checks"]
    assert list(checks) == list(LIMITS)
    assert line["device"]["count"] == 1 and line["attempted"] >= 1
    # One process trained: its step, gradient and change judged once a round.
    assert checks["outputs_missing"]["value"] == 0
    steps = ("workload_loss_gap", "workload_grad_gap", "workload_update_gap")
    failed = [name for name, c in checks.items() if c["value"] > c["limit"]]
    if fault is None:
        assert line["correct"] is True and not failed
        assert all(0 < checks[k]["value"] for k in steps)
    else:
        assert line["correct"] is False
        assert set(failed) & set(steps)
        assert "FAILED" in err


def test_the_control_fails_the_one_card_cells_step_limits(capsys, tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    assert control.main(["--workload", CELL, "--seconds", "0.1", "--seed", str(2 ** 31 + 59)],
                        device="cpu") == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["program_correct"] is True and got["control_correct"] is False
    # The fp8 reference in the step's place fails the loss's limit by itself.
    assert got["control"]["workload_loss_gap"] > LIMITS["workload_loss_gap"]
    assert got["program"]["workload_loss_gap"] < LIMITS["workload_loss_gap"]
